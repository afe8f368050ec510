"""The port's patch extractor (``ops/extract``: the plain version, which is
what the wrapper runs for CPU tensors) against the JAX package's
``extract_patches_dma`` in interpret mode, on the same NumPy inputs.  It is
an exact copy: results must be EQUAL, patches, aligned rows and columns."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqslam_tpu.ops import extract_pallas as jep, lk as jlk
from mqslam_tpu_torch.ops import extract, lk as tlk


def image(H, W, seed=0):
    return (np.random.RandomState(seed).rand(H, W) * 255).astype(np.float32)


def corners(H, W, P, T=100, seed=1):
    """Random corners a few pixels beyond every side, plus the extremes."""
    rng = np.random.RandomState(seed)
    c = np.stack([rng.randint(-4, H - P + 4, T),
                  rng.randint(-4, W - P + 4, T)], 1)
    far = [[-10 ** 6, -10 ** 6], [10 ** 6, 10 ** 6], [-3, W + 50],
           [H + 50, -3], [np.iinfo(np.int32).min, np.iinfo(np.int32).max],
           [H - P, W - P], [0, 0]]
    return np.concatenate([c, far]).astype(np.int32)


# tile multiples, and dims that are not (the clamp caps differ there); the
# main window's sides (24, 36: the vec4 path on the card) and win = 15's
# (18, 30) and 38 (the element path)
@pytest.mark.parametrize("H,W", [(512, 768), (517, 781), (48, 256)])
@pytest.mark.parametrize("P", [18, 24, 30, 36, 38])
def test_matches_pallas_kernel(H, W, P):
    img = image(H, W)
    c = corners(H, W, P)
    p_j, y0_j, cx_j = jep.extract_patches_dma(jnp.asarray(img),
                                              jnp.asarray(c), P,
                                              interpret=True)
    n0 = extract.launches
    p_t, y0_t, cx_t = extract.extract_patches_dma(torch.tensor(img),
                                                  torch.tensor(c), P)
    assert extract.launches == n0      # CPU tensors: the plain version
    assert p_t.shape == (len(c), extract.ROWS_CAP, P)
    assert y0_t.dtype == cx_t.dtype == torch.int32
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))
    np.testing.assert_array_equal(y0_t.numpy(), np.asarray(y0_j))
    np.testing.assert_array_equal(cx_t.numpy(), np.asarray(cx_j))
    assert (y0_t.numpy() % 8 == 0).all()


@pytest.mark.parametrize("H,W,P", [(512, 768, 38), (517, 781, 24),
                                   (61, 300, 36)])
def test_clamped_corners(H, W, P):
    c = corners(H, W, P)
    ref = jep._clamped_corners(jnp.asarray(c[:, 0]), jnp.asarray(c[:, 1]),
                               H, W, P)
    got = extract._clamped_corners(torch.tensor(c[:, 0]),
                                   torch.tensor(c[:, 1]), H, W, P)
    for x, y in zip(got, ref):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


@pytest.mark.parametrize("P", [24, 36])
def test_extract_patches_square(P):
    """The square extraction of the patch path (no kernel: one gather)."""
    img = image(157, 203, seed=3)
    c = corners(157, 203, P, seed=4)
    ref = jlk._extract_patches(jnp.asarray(img), jnp.asarray(c), P)
    got = tlk._extract_patches(torch.tensor(img), torch.tensor(c), P)
    for x, y in zip(got, ref):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


@pytest.mark.parametrize("shape", [(276, 356), (96, 116), (48, 256)])
def test_pad_tiles(shape):
    img = image(*shape, seed=5)
    ref = np.asarray(jlk._pad_tiles(jnp.asarray(img)))
    got = tlk._pad_tiles(torch.tensor(img)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_supported_gate():
    for H, W in ((512, 768), (40, 768), (512, 200), (48, 256)):
        assert extract.dma_extract_supported(H, W) == \
            jep.dma_extract_supported(H, W)


def test_wrapper_refusals():
    img = torch.tensor(image(64, 256))
    c = torch.tensor(corners(64, 256, 24))
    with pytest.raises(TypeError, match="float32"):
        extract.extract_patches_dma(img.double(), c, 24)
    with pytest.raises(TypeError, match="int32"):
        extract.extract_patches_dma(img, c.long(), 24)
    with pytest.raises(ValueError, match="minimum"):
        extract.extract_patches_dma(img[:40], c, 24)
    with pytest.raises(ValueError, match="minimum"):
        extract.extract_patches_dma(img[:, :200].contiguous(), c, 24)
    with pytest.raises(ValueError, match="outside"):
        extract.extract_patches_dma(img, c, 49)
    # any device but the CPU is the kernel's or an error
    n0 = extract.launches
    with pytest.raises(RuntimeError, match="unsupported device"):
        extract.extract_patches_dma(img.to("meta"), c.to("meta"), 24)
    assert extract.launches == n0


@pytest.mark.parametrize("P,want", [(18, "element"), (24, "vec4"),
                                    (30, "element"), (36, "vec4"),
                                    (38, "element")])
def test_kernel_path(P, want):
    """The path is a function of P alone: the four-float path needs whole
    16-byte row pieces (P % 4 == 0)."""
    assert extract.kernel_path(P) == want
    extract.check_path(want, P)


@pytest.mark.parametrize("path,P,match", [
    ("dma", 24, "_path must be one of"), ("TMA", 24, "_path must be one of"),
    (0, 24, "_path must be one of"), ("tma", 36, "_path must be one of"),
    ("vec4", 30, "P % 4 == 0"), ("vec4", 18, "P % 4 == 0")])
def test_forced_path_refusals(path, P, match):
    img = torch.tensor(image(64, 256))
    c = torch.tensor(corners(64, 256, P))
    with pytest.raises(ValueError, match=match):
        extract.check_path(path, P)
    # checked before the device is looked at: no launch is counted
    n0 = extract.launches
    with pytest.raises(ValueError, match=match):
        extract.extract_patches_dma(img.to("meta"), c.to("meta"), P,
                                    _path=path)
    assert extract.launches == n0


@pytest.mark.parametrize("path,P", [("vec4", 24), ("element", 24),
                                    ("vec4", 36), ("element", 36),
                                    ("element", 30)])
def test_forced_path_on_cpu_is_the_plain_version(path, P):
    img = torch.tensor(image(96, 300, seed=6))
    c = torch.tensor(corners(96, 300, P, seed=7))
    n0 = extract.launches
    got = extract.extract_patches_dma(img, c, P, _path=path)
    assert extract.launches == n0
    for x, y in zip(got, extract.extract_patches_plain(img, c, P)):
        assert torch.equal(x, y)
