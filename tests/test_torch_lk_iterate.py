"""The port's Newton-loop kernel on pre-extracted patches (``ops/lk_iterate``:
the plain version, which is what the wrapper runs for CPU tensors) against
the JAX package's ``lk_iterate_pallas`` in interpret mode, on the same NumPy
patches (T <= 32, interpret mode is slow).

Tolerances: ``a_final`` 1e-3 px, ``min_eig`` 1e-4 relative, ``err`` 1e-2 —
the JAX kernel lerps columns by a banded product, the port by two taps, and
sums the 441 window terms in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqslam_tpu.ops.lk_pallas import lk_iterate_pallas
from mqslam_tpu_torch.ops import lk_iterate, lk_tile
from test_torch_lk import rot_scale_shift, texture, warp

WIN, PJ, P = 21, 24, 36


def patches(T, seed):
    """Template patches at integer corners of a textured image and search
    patches of a moved copy around the same points, with the anchors the
    LK driver forms: aJ in [1, 2), a0 in [0, hiX + 1]."""
    rng = np.random.RandomState(seed)
    base = texture(rng)
    moved = warp(base, rot_scale_shift(1.5, 1.01, 2.0, -1.5))
    pts = np.stack([rng.uniform(40, 280, T), rng.uniform(40, 200, T)], 1)
    r = WIN // 2
    cJ = np.floor(pts).astype(int) - r - 1            # (x, y)
    cI = np.floor(pts).astype(int) - r - 7
    k = np.arange(PJ)
    pJ = base[(cJ[:, 1, None] + k)[:, :, None], (cJ[:, 0, None] + k)[:, None]]
    k = np.arange(P)
    pI = moved[(cI[:, 1, None] + k)[:, :, None], (cI[:, 0, None] + k)[:, None]]
    aJ = (pts - r - cJ)[:, ::-1]
    a0 = np.clip(pts - r - cI, 0, P - 2 - 2 * r)[:, ::-1]
    f = lambda x: np.ascontiguousarray(x, dtype=np.float32)
    return f(pJ), f(pI), f(aJ), f(a0)


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_pallas_kernel(seed):
    pJ, pI, aJ, a0 = patches(32 - 8 * seed, seed)
    a_j, eig_j, err_j = lk_iterate_pallas(
        jnp.asarray(pJ), jnp.asarray(pI), jnp.asarray(aJ), jnp.asarray(a0),
        win=WIN, iters=30, eps=0.01, interpret=True)
    n0 = lk_iterate.launches
    t = torch.tensor
    a_t, eig_t, err_t = lk_iterate.lk_iterate(t(pJ), t(pI), t(aJ), t(a0),
                                              WIN, 30, 0.01)
    assert lk_iterate.launches == n0     # CPU tensors: the plain version
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), atol=1e-3)
    np.testing.assert_allclose(eig_t.numpy(), np.asarray(eig_j), rtol=1e-4)
    np.testing.assert_allclose(err_t.numpy(), np.asarray(err_j), atol=1e-2)
    # the tracks moved, within the clip
    assert np.abs(a_t.numpy() - a0).max() > 1
    assert (a_t.numpy() >= 0).all() and (a_t.numpy() <= P - 2 - WIN).all()


def test_plain_is_the_tile_level_on_patches():
    """With each track's patches as its own tile the tile level computes the
    same numbers (the kernel is the same per-track device function); the
    template patch widened by repeating its last row and column is what a
    read clamped to it sees."""
    pJ, pI, aJ, a0 = patches(8, 2)
    t = torch.tensor
    got = lk_iterate.lk_iterate_plain(t(pJ), t(pI), t(aJ), t(a0), WIN, 30,
                                      0.01, return_iters=True)
    wide = np.pad(pJ, ((0, 0), (0, P - PJ), (0, P - PJ)), mode="edge")
    z = torch.zeros((8, 2), dtype=torch.int32)
    ref = lk_tile.lk_level_plain(
        t(wide.reshape(-1, P)), t(pI.reshape(-1, P)), z, z, t(aJ), t(a0),
        torch.ones(8, dtype=torch.bool), 8, WIN, 30, 0.01,
        float(P - 2 - WIN), True, True)
    for x, y in zip(got, ref):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert (got[3] > 0).all()


def test_nan_anchors_form_no_address():
    """No valid mask: a NaN anchor still runs, its indices clamped; the
    other tracks are untouched."""
    pJ, pI, aJ, a0 = patches(6, 3)
    t = torch.tensor
    ref = lk_iterate.lk_iterate(t(pJ), t(pI), t(aJ), t(a0), WIN, 30, 0.01)
    aJ2, a02 = aJ.copy(), a0.copy()
    aJ2[1] = np.nan
    a02[4] = np.nan
    out = lk_iterate.lk_iterate(t(pJ), t(pI), t(aJ2), t(a02), WIN, 30, 0.01)
    keep = np.array([0, 2, 3, 5])
    for x, y in zip(out, ref):
        np.testing.assert_array_equal(x.numpy()[keep], y.numpy()[keep])
    assert np.isnan(out[0].numpy()[[1, 4]]).any()


def test_wrapper_refusals():
    pJ, pI, aJ, a0 = (torch.tensor(x) for x in patches(4, 4))
    with pytest.raises(TypeError, match="patchesJ"):
        lk_iterate.lk_iterate(pJ[:, :, :20], pI, aJ, a0)
    with pytest.raises(TypeError, match="patchesI"):
        lk_iterate.lk_iterate(pJ, pI.double(), aJ, a0)
    with pytest.raises(TypeError, match="a0"):
        lk_iterate.lk_iterate(pJ, pI, aJ, a0[:3])
    with pytest.raises(ValueError, match="too small"):
        lk_iterate.lk_iterate(pJ, pI[:, :22, :22].contiguous(), aJ, a0)
    n0 = lk_iterate.launches
    meta = [x.to("meta") for x in (pJ, pI, aJ, a0)]
    with pytest.raises(RuntimeError, match="unsupported device"):
        lk_iterate.lk_iterate(*meta)
    assert lk_iterate.launches == n0


def test_wrapper_refuses_forced_lanes():
    """``_lanes`` (for holding each instantiation on the card) is checked
    before the device is looked at: a shape that is not one of the two, or
    128 threads for the generic window, raises, and nothing launches."""
    pJ, pI, aJ, a0 = (torch.tensor(x) for x in patches(4, 5))
    ref = lk_iterate.lk_iterate(pJ, pI, aJ, a0, WIN, 30, 0.01)
    for lanes in (32, 128):
        got = lk_iterate.lk_iterate(pJ, pI, aJ, a0, WIN, 30, 0.01,
                                    _lanes=lanes)
        for x, y in zip(got, ref):
            assert torch.equal(x, y)
    n0 = lk_iterate.launches
    meta = [x.to("meta") for x in (pJ, pI, aJ, a0)]
    with pytest.raises(ValueError, match="_lanes must be one of"):
        lk_iterate.lk_iterate(*meta, WIN, 30, 0.01, _lanes=64)
    # win = 15 on patches of 30: the generic window, one warp a track
    small = (pJ[:, :18, :18].contiguous(), pI[:, :30, :30].contiguous())
    lk_iterate.lk_iterate(*small, aJ, a0.clamp(max=13.0), 15, 30, 0.01,
                          _lanes=32)
    with pytest.raises(ValueError, match="generic window"):
        lk_iterate.lk_iterate(*(x.to("meta") for x in small),
                              aJ.to("meta"), a0.to("meta"), 15, 30, 0.01,
                              _lanes=128)
    assert lk_iterate.launches == n0


@pytest.mark.parametrize("ptrs,ok", [
    ((0x7f0000000000, 0x7f0000100000), True), ((0x200, 0x1010), True),
    ((0x7f0000000004, 0x7f0000100000), False),
    ((0x7f0000000000, 0x7f0000100008), False)])
def test_alignment_check(ptrs, ok):
    """The compiled-in window's kernel copies patches 16 bytes at a time:
    both patch tensors must start 16-byte aligned, or the wrapper raises
    (no fallback)."""
    if ok:
        lk_iterate.check_alignment(*ptrs)
    else:
        with pytest.raises(ValueError, match="16-byte"):
            lk_iterate.check_alignment(*ptrs)
