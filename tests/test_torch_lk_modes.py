"""The port's explicit LK modes, ``lk_track(impl="xla")`` and
``(impl="pallas")``, against the JAX package's same impl on the CPU, on the
same NumPy inputs.  The JAX Pallas kernels (the Newton loop of ``"pallas"``,
the extractor of ``dma_extract=True``) run in interpret mode, as the JAX
package's own tests run them; on the port's side the wrappers take their
plain versions for CPU tensors.

Limits: status equal, flow 1e-3 px, ``err`` 1e-2 — the same products and
sums in another order.  The cases are those of the JAX package's
``tests/test_frontend_ops.py::TestLKPallas`` (a rotated, scaled, shifted
pair; a two-tile atlas with one shift per agent), its
``tests/test_extract_pallas.py`` (``dma_extract=True``), and a T = 1024 call
whose Newton head leaves more than 256 tracks unconverged (the tail
compaction and its tie order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqslam_tpu.ops import lk as jlk
from mqslam_tpu_torch.ops import extract, lk as tlk, lk_fused, lk_iterate, \
    lk_tile
from test_torch_lk import grid, rot_scale_shift, texture, warp

PAD = tlk.lk_pad()


@pytest.fixture(scope="module")
def pair():
    rng = np.random.RandomState(4242)
    base = texture(rng)
    moved = warp(base, rot_scale_shift(1.5, 1.01, 2.0, -1.5))
    return base, moved


def tracks():
    """A grid inside the image (off the pixel grid: the row gradients of a
    template window's last row read below the square patch), tracks outside
    it, a dead NaN slot."""
    return np.concatenate([grid(80, 240, 80, 160, 40) + 0.37,
                           [[400.0, 100.0], [-5.0, 3.0], [4.0, 4.0],
                            [np.nan, np.nan]]]).astype(np.float32)


def assert_same(out, ref, min_ok):
    (a, s, e), (a_j, s_j, e_j) = out, ref
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_j))
    ok = s.numpy()
    assert ok.sum() >= min_ok
    np.testing.assert_allclose(a.numpy()[ok], np.asarray(a_j)[ok],
                               atol=1e-3)
    np.testing.assert_allclose(e.numpy()[ok], np.asarray(e_j)[ok],
                               atol=1e-2)
    assert np.isinf(e.numpy()[~ok]).all()


def counts():
    return (extract.launches, lk_iterate.launches, lk_fused.launches,
            lk_tile.launches)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_lk_track_matches_jax(pair, impl):
    base, moved = pair
    pts = tracks()
    ref = jlk.lk_track(jnp.asarray(base), jnp.asarray(moved),
                       jnp.asarray(pts), impl=impl, interpret=True)
    before = counts()
    out = tlk.lk_track(torch.tensor(base), torch.tensor(moved),
                       torch.tensor(pts), impl=impl)
    assert counts() == before          # CPU tensors: plain versions only
    assert_same(out, ref, 8)
    ok = out[1].numpy()
    assert not ok[-4:].any() and torch.isnan(out[0][-1]).all()
    flow = (out[0].numpy() - pts)[ok]
    assert np.abs(flow).max() > 1


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_atlas_two_tiles_matches_jax(pair, impl):
    """Each agent's patches come from its own tile: against the JAX
    package's same impl with the same agent ids, and each agent recovers its
    own shift; agent-contiguous ids give the same numbers as declared
    contiguity."""
    base, _ = pair
    shifts = [(2.0, -1.5), (-3.0, 1.0)]
    moved = [warp(base, np.array([[1, 0, -dx], [0, 1, -dy]], np.float64))
             for dx, dy in shifts]
    pts = grid(80, 240, 80, 160, 40)
    T = len(pts)
    pts2 = np.concatenate([pts, pts])
    agents = np.repeat(np.arange(2, dtype=np.int32), T)

    jpyr = lambda im: jlk.build_pyramid(jnp.asarray(im), 3, pad=PAD)
    jatlas = lambda ims: tuple(jnp.concatenate(l, axis=0)
                               for l in zip(*[jpyr(im) for im in ims]))
    ref = jlk.lk_track_pyr(
        jatlas([base, base]), jatlas(moved), jnp.asarray(pts2), win=21,
        prepad=True, atlas_agents=jnp.asarray(agents), atlas_tiles=2,
        impl=impl, interpret=True)

    tatlas = lambda ims: [l.reshape(-1, l.shape[-1]) for l in
                          tlk.build_pyramid(torch.tensor(np.stack(ims)), 3,
                                            pad=PAD)]
    prev, nxt = tatlas([base, base]), tatlas(moved)
    out = tlk.lk_track_pyr(prev, nxt, torch.tensor(pts2), win=21,
                           prepad=True, atlas_agents=torch.tensor(agents),
                           atlas_tiles=2, impl=impl)
    assert_same(out, ref, 2 * T)
    for ag, (dx, dy) in enumerate(shifts):
        flow = (out[0].numpy() - pts2)[agents == ag]
        np.testing.assert_allclose(flow.mean(0), [dx, dy], atol=0.2)
    out2 = tlk.lk_track_pyr(prev, nxt, torch.tensor(pts2), win=21,
                            prepad=True, atlas_tiles=2,
                            atlas_contiguous=True, impl=impl)
    for x, y in zip(out2, out):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_pallas_matches_xla_without_dma(pair):
    """The JAX package's own bound between the two modes
    (``test_frontend_ops.py``): status equal, 2e-3 px."""
    base, moved = pair
    args = (torch.tensor(base), torch.tensor(moved), torch.tensor(tracks()))
    a_x, s_x, _ = tlk.lk_track(*args, impl="xla", dma_extract=False)
    a_p, s_p, _ = tlk.lk_track(*args, impl="pallas")
    np.testing.assert_array_equal(s_x.numpy(), s_p.numpy())
    ok = s_x.numpy()
    np.testing.assert_allclose(a_p.numpy()[ok], a_x.numpy()[ok], atol=2e-3)


def test_dma_extract_matches_jax(pair, monkeypatch):
    """``dma_extract=True`` (the card's default for ``impl="xla"``) against
    the JAX package's, interpret mode: six extractions per call (template
    and search patch of each level, 48 rows from the aligned row), aligned
    row bases and logical clip bases; and within the JAX package's own
    bounds of the square extraction (>= 90 % valid in both, max 0.05 px,
    median 0.01 px; in exact float32 the two agree to roundoff, since the
    window never reaches the square template patch's zero-padded gradient
    border)."""
    base, moved = pair
    pts = tracks()
    jp = lambda im: tuple(jlk.build_pyramid(jnp.asarray(im), 3, pad=PAD))
    ref = jlk.lk_track_pyr(jp(base), jp(moved), jnp.asarray(pts),
                           prepad=True, impl="xla", dma_extract=True,
                           interpret=True)
    tp = lambda im: tlk.build_pyramid(torch.tensor(im), 3, pad=PAD)
    shapes = []
    real = extract.extract_patches_dma

    def recorder(img, corner_yx, P):
        out = real(img, corner_yx, P)
        shapes.append((tuple(img.shape), tuple(out[0].shape)))
        return out

    monkeypatch.setattr(extract, "extract_patches_dma", recorder)
    n0 = extract.launches
    out = tlk.lk_track_pyr(tp(base), tp(moved), torch.tensor(pts),
                           prepad=True, impl="xla", dma_extract=True)
    assert extract.launches == n0
    T = len(pts)
    # levels padded to 8 rows / >= 256 columns: 276x356 -> 280x384, ...
    assert sorted(shapes) == sorted(
        [((280, 384), (T, 48, 24)), ((280, 384), (T, 48, 36)),
         ((160, 256), (T, 48, 24)), ((160, 256), (T, 48, 36)),
         ((96, 256), (T, 48, 24)), ((96, 256), (T, 48, 36))])
    assert_same(out, ref, 8)
    sq = tlk.lk_track_pyr(tp(base), tp(moved), torch.tensor(pts),
                          prepad=True, impl="xla", dma_extract=False)
    both = out[1].numpy() & sq[1].numpy()
    assert both.sum() >= 0.9 * out[1].numpy().sum()
    dq = np.abs(out[0].numpy() - sq[0].numpy())[both]
    assert dq.max() < 0.05 and np.median(dq) < 0.01


def test_tail_compaction_matches_jax(monkeypatch):
    """T = 1024 on a strongly rotated and scaled pair: the 8-iteration head
    leaves more than 256 tracks unconverged on a level, so the tail finishes
    the 256 of lowest index (``lax.top_k``'s tie order) and the rest keep
    their head-phase flow; status equal and flow 1e-3 px against the JAX
    package."""
    rng = np.random.RandomState(4242)
    base = texture(rng)
    moved = warp(base, rot_scale_shift(8.0, 1.08, 2.0, -1.5))
    xs, ys = np.linspace(30, 290, 32), np.linspace(30, 210, 32)
    pts = (np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2) + 0.3
           ).astype(np.float32)
    ref = jlk.lk_track(jnp.asarray(base), jnp.asarray(moved),
                       jnp.asarray(pts), impl="xla", eps=1e-3)
    heads = []
    real = tlk._newton

    def recorder(*args):
        q, done = real(*args)
        if args[12] == 8:                           # a head phase
            heads.append(int((~done).sum()))
        return q, done

    monkeypatch.setattr(tlk, "_newton", recorder)
    out = tlk.lk_track(torch.tensor(base), torch.tensor(moved),
                       torch.tensor(pts), impl="xla", eps=1e-3)
    assert len(heads) == 3 and max(heads) > 256
    assert_same(out, ref, 900)


def test_refusals(pair):
    base, moved = pair
    args = (torch.tensor(base), torch.tensor(moved), torch.tensor(tracks()))
    with pytest.raises(ValueError, match="dma_extract"):
        tlk.lk_track(*args, impl="pallas", dma_extract=True)
    with pytest.raises(ValueError, match="dma_extract"):
        tlk.lk_track(*args, impl="fused", dma_extract=True)
    with pytest.raises(ValueError, match="float32"):
        tlk.lk_track(*args, impl="xla", store_dtype="bfloat16")
    # a level below the extractor's 48 rows even after the tile padding:
    # 12 rows -> level 2 is 3 + 36 rows, padded to 40
    small = torch.tensor(base[:12, :300].copy())
    pt = torch.tensor([[150.0, 6.0]])
    with pytest.raises(ValueError, match="minimum"):
        tlk.lk_track(small, small, pt, impl="xla", dma_extract=True)
    # the default is the square extraction on the CPU: no refusal there
    out = tlk.lk_track(small, small, pt, impl="xla")
    assert out[0].shape == (1, 2)
