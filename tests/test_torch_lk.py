"""The port's LK (pyramid, bilinear_sample, the plain level, lk_track_pyr)
against the JAX package on the CPU.  The JAX tiled kernel runs in interpret
mode, as the JAX package's own tests run it; the moved images are made with
NumPy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqslam_tpu.ops import lk as jlk, lk_tile_pallas as jtp
from mqslam_tpu_torch.ops import lk as tlk, lk_tile


def texture(rng, h=240, w=320):
    """Smooth random texture with gradient structure everywhere."""
    img = rng.rand(h // 8 + 2, w // 8 + 2).astype(np.float32) * 255
    img = np.kron(img, np.ones((8, 8), np.float32))[:h + 8, :w + 8]
    k = np.array([1, 4, 6, 4, 1], np.float32) / 16
    for _ in range(3):
        img = sum(k[i] * np.roll(img, i - 2, 0) for i in range(5))
        img = sum(k[i] * np.roll(img, i - 2, 1) for i in range(5))
    return np.ascontiguousarray(img[4:h + 4, 4:w + 4])


def warp(img, M):
    """out(x, y) = img(M @ [x, y, 1]) by bilinear sampling, edge-clamped
    (NumPy stand-in for cv2.warpAffine with an inverse map)."""
    h, w = img.shape
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float64),
                         np.arange(h, dtype=np.float64))
    sx = np.clip(M[0, 0] * xs + M[0, 1] * ys + M[0, 2], 0, w - 1.001)
    sy = np.clip(M[1, 0] * xs + M[1, 1] * ys + M[1, 2], 0, h - 1.001)
    x0, y0 = np.floor(sx).astype(int), np.floor(sy).astype(int)
    fx, fy = sx - x0, sy - y0
    out = ((1 - fy) * ((1 - fx) * img[y0, x0] + fx * img[y0, x0 + 1])
           + fy * ((1 - fx) * img[y0 + 1, x0] + fx * img[y0 + 1, x0 + 1]))
    return out.astype(np.float32)


def rot_scale_shift(deg, scale, dx, dy, c=(160, 120)):
    a = np.deg2rad(deg)
    ca, sa = np.cos(a) / scale, np.sin(a) / scale
    M = np.array([[ca, sa, 0], [-sa, ca, 0]], np.float64)
    M[:, 2] = np.array(c) - M[:, :2] @ np.array(c) - [dx, dy]
    return M


@pytest.fixture(scope="module")
def pair():
    rng = np.random.RandomState(4242)
    base = texture(rng)
    moved = warp(base, rot_scale_shift(1.5, 1.01, 2.0, -1.5))
    return base, moved


def grid(x0, x1, y0, y1, step):
    return np.stack(np.meshgrid(np.arange(x0, x1, step),
                                np.arange(y0, y1, step)), -1
                    ).reshape(-1, 2).astype(np.float32)


def test_lk_pad():
    for win, margin in ((21, 7), (15, 5), (9, 3)):
        assert tlk.lk_pad(win, margin) == jlk.lk_pad(win, margin)


@pytest.mark.parametrize("shape", [(240, 320), (61, 83)])
def test_pyramid(shape):
    """atol 1e-4 on a 0..255 scale: the same five-tap sums, term order
    kept."""
    img = (np.random.RandomState(1).rand(*shape) * 255).astype(np.float32)
    for pad in (0, 18):
        pj = jlk.build_pyramid(jnp.asarray(img), 3, pad=pad)
        pt = tlk.build_pyramid(torch.tensor(img), 3, pad=pad)
        for a, b in zip(pj, pt):
            assert a.shape == tuple(b.shape)
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4)
    # batched build == per-image build
    imgs = np.stack([img, img[::-1].copy()])
    pb = tlk.build_pyramid(torch.tensor(imgs), 3, pad=18)
    for a in range(2):
        pa = tlk.build_pyramid(torch.tensor(imgs[a]), 3, pad=18)
        for x, y in zip(pb, pa):
            np.testing.assert_array_equal(x[a].numpy(), y.numpy())


def test_bilinear_sample(pair):
    base, _ = pair
    rng = np.random.RandomState(2)
    xy = (rng.rand(200, 2) * [340, 260] - 10).astype(np.float32)
    ref = jlk.bilinear_sample(jnp.asarray(base), jnp.asarray(xy))
    got = tlk.bilinear_sample(torch.tensor(base), torch.tensor(xy))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)
    both = tlk.bilinear_sample(torch.tensor(np.stack([base, base * 0.5])),
                               torch.tensor(np.stack([xy, xy])))
    np.testing.assert_allclose(both[1].numpy(), 0.5 * np.asarray(ref),
                               atol=1e-4)


def _tiled_level_inputs(base, moved, pts, valid, win=21, margin=7):
    """Level-0 inputs as both tiled level loops form them (no clamp binds for
    these in-image points), in the JAX layout and in the port's."""
    r, pad = win // 2, win // 2 + margin + 1
    P = win + 2 * margin + 1
    J = np.pad(base, pad, mode="edge")
    I = np.pad(moved, pad, mode="edge")
    p = pts + pad
    cyJ = np.floor(p[:, 1]).astype(np.int32) - r - 1
    cxJ = np.floor(p[:, 0]).astype(np.int32) - r - 1
    aJ = np.stack([p[:, 1] - r - cyJ, p[:, 0] - r - cxJ], 1).astype(np.float32)
    cyI = np.floor(p[:, 1]).astype(np.int32) - r - margin
    cxI = np.floor(p[:, 0]).astype(np.int32) - r - margin
    a0 = np.stack([p[:, 1] - r - cyI, p[:, 0] - r - cxI], 1).astype(np.float32)
    return dict(J=J, I=I, cJ=np.stack([cyJ, cxJ], 1), cI=np.stack([cyI, cxI], 1),
                aJ=aJ, a0=a0, valid=valid, win=win, hiX=float(P - 2 - win))


@pytest.mark.parametrize("want_err", [True, False])
def test_level_plain_matches_pallas_kernel(pair, want_err):
    """lk_level_plain against lk_level_tiled (interpret mode) on one level:
    the same per-track function behind two layouts.  a_final atol 1e-3 px,
    min_eig rel 1e-4, err atol 1e-2 (441-term sums in another order)."""
    base, moved = pair
    pts = grid(60, 260, 60, 180, 50) + 0.37
    valid = np.ones(len(pts), bool)
    valid[3] = False
    d = _tiled_level_inputs(base, moved, pts, valid)
    tJ, _ = jtp.tile_layout(jnp.asarray(d["J"]), 1)
    tI, _ = jtp.tile_layout(jnp.asarray(d["I"]), 1)
    trip = lambda c: jnp.asarray(np.stack(
        [c[:, 1] // 128, c[:, 0], c[:, 1] % 128], 1).astype(np.int32))
    a_j, eig_j, err_j = jtp.lk_level_tiled(
        tJ, tI, trip(d["cJ"]), trip(d["cI"]), jnp.asarray(d["aJ"]),
        jnp.asarray(d["a0"]), jnp.asarray(valid), 1, d["win"], 30, 0.01,
        d["hiX"], interpret=True, want_err=want_err)
    n0 = lk_tile.launches
    a_t, eig_t, err_t = lk_tile.lk_level(
        torch.tensor(d["J"]), torch.tensor(d["I"]), torch.tensor(d["cJ"]),
        torch.tensor(d["cI"]), torch.tensor(d["aJ"]), torch.tensor(d["a0"]),
        torch.tensor(valid), 1, d["win"], 30, 0.01, d["hiX"],
        want_err=want_err)
    assert lk_tile.launches == n0      # CPU tensors: the plain version
    np.testing.assert_allclose(a_t.numpy()[valid], np.asarray(a_j)[valid],
                               atol=1e-3)
    np.testing.assert_allclose(eig_t.numpy()[valid],
                               np.asarray(eig_j)[valid], rtol=1e-4)
    np.testing.assert_allclose(err_t.numpy()[valid],
                               np.asarray(err_j)[valid], atol=1e-2)
    if not want_err:
        assert (err_t == 0).all()
    # the skipped track returns its a0, and zeros
    np.testing.assert_array_equal(a_t.numpy()[3], d["a0"][3])
    assert eig_t[3] == 0 and err_t[3] == 0
    # the flow was found: (2.0, -1.5) plus a small rotation term
    flow = (a_t.numpy() - d["a0"])[valid]
    assert np.abs(flow[:, 1] - 2.0).max() < 4 and np.abs(flow).max() > 1


def test_level_plain_ignores_nan_in_skipped_tracks(pair):
    base, moved = pair
    pts = grid(60, 260, 60, 180, 50)
    valid = np.ones(len(pts), bool)
    d = _tiled_level_inputs(base, moved, pts, valid)
    args = lambda dd, v: (torch.tensor(dd["J"]), torch.tensor(dd["I"]),
                          torch.tensor(dd["cJ"]), torch.tensor(dd["cI"]),
                          torch.tensor(dd["aJ"]), torch.tensor(dd["a0"]),
                          torch.tensor(v), 1, 21, 30, 0.01, dd["hiX"])
    ref = lk_tile.lk_level_plain(*args(d, valid))
    bad = dict(d)
    valid2 = valid.copy()
    valid2[[1, 4]] = False
    for k in ("aJ", "a0"):
        bad[k] = d[k].copy()
        bad[k][[1, 4]] = np.nan
    bad["cJ"] = d["cJ"].copy()
    bad["cJ"][[1, 4]] = np.iinfo(np.int32).min
    out = lk_tile.lk_level_plain(*args(bad, valid2), return_iters=True)
    keep = valid2
    for x, y in zip(out[:3], ref):
        np.testing.assert_array_equal(x.numpy()[keep], y.numpy()[keep])
    assert np.isnan(out[0].numpy()[[1, 4]]).all()
    assert (out[3].numpy()[~keep] == 0).all() and (out[3].numpy()[keep] > 0).all()


def test_level_wrapper_rejects_bad_inputs(pair):
    base, moved = pair
    d = _tiled_level_inputs(base, moved, grid(60, 260, 60, 180, 50),
                            np.ones(12, bool))
    J, I = torch.tensor(d["J"]), torch.tensor(d["I"])
    ok = [torch.tensor(d[k]) for k in ("cJ", "cI", "aJ", "a0", "valid")]
    with pytest.raises(TypeError):
        lk_tile.lk_level(J.double(), I, *ok, 1, 21, 30, 0.01, 13.0)
    with pytest.raises(TypeError):
        lk_tile.lk_level(J, I, ok[0].long(), *ok[1:], 1, 21, 30, 0.01, 13.0)
    with pytest.raises(ValueError):
        lk_tile.lk_level(J, I, *ok, 5, 21, 30, 0.01, 13.0)


def test_lk_track_matches_tiled_and_xla(pair):
    """The port's tile-kernel LK against JAX impl="tiled" (interpret): status equal,
    flow atol 1e-3 px, err atol 1e-2; against impl="xla": status equal, flow
    atol 2e-3 px (its window cap is one pixel looser; the JAX package's own
    test holds its kernels to the same bound)."""
    base, moved = pair
    pts = np.concatenate([grid(80, 240, 80, 160, 60),
                          [[400.0, 100.0], [-5.0, 3.0], [4.0, 4.0]]]
                         ).astype(np.float32)
    args = (jnp.asarray(base), jnp.asarray(moved), jnp.asarray(pts))
    a_t, s_t, e_t = jlk.lk_track(*args, impl="tiled", interpret=True)
    a_x, s_x, e_x = jlk.lk_track(*args, impl="xla")
    a, s, e = tlk.lk_track(torch.tensor(base), torch.tensor(moved),
                           torch.tensor(pts), impl="tiled")
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_t))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_x))
    ok = s.numpy()
    assert ok.sum() >= 6 and not ok[-3] and not ok[-2]
    np.testing.assert_allclose(a.numpy()[ok], np.asarray(a_t)[ok], atol=1e-3)
    np.testing.assert_allclose(e.numpy()[ok], np.asarray(e_t)[ok], atol=1e-2)
    np.testing.assert_allclose(a.numpy()[ok], np.asarray(a_x)[ok], atol=2e-3)
    assert np.isinf(e.numpy()[~ok]).all()


def test_lk_nan_points_are_invalid_and_stay_nan(pair):
    base, moved = pair
    pts = np.concatenate([grid(80, 240, 80, 160, 60),
                          [[np.nan, np.nan]]]).astype(np.float32)
    a, s, e = tlk.lk_track(torch.tensor(base), torch.tensor(moved),
                           torch.tensor(pts))
    assert s[:-1].all() and not s[-1]
    assert torch.isnan(a[-1]).all() and torch.isinf(e[-1])
    assert torch.isfinite(a[:-1]).all()


def test_lk_atlas_two_agents(pair):
    """Two agents, two shifts, one call (the construction of the JAX
    package's atlas test): against impl="tiled" in interpret mode status
    equal and flow atol 1e-3 px; each agent recovers its own shift."""
    base, _ = pair
    shifts = [(2.0, -1.5), (-3.0, 1.0)]
    moved = [warp(base, np.array([[1, 0, -dx], [0, 1, -dy]], np.float64))
             for dx, dy in shifts]
    pts = grid(80, 240, 80, 160, 40)
    T = len(pts)
    pad = tlk.lk_pad()
    pts2 = np.concatenate([pts, pts])
    agents = np.repeat(np.arange(2, dtype=np.int32), T)

    jpyr = lambda im: jlk.build_pyramid(jnp.asarray(im), 3, pad=pad)
    jatlas = lambda ims: tuple(jnp.concatenate(l, axis=0)
                               for l in zip(*[jpyr(im) for im in ims]))
    a_j, s_j, e_j = jlk.lk_track_pyr(
        jatlas([base, base]), jatlas(moved), jnp.asarray(pts2), win=21,
        prepad=True, atlas_agents=jnp.asarray(agents), atlas_tiles=2,
        impl="tiled", interpret=True)

    tatlas = lambda ims: [l.reshape(-1, l.shape[-1]) for l in tlk.build_pyramid(
        torch.tensor(np.stack(ims)), 3, pad=pad)]
    prev, nxt = tatlas([base, base]), tatlas(moved)
    a, s, e = tlk.lk_track_pyr(prev, nxt, torch.tensor(pts2), win=21,
                               prepad=True, atlas_agents=torch.tensor(agents),
                               atlas_tiles=2, impl="tiled")
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_j))
    ok = s.numpy()
    assert ok.all()
    np.testing.assert_allclose(a.numpy()[ok], np.asarray(a_j)[ok], atol=1e-3)
    np.testing.assert_allclose(e.numpy()[ok], np.asarray(e_j)[ok], atol=1e-2)
    for ag, (dx, dy) in enumerate(shifts):
        flow = (a.numpy() - pts2)[agents == ag]
        np.testing.assert_allclose(flow.mean(0), [dx, dy], atol=0.2)
    # declared contiguity skips the check and gives the same answer
    a2, s2, _ = tlk.lk_track_pyr(prev, nxt, torch.tensor(pts2), win=21,
                                 prepad=True, atlas_tiles=2,
                                 atlas_contiguous=True)
    np.testing.assert_array_equal(a2.numpy(), a.numpy())
    # scattered agent ids are the strip kernel's job: the tile kernel
    # refuses them, and "auto" hands them over (same per-track function, so
    # the same numbers for the same tracks)
    rev = dict(atlas_agents=torch.tensor(agents[::-1].copy()), atlas_tiles=2)
    with pytest.raises(ValueError, match="agent-contiguous"):
        tlk.lk_track_pyr(prev, nxt, torch.tensor(pts2), win=21, prepad=True,
                         impl="tiled", **rev)
    a3, s3, _ = tlk.lk_track_pyr(prev, nxt, torch.tensor(pts2[::-1].copy()),
                                 win=21, prepad=True, **rev)
    np.testing.assert_array_equal(a3.numpy()[::-1], a.numpy())
    with pytest.raises(ValueError, match="atlas_agents"):
        tlk.lk_track_pyr(prev, nxt, torch.tensor(pts2), win=21, prepad=True,
                         atlas_tiles=2)
