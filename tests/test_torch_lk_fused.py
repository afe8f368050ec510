"""The port's strip LK level (``ops/lk_fused``: the plain version, which is
what the wrapper runs for CPU tensors) and ``lk_track(impl="fused")`` against
the JAX package's fused kernel in interpret mode, on the same NumPy inputs.

Tolerances: ``a_final`` / flow 1e-3 px, ``min_eig`` 1e-4 relative, ``err``
1e-2 — the same per-track function behind two layouts, the 441-term window
sums taken in another order.  bfloat16 store: 0.05 px against the JAX bf16
store and against the port's own float32 (pixel rounding of <= 0.4 intensity
on the downsampled levels moves a track by hundredths of a pixel).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqslam_tpu.ops import lk as jlk, lk_fused_pallas as jfp
from mqslam_tpu_torch.ops import lk as tlk, lk_fused, lk_tile
from test_torch_lk import grid, rot_scale_shift, texture, warp

WIN, MARGIN = 21, 7
R_, PAD = WIN // 2, WIN // 2 + MARGIN + 1
P = WIN + 2 * MARGIN + 1
HIX = float(P - 2 - WIN)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.RandomState(4242)
    base = texture(rng)
    moved = warp(base, rot_scale_shift(1.5, 1.01, 2.0, -1.5))
    return base, moved


def level_inputs(base, moved, pts, valid):
    """Level-0 inputs in the port's contract: padded images, ABSOLUTE
    corners, anchors relative to them (no clamp binds for in-image points)."""
    J = np.pad(base, PAD, mode="edge")
    I = np.pad(moved, PAD, mode="edge")
    p = pts + PAD
    fl = lambda v: np.floor(v).astype(np.int32)
    cJ = np.stack([fl(p[:, 1]) - R_ - 1, fl(p[:, 0]) - R_ - 1], 1)
    cI = np.stack([fl(p[:, 1]) - R_ - MARGIN, fl(p[:, 0]) - R_ - MARGIN], 1)
    aJ = (p[:, ::-1] - R_ - cJ).astype(np.float32)
    a0 = (p[:, ::-1] - R_ - cI).astype(np.float32)
    return dict(J=J, I=I, cJ=cJ, cI=cI, aJ=aJ, a0=a0, valid=valid)


def jax_level(d, dtype=jnp.float32, want=None):
    """The same level through the JAX kernel: the test builds its transport
    (shifted stacked copies, aligned strip origins, residuals, clip base)
    from the same absolute corners.  Returns a_final relative to cI."""
    copJ = jfp.strip_copies(jnp.asarray(d["J"]), dtype)
    copI = jfp.strip_copies(jnp.asarray(d["I"]), dtype)
    Hp, Wp = copJ.shape[0] // 2, copJ.shape[1]
    yJ, xJ, cyJ, cxJ, ryJ, rxJ = jfp.strip_corners(
        jnp.asarray(d["cJ"][:, 0]), jnp.asarray(d["cJ"][:, 1]), Hp, Wp,
        jfp.TMPL_ROWS, jfp.TMPL_CAP, WIN + 3)
    yI, xI, cyI, cxI, ryI, rxI = jfp.strip_corners(
        jnp.asarray(d["cI"][:, 0]), jnp.asarray(d["cI"][:, 1]), Hp, Wp,
        jfp.SEARCH_ROWS, P, P)
    # no clamp binds: the strip corners are the corners handed in
    np.testing.assert_array_equal(np.stack([cyJ, cxJ], 1), d["cJ"])
    np.testing.assert_array_equal(np.stack([cyI, cxI], 1), d["cI"])
    resJ = jnp.stack([ryJ, rxJ], 1).astype(jnp.float32)
    lo = jnp.stack([ryI, rxI], 1).astype(jnp.float32)
    a, eig, err = jfp.lk_level_fused(
        copJ, copI, jnp.stack([yJ, xJ], 1), jnp.stack([yI, xI], 1),
        jnp.asarray(d["aJ"]) + resJ, jnp.asarray(d["a0"]) + lo, lo,
        jnp.asarray(d["valid"]), WIN, 30, 0.01, HIX, interpret=True)
    return np.asarray(a - lo), np.asarray(eig), np.asarray(err)


def torch_level(d, dtype=torch.float32, fn=lk_fused.lk_level, **kw):
    t = torch.tensor
    return fn(t(d["J"]).to(dtype), t(d["I"]).to(dtype), t(d["cJ"]),
              t(d["cI"]), t(d["aJ"]), t(d["a0"]), t(d["valid"]), WIN, 30,
              0.01, HIX, **kw)


def test_level_plain_matches_pallas_kernel(pair):
    base, moved = pair
    pts = grid(60, 260, 60, 180, 50) + 0.37
    valid = np.ones(len(pts), bool)
    valid[3] = False
    d = level_inputs(base, moved, pts, valid)
    a_j, eig_j, err_j = jax_level(d)
    n0 = lk_fused.launches
    a_t, eig_t, err_t = torch_level(d)
    assert lk_fused.launches == n0      # CPU tensors: the plain version
    np.testing.assert_allclose(a_t.numpy()[valid], a_j[valid], atol=1e-3)
    np.testing.assert_allclose(eig_t.numpy()[valid], eig_j[valid], rtol=1e-4)
    np.testing.assert_allclose(err_t.numpy()[valid], err_j[valid], atol=1e-2)
    # the skipped track returns its a0, and zeros
    np.testing.assert_array_equal(a_t.numpy()[3], d["a0"][3])
    assert eig_t[3] == 0 and err_t[3] == 0
    flow = (a_t.numpy() - d["a0"])[valid]
    assert np.abs(flow[:, 1] - 2.0).max() < 4 and np.abs(flow).max() > 1
    # without the error pass: the same anchors, err = 0
    a_n, _, err_n = torch_level(d, want_err=False)
    np.testing.assert_array_equal(a_n.numpy(), a_t.numpy())
    assert (err_n == 0).all()


def test_level_is_the_tile_level_in_any_order(pair):
    """The strip level on shuffled tracks with absolute corners equals the
    tile level on the ordered tracks with local corners, bit for bit: one
    per-track function."""
    base, moved = pair
    pts = grid(60, 260, 60, 180, 50) + 0.37
    valid = np.ones(len(pts), bool)
    d = level_inputs(base, moved, pts, valid)
    t = torch.tensor
    # a two-tile atlas: tile 1 is the pair swapped; tracks of tile 1 follow
    J2 = np.concatenate([d["J"], d["I"]])
    I2 = np.concatenate([d["I"], d["J"]])
    two = lambda x: np.concatenate([x, x])
    ref = lk_tile.lk_level_plain(
        t(J2), t(I2), t(two(d["cJ"])), t(two(d["cI"])), t(two(d["aJ"])),
        t(two(d["a0"])), t(two(valid)), 2, WIN, 30, 0.01, HIX)
    Hp = d["J"].shape[0]
    off = np.repeat([0, Hp], len(pts)).astype(np.int32)[:, None] * [1, 0]
    perm = np.random.RandomState(0).permutation(2 * len(pts))
    got = lk_fused.lk_level_plain(
        t(J2), t(I2), t((two(d["cJ"]) + off)[perm].astype(np.int32)),
        t((two(d["cI"]) + off)[perm].astype(np.int32)),
        t(two(d["aJ"])[perm]), t(two(d["a0"])[perm]), t(two(valid)[perm]),
        WIN, 30, 0.01, HIX)
    for x, y in zip(got, ref):
        np.testing.assert_array_equal(x.numpy(), y.numpy()[perm])


def test_level_nan_in_skipped_tracks(pair):
    base, moved = pair
    pts = grid(60, 260, 60, 180, 50)
    valid = np.ones(len(pts), bool)
    d = level_inputs(base, moved, pts, valid)
    ref = torch_level(d)
    bad = {k: v.copy() for k, v in d.items()}
    bad["valid"][[1, 4]] = False
    bad["aJ"][[1, 4]] = np.nan
    bad["a0"][[1, 4]] = np.nan
    bad["cJ"][[1, 4]] = np.iinfo(np.int32).min
    bad["cI"][[1, 4]] = np.iinfo(np.int32).max
    out = torch_level(bad, fn=lk_fused.lk_level_plain, return_iters=True)
    keep = bad["valid"]
    for x, y in zip(out[:3], ref):
        np.testing.assert_array_equal(x.numpy()[keep], y.numpy()[keep])
    assert np.isnan(out[0].numpy()[[1, 4]]).all()
    assert (out[1].numpy()[~keep] == 0).all()
    assert (out[3].numpy()[~keep] == 0).all()
    assert (out[3].numpy()[keep] > 0).all()


def test_level_bf16_store(pair):
    """bfloat16 images: the plain version computes on the widened values, as
    the JAX kernel does after its copy (0.05 px; min_eig 2e-2 relative: the
    same rounded pixels, sums in another order), and stays within 0.05 px of
    float32."""
    base, moved = pair
    pts = grid(60, 260, 60, 180, 50) + 0.37
    valid = np.ones(len(pts), bool)
    d = level_inputs(base, moved, pts, valid)
    a_j, eig_j, _ = jax_level(d, jnp.bfloat16)
    a_b, eig_b, _ = torch_level(d, torch.bfloat16)
    a_f, _, _ = torch_level(d)
    np.testing.assert_allclose(a_b.numpy(), a_j, atol=0.05)
    np.testing.assert_allclose(eig_b.numpy(), eig_j, rtol=2e-2)
    np.testing.assert_allclose(a_b.numpy(), a_f.numpy(), atol=0.05)
    assert not np.array_equal(a_b.numpy(), a_f.numpy())


def test_wrapper_rejects_bad_inputs_and_devices(pair):
    base, moved = pair
    d = level_inputs(base, moved, grid(60, 260, 60, 180, 50),
                     np.ones(12, bool))
    with pytest.raises(TypeError, match="float32 or both bfloat16"):
        torch_level(d, torch.float64)
    with pytest.raises(TypeError):
        lk_fused.lk_level(torch.tensor(d["J"]),
                          torch.tensor(d["I"]).to(torch.bfloat16),
                          *(torch.tensor(d[k]) for k in
                            ("cJ", "cI", "aJ", "a0", "valid")),
                          WIN, 30, 0.01, HIX)
    # any device but the CPU is the kernel's or an error
    t = lambda k: torch.tensor(d[k]).to("meta")
    n0 = lk_fused.launches
    with pytest.raises(RuntimeError, match="unsupported device"):
        lk_fused.lk_level(t("J"), t("I"), t("cJ"), t("cI"), t("aJ"), t("a0"),
                          t("valid"), WIN, 30, 0.01, HIX)
    assert lk_fused.launches == n0


def test_lk_track_fused_matches_jax(pair):
    base, moved = pair
    pts = np.concatenate([grid(80, 240, 80, 160, 60),
                          [[400.0, 100.0], [-5.0, 3.0], [4.0, 4.0],
                           [np.nan, np.nan]]]).astype(np.float32)
    a_j, s_j, e_j = jlk.lk_track(jnp.asarray(base), jnp.asarray(moved),
                                 jnp.asarray(pts), impl="fused",
                                 interpret=True)
    tb, tm, tp = torch.tensor(base), torch.tensor(moved), torch.tensor(pts)
    a, s, e = tlk.lk_track(tb, tm, tp, impl="fused")
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_j))
    ok = s.numpy()
    assert ok.sum() >= 6 and not ok[-4:-2].any() and not ok[-1]
    np.testing.assert_allclose(a.numpy()[ok], np.asarray(a_j)[ok], atol=1e-3)
    np.testing.assert_allclose(e.numpy()[ok], np.asarray(e_j)[ok], atol=1e-2)
    assert np.isinf(e.numpy()[~ok]).all() and torch.isnan(a[-1]).all()
    # a single image is the strip kernel's by default, and the tile kernel
    # on one tile computes the same numbers
    for kw in ({}, {"impl": "tiled"}):
        a2, s2, e2 = tlk.lk_track(tb, tm, tp, **kw)
        np.testing.assert_array_equal(a2.numpy()[ok], a.numpy()[ok])
        np.testing.assert_array_equal(s2.numpy(), s.numpy())
    with pytest.raises(ValueError, match="impl"):
        tlk.lk_track(tb, tm, tp, impl="banded")
    with pytest.raises(ValueError, match="store_dtype"):
        tlk.lk_track(tb, tm, tp, store_dtype="float16")
    with pytest.raises(ValueError, match="float32"):
        tlk.lk_track(tb, tm, tp, impl="tiled", store_dtype="bfloat16")


def test_lk_track_bf16_store(pair):
    base, moved = pair
    pts = grid(80, 240, 80, 160, 60)
    a_j, s_j, _ = jlk.lk_track(jnp.asarray(base), jnp.asarray(moved),
                               jnp.asarray(pts), impl="fused",
                               interpret=True, store_dtype="bfloat16")
    args = (torch.tensor(base), torch.tensor(moved), torch.tensor(pts))
    a_b, s_b, _ = tlk.lk_track(*args, store_dtype="bfloat16")
    a_f, s_f, _ = tlk.lk_track(*args, store_dtype="float32")
    np.testing.assert_array_equal(s_b.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(s_b.numpy(), s_f.numpy())
    ok = s_b.numpy()
    assert ok.all()
    np.testing.assert_allclose(a_b.numpy(), np.asarray(a_j), atol=0.05)
    np.testing.assert_allclose(a_b.numpy(), a_f.numpy(), atol=0.05)


def test_lk_atlas_interleaved_agents(pair):
    """The two-agent atlas with the agent ids INTERLEAVED (track 2k is agent
    0's, track 2k+1 agent 1's): against the JAX fused kernel, status equal
    and flow 1e-3 px; each agent recovers its own shift; the default impl
    picks the strip kernel for them."""
    base, _ = pair
    shifts = [(2.0, -1.5), (-3.0, 1.0)]
    moved = [warp(base, np.array([[1, 0, -dx], [0, 1, -dy]], np.float64))
             for dx, dy in shifts]
    pts = grid(80, 240, 80, 160, 40)
    T = len(pts)
    pad = tlk.lk_pad()
    pts2 = np.repeat(pts, 2, axis=0)
    agents = np.tile(np.arange(2, dtype=np.int32), T)

    jpyr = lambda im: jlk.build_pyramid(jnp.asarray(im), 3, pad=pad)
    jatlas = lambda ims: tuple(jnp.concatenate(l, axis=0)
                               for l in zip(*[jpyr(im) for im in ims]))
    a_j, s_j, e_j = jlk.lk_track_pyr(
        jatlas([base, base]), jatlas(moved), jnp.asarray(pts2), win=21,
        prepad=True, atlas_agents=jnp.asarray(agents), atlas_tiles=2,
        impl="fused", interpret=True)

    tatlas = lambda ims: [l.reshape(-1, l.shape[-1]) for l in tlk.build_pyramid(
        torch.tensor(np.stack(ims)), 3, pad=pad)]
    prev, nxt = tatlas([base, base]), tatlas(moved)
    kw = dict(win=21, prepad=True, atlas_agents=torch.tensor(agents),
              atlas_tiles=2)
    a, s, e = tlk.lk_track_pyr(prev, nxt, torch.tensor(pts2), impl="fused",
                               **kw)
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_j))
    assert s.all()
    np.testing.assert_allclose(a.numpy(), np.asarray(a_j), atol=1e-3)
    np.testing.assert_allclose(e.numpy(), np.asarray(e_j), atol=1e-2)
    for ag, (dx, dy) in enumerate(shifts):
        flow = (a.numpy() - pts2)[agents == ag]
        np.testing.assert_allclose(flow.mean(0), [dx, dy], atol=0.2)
    a2, s2, _ = tlk.lk_track_pyr(prev, nxt, torch.tensor(pts2), **kw)
    np.testing.assert_array_equal(a2.numpy(), a.numpy())
    # an invalid track may carry any agent id and NaN coordinates
    pts3 = pts2.copy()
    pts3[5] = np.nan
    ag3 = agents.copy()
    ag3[5] = 2 ** 30
    valid = np.ones(2 * T, bool)
    valid[5] = False
    a3, s3, _ = tlk.lk_track_pyr(
        prev, nxt, torch.tensor(pts3), torch.tensor(valid), win=21,
        prepad=True, atlas_agents=torch.tensor(ag3), atlas_tiles=2)
    keep = np.arange(2 * T) != 5
    np.testing.assert_array_equal(a3.numpy()[keep], a.numpy()[keep])
    assert not s3[5] and s3[keep].all()
