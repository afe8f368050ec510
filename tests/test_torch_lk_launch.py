"""What surrounds the launches of the kernels that run the per-track LK
function (``ops/lk_tile`` for K1, ``ops/lk_fused`` for K2, ``ops/lk_iterate``
for K4, which follows the level kernels' rule), in the plain Python the CPU
reaches: the threads a
track (``lanes_per_track``) from the track count and the SM count, the choice
between the compiled-in window and the generic code (``instantiation``), and
the wrappers' checks of the private ``_lanes`` argument, which forces a lane
shape so that every instantiation can be held against the plain version on
the card.  On CPU tensors a forced lane shape changes nothing: the plain
version runs, and its result is compared bit for bit.
"""

import numpy as np
import pytest
import torch

from mqslam_tpu_torch.ops import lk as tlk, lk_fused, lk_iterate, lk_tile

H100_SMS = 132


def test_lanes_on_the_main_paths():
    # the fleet's 16 x 384 tracks: one warp a track, a persistent grid
    assert lk_tile.lanes_per_track(6144, H100_SMS) == 32
    # the single agent's 384 tracks: four warps a track
    assert lk_tile.lanes_per_track(384, H100_SMS) == 128


@pytest.mark.parametrize("T", [0, 1])
def test_lanes_at_no_and_one_track(T):
    assert lk_tile.lanes_per_track(T, H100_SMS) == 128
    assert lk_tile.lanes_per_track(T, 1) in lk_tile.LANE_SHAPES


@pytest.mark.parametrize("n_sm", [1, 16, 114, 132, 144])
def test_lanes_stable_as_tracks_grow(n_sm):
    got = [lk_tile.lanes_per_track(T, n_sm) for T in range(0, 20001, 7)]
    assert set(got) <= set(lk_tile.LANE_SHAPES)
    first32 = got.index(32)
    assert all(x == 128 for x in got[:first32])
    assert all(x == 32 for x in got[first32:])
    # the switch moves with the card: more SMs keep four warps a track longer
    assert lk_tile.lanes_per_track(4 * n_sm, n_sm) == 128
    assert lk_tile.lanes_per_track(4 * n_sm + 1, n_sm) == 32


def test_lanes_need_an_sm():
    with pytest.raises(ValueError, match="n_sm"):
        lk_tile.lanes_per_track(384, 0)


@pytest.mark.parametrize("win,margin,want", [
    (21, 7, "specialised"), (15, 7, "generic"), (21, 5, "generic"),
    (9, 3, "generic"), (23, 7, "generic")])
def test_instantiation(win, margin, want):
    P = win + 2 * margin + 1                     # what lk_track_pyr passes
    hiX = float(P - 2 - win)
    assert lk_tile.search_side(win, hiX) == P
    assert lk_tile.instantiation(win, P) == want


def test_launch_lanes():
    spec, gen = lk_tile.SPECIALISED, (15, 30)
    assert lk_tile.launch_lanes(6144, H100_SMS, *spec) == 32
    assert lk_tile.launch_lanes(384, H100_SMS, *spec) == 128
    # the generic window runs one warp a track at any track count
    assert lk_tile.launch_lanes(1, H100_SMS, *gen) == 32
    assert lk_tile.launch_lanes(6144, H100_SMS, *gen) == 32
    # a forced shape wins over the rule, both ways
    assert lk_tile.launch_lanes(6144, H100_SMS, *spec, force=128) == 128
    assert lk_tile.launch_lanes(384, H100_SMS, *spec, force=32) == 32
    assert lk_tile.launch_lanes(384, H100_SMS, *gen, force=32) == 32


@pytest.mark.parametrize("bad", [0, 16, 64, 96, 256, True, "32"])
def test_forced_lanes_must_be_a_shape(bad):
    with pytest.raises(ValueError, match="_lanes must be one of"):
        lk_tile.check_lanes(bad, *lk_tile.SPECIALISED)


def test_generic_window_takes_one_warp_only():
    lk_tile.check_lanes(32, 15, 30)
    with pytest.raises(ValueError, match="generic window"):
        lk_tile.check_lanes(128, 15, 30)
    with pytest.raises(ValueError, match="generic window"):
        lk_tile.kernel_info(15, 30, 128)          # refused before any build
    with pytest.raises(ValueError, match="generic window"):
        lk_fused.kernel_info(15, 30, 128)
    with pytest.raises(ValueError, match="generic window"):
        lk_iterate.kernel_info(15, 30, 128)


# K4 (the Newton loop on patches) at the windows lk_track_pyr(impl="pallas")
# hands it: win = 21 with search patches of 36 (the compiled-in window) at
# the single agent's and the fleet's track counts, and win = 15 (P = 30)
@pytest.mark.parametrize("T,win,P,want", [
    (384, 21, 36, ("specialised", 128)), (6144, 21, 36, ("specialised", 32)),
    (384, 15, 30, ("generic", 32)), (6144, 15, 30, ("generic", 32))])
def test_iterate_launch_shape(T, win, P, want):
    assert lk_iterate.launch_shape(T, H100_SMS, win, P) == want


def test_iterate_forced_lanes():
    spec = lk_tile.SPECIALISED
    assert lk_iterate.launch_shape(384, H100_SMS, *spec, _lanes=32) == \
        ("specialised", 32)
    assert lk_iterate.launch_shape(6144, H100_SMS, *spec, _lanes=128) == \
        ("specialised", 128)
    with pytest.raises(ValueError, match="_lanes must be one of"):
        lk_iterate.launch_shape(384, H100_SMS, *spec, _lanes=64)
    with pytest.raises(ValueError, match="generic window"):
        lk_iterate.launch_shape(384, H100_SMS, 15, 30, _lanes=128)


def level_args(win, n=24, seed=5):
    """A small level in both wrappers' contract: two 64x80 images, n tracks
    at random in-image corners (some skipped), anchors in range."""
    margin = 7
    P = win + 2 * margin + 1
    hiX = float(P - 2 - win)
    rng = np.random.RandomState(seed)
    J = rng.uniform(0, 255, (64, 80)).astype(np.float32)
    I = np.roll(J, (1, 2), (0, 1)) + rng.normal(0, 1, J.shape).astype(
        np.float32)
    cJ = np.stack([rng.randint(0, 64 - win - 3, n),
                   rng.randint(0, 80 - win - 3, n)], 1).astype(np.int32)
    cI = np.maximum(cJ - margin + 1, 0).astype(np.int32)
    aJ = rng.uniform(1, 2, (n, 2)).astype(np.float32)
    a0 = rng.uniform(0, hiX, (n, 2)).astype(np.float32)
    valid = rng.rand(n) > 0.2
    t = torch.tensor
    return (t(J), t(I), t(cJ), t(cI), t(aJ), t(a0), t(valid)), win, hiX


def call(module, args, win, hiX, **kw):
    if module is lk_tile:
        return lk_tile.lk_level(*args, 1, win, 30, 0.01, hiX, **kw)
    if module is lk_iterate:
        # each track's own patches at its corners (the driver's square
        # extraction): the template's win + 3, the search region's P
        J, I, cJ, cI, aJ, a0 = args[:6]
        P = lk_tile.search_side(win, hiX)
        return lk_iterate.lk_iterate(tlk._extract_patches(J, cJ, win + 3)[0],
                                     tlk._extract_patches(I, cI, P)[0], aJ,
                                     a0, win, 30, 0.01, **kw)
    return lk_fused.lk_level(*args, win, 30, 0.01, hiX, **kw)


MODULES = [lk_tile, lk_fused, lk_iterate]
MODULE_IDS = ["lk_tile", "lk_fused", "lk_iterate"]


@pytest.mark.parametrize("module", MODULES, ids=MODULE_IDS)
@pytest.mark.parametrize("lanes", [32, 128])
def test_forced_lanes_on_cpu_is_the_plain_version(module, lanes):
    args, win, hiX = level_args(21)
    n0 = module.launches
    ref = call(module, args, win, hiX)
    got = call(module, args, win, hiX, _lanes=lanes)
    assert module.launches == n0           # CPU tensors: the plain version
    for x, y in zip(got, ref):
        assert torch.equal(x, y)


@pytest.mark.parametrize("module", MODULES, ids=MODULE_IDS)
def test_wrapper_checks_forced_lanes(module):
    args, win, hiX = level_args(21)
    with pytest.raises(ValueError, match="_lanes must be one of"):
        call(module, args, win, hiX, _lanes=64)
    gargs, gwin, ghiX = level_args(15)
    call(module, gargs, gwin, ghiX, _lanes=32)
    with pytest.raises(ValueError, match="generic window"):
        call(module, gargs, gwin, ghiX, _lanes=128)
    # checked before the device is looked at: a meta tensor never reaches a
    # launch, and no launch is counted
    n0 = module.launches
    meta = tuple(x.to("meta") for x in args)
    with pytest.raises(ValueError, match="_lanes must be one of"):
        call(module, meta, win, hiX, _lanes=96)
    assert module.launches == n0


def test_generic_window_through_lk_track_pyr_tiled_and_fused_agree():
    """lk_track_pyr at win = 15 (the generic instantiation on the card)
    through the tile level and the strip level: the same tracks, equal to
    1e-5 px (one per-track function, two addressings)."""
    args, _, _ = level_args(15, n=40, seed=9)
    J, I = args[0], args[1]
    rng = np.random.RandomState(3)
    pts = torch.tensor(np.stack([rng.uniform(20, 60, 40),
                                 rng.uniform(20, 44, 40)], 1),
                       dtype=torch.float32)
    pyrJ, pyrI = tlk.build_pyramid(J, 2), tlk.build_pyramid(I, 2)
    out_t = tlk.lk_track_pyr(pyrJ, pyrI, pts, win=15, impl="tiled")
    out_f = tlk.lk_track_pyr(pyrJ, pyrI, pts, win=15, impl="fused")
    assert torch.equal(out_t[1], out_f[1]) and bool(out_t[1].any())
    ok = out_t[1]
    assert float((out_t[0] - out_f[0])[ok].abs().max()) <= 1e-5
