"""The plain reference against the port on tiny inputs, and the
benchmark's arithmetic (bounds, trace, percentiles, the result's line)."""

import json
import math

import numpy as np
import pytest
import torch

from benchmark import bounds, harness, trace
from benchmark.reference import geometry, lk as ref_lk
from benchmark.traffic import plane

CAM = dict(width=160, height=120, fx=125.0, fy=125.0, cx=80.0, cy=60.0,
           fps=20.0)
TRAFFIC = dict(lap_frames=240, speeds_m_s=[0.99], plane_z=2.78,
               tex_scale=64.0, noise_sigma=2.0, offset_m=16.0)


@pytest.fixture(scope="module")
def frames():
    f, _ = plane.stream(TRAFFIC, CAM, 2 ** 31 + 5, 2, "cpu")
    return f[:, :2].float()


def _tracks(n=48, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(n, 2, generator=g) * torch.tensor([140.0, 100.0]) \
        + 10.0


@pytest.mark.parametrize("atlas", [False, True])
def test_reference_lk_equals_the_kernels_plain_versions(frames, atlas):
    """K2's (one image) and K1's (an atlas of two agents) semantics."""
    from mqslam_tpu_torch.ops import lk
    pad = lk.lk_pad(21)
    pts = torch.stack([_tracks(), _tracks(seed=1)])
    valid = torch.ones(2, 48, dtype=torch.bool)
    valid[0, 3] = False
    ref_uv, ref_st, ref_err = ref_lk.track(ref_lk.pyramid(frames[:, 0], 3),
                                           ref_lk.pyramid(frames[:, 1], 3),
                                           pts, valid)
    if atlas:
        atl = lambda im: [l.reshape(-1, l.shape[-1]) for l in
                          lk.build_pyramid(im, 3, pad=pad)]
        uv, st, err = lk.lk_track_pyr(atl(frames[:, 0]), atl(frames[:, 1]),
                                      pts.reshape(-1, 2), valid.reshape(-1),
                                      prepad=True, atlas_tiles=2,
                                      atlas_contiguous=True)
        uv, st, err = uv.reshape(2, 48, 2), st.reshape(2, 48), \
            err.reshape(2, 48)
    else:
        outs = [lk.lk_track_pyr(lk.build_pyramid(frames[a, 0], 3, pad=pad),
                                lk.build_pyramid(frames[a, 1], 3, pad=pad),
                                pts[a], valid[a], prepad=True)
                for a in range(2)]
        uv, st, err = (torch.stack(x) for x in zip(*outs))
    assert torch.equal(st, ref_st) and st.sum() > 60
    assert (uv - ref_uv)[st].abs().max() < 1e-4
    assert (err - ref_err)[st].abs().max() < 1e-4


def _scene(n=40, seed=3):
    g = torch.Generator().manual_seed(seed)
    X = torch.rand(n, 3, generator=g, dtype=torch.float64) * torch.tensor(
        [4.0, 3.0, 1.0], dtype=torch.float64) + torch.tensor(
        [-2.0, -1.5, 4.0], dtype=torch.float64)
    rvec = torch.tensor([0.05, -0.03, 0.02], dtype=torch.float64)
    tvec = torch.tensor([0.1, -0.2, 0.3], dtype=torch.float64)
    return X, rvec, tvec, g


def test_reference_pose_equals_pnp_refine():
    from mqslam_tpu_torch import convert
    from mqslam_tpu_torch.ops import pnp
    X, rvec, tvec, g = _scene()
    K4 = torch.tensor([500.0, 500.0, 320.0, 240.0], dtype=torch.float64)
    R = geometry.rodrigues(rvec)
    uv = geometry.project(R, tvec, X, K4) + 0.5 * torch.randn(
        40, 2, generator=g, dtype=torch.float64)
    cal = convert.cal_from_numpy([500, 500, 0, 320, 240, 0, 0, 0, 0],
                                 device="cpu")
    r0, t0 = rvec + 0.01, tvec - 0.02
    rp, tp = pnp.pnp_refine(X.float(), uv.float(), cal, r0.float(),
                            t0.float(), iters=20)
    Rg, tg = geometry.pose_gauss_newton(
        X[None], uv[None], torch.ones(1, 40, dtype=torch.float64),
        geometry.rodrigues(r0)[None], t0[None], K4)
    gap = (geometry.project(geometry.rodrigues(rp.double()), tp.double(), X,
                            K4) - geometry.project(Rg[0], tg[0], X, K4))
    assert gap.norm(dim=-1).max() < 1e-3


def test_reference_triangulation_equals_optimal():
    from mqslam_tpu_torch.core import se3
    from mqslam_tpu_torch.ops import triangulation as tri
    X, rvec, tvec, g = _scene()
    R1 = torch.eye(3, dtype=torch.float64)
    t1 = torch.zeros(3, dtype=torch.float64)
    R2, t2 = geometry.rodrigues(rvec), tvec
    K4 = torch.tensor([1.0, 1.0, 0.0, 0.0], dtype=torch.float64)
    x1 = geometry.project(R1, t1, X, K4) + 1e-3 * torch.randn(
        40, 2, generator=g, dtype=torch.float64)
    x2 = geometry.project(R2, t2, X, K4) + 1e-3 * torch.randn(
        40, 2, generator=g, dtype=torch.float64)
    P1 = se3.from_rvec_tvec(torch.zeros(3), torch.zeros(3))
    P2 = se3.from_rvec_tvec(rvec.float(), tvec.float())
    Xp, ok = tri.optimal(x1.float(), P1, x2.float(), P2)
    Xr = geometry.triangulate(x1, R1.expand(40, 3, 3), t1.expand(40, 3), x2,
                              R2.expand(40, 3, 3), t2.expand(40, 3))
    rel = (Xp.double() - Xr).norm(dim=-1) / Xr.norm(dim=-1)
    assert ok.all() and rel.max() < 1e-4


def test_reference_landmark_choice_gates_like_the_tracker():
    """Candidates within the reprojection gate in both views and in front
    of both are chosen, in slot order as far as the store holds them."""
    from benchmark.reference import frontend as ref
    F = torch.float64
    K4 = torch.tensor([500.0, 500.0, 320.0, 240.0], dtype=F)
    X = torch.tensor([[0.2, 0.1, 3.0], [-0.3, 0.2, 2.5], [0.1, -0.2, 4.0],
                      [0.0, 0.3, 3.5]], dtype=F)
    Rk, tk = torch.eye(3, dtype=F)[None], torch.zeros(1, 3, dtype=F)
    Rc = geometry.rodrigues(torch.tensor([[0.0, 0.02, 0.0]], dtype=F))
    tc = torch.tensor([[-0.3, 0.0, 0.0]], dtype=F)
    base = geometry.project(Rk[0], tk[0], X, K4)[None]
    cur = geometry.project(Rc[0], tc[0], X, K4)[None].clone()
    cur[0, 1, 1] += 3.0           # off the epipolar line: fails the gate
    cand = torch.tensor([[True, True, True, False]])
    tracker = dict(max_new_landmark_reproj=1.0, max_landmarks=100)
    n = torch.tensor([10])
    got = ref._chosen(cand, base, cur, (Rk, tk), (Rc, tc), n, K4, tracker)
    assert got.tolist() == [[True, False, True, False]]
    tracker["max_landmarks"] = 11          # room for one more
    got = ref._chosen(cand, base, cur, (Rk, tk), (Rc, tc), n, K4, tracker)
    assert got.tolist() == [[True, False, False, False]]
    behind = (Rk, tk - torch.tensor([[0.0, 0.0, 5.0]], dtype=F))
    got = ref._chosen(cand, base, cur, behind, (Rc, tc), n, K4,
                      dict(tracker, max_landmarks=100))
    assert not got.any()


def test_lk_bytes_bound():
    # P = 12 + 2 + 21 = 35; regions 5 (24^2 + 35^2) 4 = 36,020 > both
    # images 8,000; per-track I/O 10 * 49
    assert bounds.lk_level_bytes(1000, 4, 10, 5, 21, 12.0) == 8000 + 490
    assert bounds.lk_level_bytes(10 ** 6, 4, 10, 5, 21, 12.0) == 36020 + 490
    assert math.isclose(bounds.lk_level_seconds(10 ** 6, 4, 10, 5, 21, 12.0),
                        36510 / 3.35e12)


class _Ev:
    def __init__(self, name, s, e):
        self.name = name
        self.time_range = type("T", (), dict(start=s, end=e))()


def test_busy_union_and_idle_gaps():
    merged, busy = trace.union_seconds([(0, 10), (5, 20), (30, 40)])
    assert merged == [[0, 20], [30, 40]] and math.isclose(busy, 30e-6)
    host = [_Ev("outer", 0, 100), _Ev("aten::item", 21, 29)]
    gaps = trace.gaps_by_host_op(merged + [[50, 60]], host)
    assert gaps == [["outer", 10e-6], ["aten::item", 10e-6]] or gaps == [
        ["aten::item", 10e-6], ["outer", 10e-6]]


def test_percentile_matches_numpy():
    v = list(np.random.RandomState(0).rand(37))
    for q in (0, 50, 90, 100):
        assert math.isclose(harness.percentile(v, q), np.percentile(v, q))


def test_forbidden_modules_by_whole_top_level_name():
    mods = {"mqslam_tpu_torch": 1, "mqslam_tpu_torch.ops": 1, "jaxtyping": 1,
            "mqslam_tpu": 1, "jax.numpy": 1, "flax": 1, "numpy": 1}
    assert harness.forbidden_modules(mods) == ["flax", "jax.numpy",
                                                "mqslam_tpu"]


def test_result_line_schema():
    line = harness.result_line(
        True, 10, 1, {"frames_per_s": {"value": 1.5, "unit": "frames/s"}},
        {"platform": "gpu", "kind": "k", "count": 1, "memory_peak_bytes": 5},
        [("flow_gap_px", 1e-4, 0.01)], breakdown={"device_ops": [],
                                                  "idle_gaps": []})
    d = json.loads(line)
    assert list(d) == ["correct", "attempted", "failed", "metrics", "device",
                       "breakdown", "checks"]
    assert d["checks"] == {"flow_gap_px": {"value": 1e-4, "limit": 0.01}}
    bad = harness.result_line(False, 1, 0, {}, {}, [("pose_gap_px",
                                                    float("inf"), 0.5)])
    assert json.loads(bad)["checks"]["pose_gap_px"]["value"] == "inf"
