"""Benchmark of the port: SLAM front-end throughput on one CUDA device.

    python -m mqslam_tpu_torch.bench

Prints ONE JSON line, as the JAX package's ``bench.py`` does, with the same
``metric`` (``slam_frontend_aggregate_frames_per_s_per_chip``), ``value``,
``unit`` and ``vs_baseline``, and the ``extra`` keys of its sections that
the port has the modules for:

* the headline: aggregate frames/s of the divergent fleet
  (``make_multi_agent_runner``: A independent agents, 640x480, 33 frames,
  ``TrackerConfig()`` defaults), swept over A = 1, 2, 4, 8, 16, 32 until
  tracking breaks down (A = 1 is the single-agent ``make_scan_runner``);
* the cloned fleet (one state and one sequence broadcast to A = 8, 16);
* LK per call, 384 tracks on the 640x480 pair, for each of the four impls
  (``xla`` over the extraction kernel, ``pallas`` over the Newton-loop
  kernel, ``fused``, ``tiled``): 30 calls feeding the flow back, best of 3,
  host clock closed by a synchronize;
* the LK call's bytes against the card's memory rate (``efficiency``);
* two-view triangulation throughput, four methods, N = 65536;
* BA: LM iterations/s of ``lm_solve_device`` and of ``lm_solve`` (the
  dense-Schur path) on the synthetic 2-robot cube, odometry off (the JAX
  bench's real SVO dump is not in the repo, and the JAX bench falls back to
  the same cube without it); both keys time the same host-driven loop
  until the port has a device-side one (``lm_solve_device`` wraps
  ``lm_solve``); the incremental figure is null without that dump, as in
  the JAX bench;
* BA at scale (``corridor_cg``): ms per CG iteration of ``solve_delta``
  over the banded, packed and COO layouts on the corridor problem (F =
  2048 poses, 24 landmarks a frame), the slope between 25- and
  100-iteration budgets run in full (``cg_tol=0``), and each layout's bytes
  an iteration against the card's memory rate (``efficiency.cg_*``,
  ``banded_cg_*``, ``coo_cg_*``);
* loop closure (``loop_closure``): keyframe-DB scorings/s of one query
  against a full 256-keyframe x 384-descriptor DB (20 scans) and pose-graph
  LM iterations/s on a 512-pose circuit with 16 closure edges (20
  iterations), best of 3;
* ``vs_baseline``: OpenCV's per-frame ladder on the host's CPU where cv2
  imports, else 30 frames/s (real time).

Every section of the JAX bench is here (``NOT_PORTED`` is empty).  Every
function takes ``device=`` (None: the CUDA device), so the tests run them
on the CPU at tiny sizes; a time from a CPU run is not a device figure.
"""

import concurrent.futures
import json
import multiprocessing
import subprocess
import sys
import time

import numpy as np
import torch

from mqslam_tpu_torch import convert, resolve_device
from mqslam_tpu_torch.ba import posegraph as pg
from mqslam_tpu_torch.frontend import loopclosure as lc
from mqslam_tpu_torch.frontend import synthetic, tracker as trk
from mqslam_tpu_torch.ops import features, lk
from mqslam_tpu_torch.ops import triangulation as tri

__all__ = ["render_fleet", "bench_single", "bench_multi",
           "bench_multi_divergent", "lk_pair_inputs", "bench_lk_impls",
           "lk_efficiency", "bench_ba_iters", "bench_corridor_cg",
           "cg_efficiency", "bench_triangulation", "bench_loopclosure",
           "loopclosure_inputs", "bench_opencv_baseline", "summary",
           "main"]

METRIC = "slam_frontend_aggregate_frames_per_s_per_chip"
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
NOT_PORTED = ()
LK_IMPLS = ("xla", "pallas", "fused", "tiled")

_T0 = time.perf_counter()


def _log(msg):
    print(f"[bench +{time.perf_counter() - _T0:7.1f}s] {msg}",
          file=sys.stderr, flush=True)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device):
    """Host seconds of ``fn()``, closed by a synchronize on the card."""
    _sync(device)
    t0 = time.perf_counter()
    fn()
    _sync(device)
    return time.perf_counter() - t0


def _best(fn, device, repeats):
    return min(_timed(fn, device) for _ in range(repeats))


def _generator(device):
    """The RANSAC draws of every timed run: one seed, so repeats agree."""
    return torch.Generator(device=device).manual_seed(0)


def _render(params):
    return synthetic.build_sequence(**params)


def render_fleet(A, n_frames=33, size=(640, 480), f=500.0, plane_z=4.0,
                 workers=8):
    """``synthetic.build_divergent_fleet(A)``, the agents rendered in
    ``workers`` processes (NumPy; about 2.5 s per 640x480 agent)."""
    params = synthetic.divergent_fleet_params(A, n_frames, size, f, plane_z)
    if workers <= 1:
        return [_render(p) for p in params]
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=min(workers, A), mp_context=ctx) as pool:
        return list(pool.map(_render, params))


def _bootstrap_state(imgs, P_list, f, size, plane_z, device=None,
                     config=None):
    """One agent bootstrapped on its first frame from 128 detected corners
    back-projected onto the known plane."""
    device = resolve_device(device)
    cal = convert.cal_from_numpy(
        [f, f, 0.0, size[0] / 2, size[1] / 2, 0, 0, 0, 0], device=device)
    config = config or trk.TrackerConfig()
    uv, valid = features.detect_corners(
        torch.as_tensor(imgs[0]).to(device), max_corners=160, cell=14)
    uv = uv[valid][:128].cpu().numpy()
    objp = synthetic.backproject_to_plane(uv, P_list[0], f,
                                          (size[0] / 2, size[1] / 2),
                                          plane_z)
    state = trk.bootstrap(uv.astype(np.float32), objp.astype(np.float32),
                          cal, imgs[0], config, device=device)
    return cal, config, state


def bench_single(cal, config, state, imgs, repeats=3, device=None):
    """One agent through ``make_scan_runner``: (frames/s, tracked, total)."""
    device = resolve_device(device)
    run = trk.make_scan_runner(cal, config, device=device)
    imgs_dev = torch.as_tensor(imgs).to(device)
    once = lambda: run(state, imgs_dev, generator=_generator(device))
    _log("single-agent warm-up run")
    _, (accepted, _, _) = once()
    n = imgs.shape[0] - 1
    best = _best(once, device, repeats)
    return n / best, int((accepted > 0).sum()), n


def _fleet_run(cal, config, states, imgs_dev, repeats, device):
    run = trk.make_multi_agent_runner(cal, config, device=device)
    once = lambda: run(states, imgs_dev, generator=_generator(device))
    _, (accepted, _, _) = once()
    A, n = imgs_dev.shape[0], imgs_dev.shape[1] - 1
    best = _best(once, device, repeats)
    return A * n / best, int((accepted > 0).sum()), A * n


def bench_multi(cal, config, state, imgs, A, repeats=3, device=None):
    """Cloned fleet: ONE state and ONE sequence broadcast to all A agents
    (a comparison row; keyframe phases coincide).  (aggregate frames/s,
    tracked, total)."""
    device = resolve_device(device)
    states = trk.TrackerState(*(x[None].expand((A,) + x.shape).contiguous()
                                for x in state))
    imgs_dev = torch.as_tensor(imgs).to(device)[None].expand(
        (A,) + imgs.shape).contiguous()
    _log(f"cloned fleet A={A}")
    return _fleet_run(cal, config, states, imgs_dev, repeats, device)


def bench_multi_divergent(cal, config, A, repeats=3, device=None,
                          seqs=None, states=None):
    """Divergent fleet (the headline): A independent agents
    (``render_fleet``), each bootstrapped on its own first frame.  ``seqs``
    / ``states`` may hold more agents, already rendered / bootstrapped; the
    first A are taken.  (aggregate frames/s, tracked, total)."""
    device = resolve_device(device)
    seqs = render_fleet(A) if seqs is None else seqs
    if states is None:
        states = [_bootstrap_state(*s, device=device, config=config)[2]
                  for s in seqs[:A]]
    stacked = trk.TrackerState(*(torch.stack(x)
                                 for x in zip(*states[:A])))
    imgs_dev = torch.as_tensor(np.stack([s[0] for s in seqs[:A]])).to(device)
    _log(f"divergent fleet A={A}")
    return _fleet_run(cal, config, stacked, imgs_dev, repeats, device)


def lk_pair_inputs(imgs, n_tracks=384, device=None):
    """The LK section's inputs: ``n_tracks`` uniform random tracks (seed 1)
    at least 40 px inside the first frame, and the padded 3-level pyramids
    of the first two frames.  Returns (pts, pyr_a, pyr_b)."""
    device = resolve_device(device)
    H, W = imgs.shape[1:]
    rng = np.random.RandomState(1)
    pts = torch.tensor(np.stack([rng.uniform(40, W - 40, n_tracks),
                                 rng.uniform(40, H - 40, n_tracks)], 1),
                       dtype=torch.float32, device=device)
    pad = lk.lk_pad()
    pyr = lambda im: lk.build_pyramid(torch.as_tensor(im).to(device), 3,
                                      pad=pad)
    return pts, pyr(imgs[0]), pyr(imgs[1])


def bench_lk_impls(imgs, n_scan=30, repeats=3, n_tracks=384, device=None):
    """ms per ``lk_track_pyr`` call of each impl on one image pair
    (``lk_pair_inputs``): ``n_scan`` calls feeding the flow back (each
    call's input depends on the last one's output; the displacement stays
    tiny), best of ``repeats``, host clock closed by a synchronize."""
    device = resolve_device(device)
    pts, pyr_a, pyr_b = lk_pair_inputs(imgs, n_tracks, device)
    out = {}
    for impl in LK_IMPLS:
        def run():
            p = pts
            for _ in range(n_scan):
                q, _, _ = lk.lk_track_pyr(pyr_a, pyr_b, p, prepad=True,
                                          impl=impl)
                p = p + 0.001 * (q - p)
            return p

        run()
        out[impl] = _best(run, device, repeats) * 1e3 / n_scan
    return out


def lk_efficiency(lk_ms, size=(640, 480), levels=3, n_tracks=384, win=21,
                  margin=7):
    """The bytes one LK call of the ``tiled`` kernel (else ``fused``) must
    move, against the card's memory rate: per level the smaller of (every
    track's template and search region) and (both level images whole), plus
    49 bytes of corners, anchors, flag and outputs per track, as
    ``chip_smoke.lk_level_bound`` counts them."""
    ms = lk_ms.get("tiled", lk_ms.get("fused"))
    if not isinstance(ms, (int, float)):
        return {}
    pad = lk.lk_pad(win, margin)
    P = win + 2 * margin + 1
    total = 0
    for lvl in range(levels):
        Hp = (size[1] >> lvl) + 2 * pad
        Wp = (size[0] >> lvl) + 2 * pad
        region = n_tracks * ((win + 3) ** 2 + P * P) * 4
        total += min(region, 2 * Hp * Wp * 4) + n_tracks * 49
    sol_ms = total / HBM_BYTES_PER_S * 1e3
    return {"lk_bytes_moved_mb": total / 1e6, "lk_hbm_sol_ms": sol_ms,
            "lk_x_over_hbm_sol": ms / sol_ms}


def bench_triangulation(n_scan=20, repeats=3, N=65536, device=None):
    """Two-view triangulation throughput (Mpoints/s) of the four methods:
    ``n_scan`` calls, each fed a term of the last one's output, best of
    ``repeats``.  ``cv2_linear_eigen_mps`` is cv2.triangulatePoints on the
    host's CPU over the same batch, where cv2 imports."""
    device = resolve_device(device)
    rng = np.random.RandomState(3)
    X = rng.uniform(-4, 4, (N, 3)) + np.array([0, 0, 10.0])
    P1 = np.eye(4)
    P2 = np.eye(4)
    ang = 0.12
    P2[:3, :3] = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                           [-np.sin(ang), 0, np.cos(ang)]])
    P2[:3, 3] = [-5.0, 0.3, 0.2]

    def project(P):
        Xc = X @ P[:3, :3].T + P[:3, 3]
        return (Xc[:, :2] / Xc[:, 2:3]).astype(np.float32)

    u1 = project(P1) + rng.normal(0, 0.8 / 500, (N, 2)).astype(np.float32)
    u2 = project(P2) + rng.normal(0, 0.8 / 500, (N, 2)).astype(np.float32)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
    u1d, u2d, P1d, P2d = t(u1), t(u2), t(P1), t(P2)

    out = {}
    for name in ("linear_eigen", "linear_ls", "iterative_ls", "optimal"):
        method = getattr(tri, name)

        def run():
            c = torch.zeros((), device=device)
            for _ in range(n_scan):
                x, _ = method(u1d + c * 1e-30, P1d, u2d, P2d)
                c = c + torch.sum(x) * 1e-30
            return c

        run()
        out[name + "_mps"] = N * n_scan / _best(run, device, repeats) / 1e6
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        reps = 3
        t0 = time.perf_counter()
        for _ in range(reps):
            cv2.triangulatePoints(np.ascontiguousarray(P1[:3]),
                                  np.ascontiguousarray(P2[:3]),
                                  u1.T.astype(np.float64),
                                  u2.T.astype(np.float64))
        out["cv2_linear_eigen_mps"] = N * reps / (time.perf_counter() - t0) \
            / 1e6
    out["batch"] = N
    return out


def bench_ba_iters(max_iters=15, repeats=2, nr_cameras=2, nr_frames=20,
                   device=None):
    """LM iterations/s on the synthetic cube (``nr_cameras`` robots,
    ``nr_frames`` steps, odometry off), the JAX bench's ``bench_ba_iters``
    without its real dump: the device loop's entry point
    (``lm_solve_device``, the headline; in the port a wrapper of the host
    loop, so the two keys time the same loop) and the host loop
    (``lm_solve``), each after one warm-up solve, best of ``repeats``, host
    clock closed by a synchronize.
    ``ba_incremental_steps_per_s`` is None: the JAX bench gives it only on
    the reference's real SVO dump, which is not in this repo, and null on
    the cube; ``chip_smoke.py``'s ``ba_scale`` phase measures the
    incremental steps/s on the in-repo ICL dump instead.
    Returns {ba_lm_iterations_per_s, ba_lm_iterations_per_s_host_loop,
    ba_incremental_steps_per_s, ba_workload}."""
    from mqslam_tpu_torch.ba import problem as bp, solver as bs
    from mqslam_tpu_torch.ba import synthetic as bsyn
    device = resolve_device(device)
    data = bsyn.generate_cube_scenario(nr_cameras=nr_cameras,
                                       nr_frames=nr_frames)
    prob = bp.problem_from_ba_data(data, device=device)
    prob = prob._replace(odo_valid=torch.zeros_like(prob.odo_valid))
    n = {}

    def host():
        n["host"] = len(bs.lm_solve(prob, max_iters=max_iters)[1]) - 1

    def dev():
        n["dev"] = bs.lm_solve_device(prob, max_iters=max_iters)[2]

    bs.lm_solve(prob, max_iters=2)
    best_host = _best(host, device, repeats)
    bs.lm_solve_device(prob, max_iters=2)
    best_dev = _best(dev, device, repeats)
    _log(f"BA: {n['dev']} / {n['host']} LM iterations (device / host loop)")
    return {"ba_lm_iterations_per_s": max(n["dev"], 1) / best_dev,
            "ba_lm_iterations_per_s_host_loop": n["host"] / best_host,
            "ba_incremental_steps_per_s": None,
            "ba_workload": f"synthetic-cube-{nr_cameras}cam"}


def bench_corridor_cg(F=2048, ppf=24, repeats=3, device=None):
    """ms per CG iteration of ``solve_delta`` on the corridor problem (F
    poses, ``ppf`` landmarks a frame; 2048 / 24 is the JAX bench's
    production size, about 370k observations) over the banded grid, the
    packed layout and COO: the slope between a 25- and a 100-iteration
    budget, each run in full (``cg_tol=0``) from one linearization, best of
    ``repeats``, host clock closed by a synchronize.  A layout whose
    builder refuses the problem has no row."""
    from mqslam_tpu_torch.ba import solver as bs, synthetic as bsyn
    from mqslam_tpu_torch.ba.banded import build_banded_layout
    from mqslam_tpu_torch.ba.packed import build_packed_layout
    device = resolve_device(device)
    prob, _ = bsyn.generate_corridor_problem(nr_frames=F,
                                             points_per_frame=ppf,
                                             device=device)
    args = (prob.obs_pose, prob.obs_point, prob.obs_valid, prob.n_poses,
            prob.n_points)
    layouts = {"banded": build_banded_layout(*args),
               "packed": build_packed_layout(*args), "coo": None}
    lin = bs.linearize(prob, prob.init)
    out = {"F": F, "O": int(prob.obs_valid.sum()), "P": prob.n_points}
    packed, banded = layouts["packed"], layouts["banded"]
    if packed is not None:
        out.update(Kf=packed.Kf, Kp=packed.Kp)
    if banded is not None:
        out.update(banded_J=banded.J, banded_Ks=banded.Ks,
                   banded_left=banded.n_left, banded_L=banded.L)
    for name, lay in layouts.items():
        if name != "coo" and lay is None:
            _log(f"corridor CG: the {name} builder refused the problem")
            continue
        pj = bs.pack_for_layout(lin, lay) if lay is not None else None
        ts = {}
        for budget in (25, 100):
            def run():
                return bs.solve_delta(prob, lin, 1e-3, cg_iters=budget,
                                      cg_tol=0.0, layout=lay, packedJ=pj)
            run()
            ts[budget] = _best(run, device, repeats)
        per_iter = (ts[100] - ts[25]) / 75
        out[name + "_cg_iter_ms"] = per_iter * 1e3
        out[name + "_cg_iters_per_s"] = 1.0 / per_iter
    return out


def cg_efficiency(corridor):
    """The bytes one CG iteration of each layout must move, against the
    card's memory rate (the JAX bench's ``cg_efficiency`` over
    ``HBM_BYTES_PER_S``): each table the iteration reads, once, plus the
    state vectors.  Packed: the per-pose Gram, the four packed Jacobian
    tables, the two gathered state copies, the point blocks and vectors.
    Banded: the Awt and M-folded At2 tables, the dense leftover block and
    its M-folded copy, the shifted state copy and its partial sums, the CG
    vectors and the Gram.  COO: both Jacobians of every valid observation,
    its two ids, the point blocks and the vectors."""
    F, P, O = corridor["F"], corridor["P"], corridor["O"]
    out = {}

    def put(prefix, ms, by):
        if isinstance(ms, (int, float)):
            sol = by / HBM_BYTES_PER_S * 1e3
            out.update({prefix + "bytes_moved_mb": by / 1e6,
                        prefix + "hbm_sol_ms": sol,
                        prefix + "x_over_hbm_sol": ms / sol})

    if "Kf" in corridor:
        Kf, Kp = corridor["Kf"], corridor["Kp"]
        put("cg_", corridor.get("packed_cg_iter_ms"),
            F * 36 * 4                                  # Gram G_f
            + F * Kf * 12 * 4 + F * Kf * 6 * 4          # Jp_f + Jt_f (w leg)
            + P * Kp * 12 * 4 + P * Kp * 6 * 4          # Jp_p + Jt_p (wt leg)
            + P * Kp * 6 * 4 + F * Kf * 3 * 4           # vp / uf gathers
            + 2 * P * 9 * 4 + 2 * P * 3 * 4)            # Hpp blocks + vecs
    if "banded_J" in corridor:
        J, Ks, L = (corridor["banded_J"], corridor["banded_Ks"],
                    corridor["banded_L"])
        put("banded_cg_", corridor.get("banded_cg_iter_ms"),
            2 * F * J * Ks * 18 * 4                     # Awt + At2
            + 2 * F * 6 * 3 * 4                         # V pack + q
            + 2 * P * 3 * 4 + F * 36 * 4                # CG vectors + Gram
            + 2 * F * L * 18 * 4)                       # Wd + Dd
    put("coo_cg_", corridor.get("coo_cg_iter_ms"),
        O * (12 + 6) * 4 + O * 2 * 4                    # Jacobians + ids
        + P * 9 * 4 + 2 * P * 3 * 4 + 2 * F * 6 * 4)    # Hpp + vectors
    return out


def loopclosure_inputs(cap=256, K=384, N=512, device=None):
    """The JAX bench's loop-closure workloads (``bench.py:460-537``, same
    seed and draws): a full keyframe DB of ``cap`` x ``K`` random
    descriptors with one query, and the ``N``-pose circuit with an odometry
    chain and 16 closure edges.  Returns (db, q_desc, q_valid, graph)."""
    device = resolve_device(device)
    rng = np.random.RandomState(5)
    dev = lambda x: torch.as_tensor(x).to(device)
    db = lc.KeyframeDB(
        desc=dev(rng.randint(0, 256, (cap, K, 32), np.uint8)),
        desc_valid=dev(np.ones((cap, K), bool)),
        uv=dev(rng.rand(cap, K, 2).astype(np.float32) * 400),
        xyz=dev(rng.randn(cap, K, 3).astype(np.float32)),
        xyz_valid=dev(np.ones((cap, K), bool)),
        pose=dev(np.zeros((cap, 6), np.float32)),
        used=dev(np.ones(cap, bool)), count=dev(np.int32(cap)))
    q_desc = dev(rng.randint(0, 256, (K, 32), np.uint8))
    q_valid = dev(np.ones(K, bool))

    ang = np.linspace(0, 2 * np.pi, N, endpoint=False)
    centers = np.stack([np.cos(ang), np.sin(ang), 0 * ang], 1) * 4.0
    poses = np.concatenate([np.zeros((N, 3)), centers], 1)
    noisy = poses + rng.randn(N, 6) * 0.02
    ei = np.concatenate([np.arange(N - 1), np.arange(0, N, N // 16)])
    ej = np.concatenate([np.arange(1, N),
                         (np.arange(0, N, N // 16) + N // 2) % N])
    f32 = lambda x: dev(np.asarray(x, np.float32))
    i32 = lambda x: dev(np.asarray(x, np.int32))
    g = pg.PoseGraph(
        poses=f32(noisy), pose_valid=dev(np.ones(N, bool)),
        edge_i=i32(ei), edge_j=i32(ej),
        edge_meas_r=f32(np.zeros((len(ei), 3))),
        edge_meas_t=f32(centers[ej] - centers[ei]),
        edge_inv_sigma=f32(np.full((len(ei), 6), 20.0)),
        edge_valid=dev(np.ones(len(ei), bool)),
        prior_mask=dev(np.arange(N) == 0), prior_r=f32(noisy[:, :3] * 0),
        prior_t=f32(centers), prior_inv_sigma=f32(np.full((N, 6), 100.0)))
    return db, q_desc, q_valid, g


def bench_loopclosure(repeats=3, n_scan=20, cap=256, K=384, N=512,
                      device=None):
    """Loop-closure components at workload scale: keyframe-DB scorings/s
    (one query against the FULL ``cap``-keyframe DB, ``loop_scores``, the
    scores fed back into the query as the JAX bench does) and pose-graph
    LM iterations/s (``pgo_solve``, 20 iterations) on the ``N``-pose
    circuit (``loopclosure_inputs``); best of ``repeats`` after a warm-up,
    host clock closed by a synchronize."""
    device = resolve_device(device)
    db, q_desc, q_valid, g = loopclosure_inputs(cap, K, N, device=device)

    def score_scan():
        c = q_desc
        for _ in range(n_scan):
            s, _, _ = lc.loop_scores(db, c, q_valid, cur_index=cap)
            c = torch.bitwise_xor(c, (s.sum() % 2).to(torch.uint8))
        return c

    iters = 20
    with torch.no_grad():
        score_scan()
        scores_qps = n_scan / _best(score_scan, device, repeats)
        pg.pgo_solve(g, iters=iters)
        pgo_ips = iters / _best(lambda: pg.pgo_solve(g, iters=iters),
                                device, repeats)
    return {"orb_db_scores_per_s": round(scores_qps, 1),
            "db_keyframes": cap,
            "pgo_iters_per_s": round(pgo_ips, 1),
            "pgo_poses": int(g.poses.shape[0]),
            "pgo_edges": int(g.edge_i.shape[0])}


def bench_opencv_baseline(imgs, P_list, f, size, plane_z, passes=2):
    """The per-frame kernel ladder of the system the JAX package was
    modelled on, through OpenCV on the host's CPU (calcOpticalFlowPyrLK,
    solvePnPRansac, solvePnP, findHomography, goodFeaturesToTrack): the best
    frames/s of ``passes``, or None where cv2 does not import."""
    best = None
    for _ in range(passes):
        fps = _opencv_ladder_once(imgs, P_list, f, size, plane_z)
        if fps is None:
            return None
        best = fps if best is None else max(best, fps)
    return best


def _opencv_ladder_once(imgs, P_list, f, size, plane_z):
    try:
        import cv2
    except ImportError:
        return None
    K = np.array([[f, 0, size[0] / 2], [0, f, size[1] / 2], [0, 0, 1.0]])
    dist = np.zeros(4)
    img0 = imgs[0].astype(np.uint8)
    pts = cv2.goodFeaturesToTrack(img0, 300, 0.01, 12).reshape(-1, 2)
    objp = synthetic.backproject_to_plane(pts, P_list[0], f,
                                          (size[0] / 2, size[1] / 2),
                                          plane_z).astype(np.float32)
    prev = img0
    prev_pts = pts.astype(np.float32)
    t0 = time.perf_counter()
    n = 0
    for i in range(1, imgs.shape[0]):
        cur = imgs[i].astype(np.uint8)
        new_pts, st, err = cv2.calcOpticalFlowPyrLK(prev, cur, prev_pts,
                                                    None)
        ok = (st.reshape(-1) == 1) & (err.reshape(-1) < 12)
        if ok.sum() >= 8:
            sel = np.flatnonzero(ok)
            try:
                _, rvec, tvec, inl = cv2.solvePnPRansac(
                    objp[sel], new_pts[sel], K, dist, reprojectionError=2.0)
                if inl is not None and len(inl) >= 8:
                    cv2.solvePnP(objp[sel][inl.reshape(-1)],
                                 new_pts[sel][inl.reshape(-1)], K, dist,
                                 rvec, tvec, useExtrinsicGuess=True)
            except cv2.error:
                pass
            cv2.findHomography(prev_pts[sel], new_pts[sel])
        cv2.goodFeaturesToTrack(cur, 50, 0.01, 12)  # refill detection
        prev, prev_pts = cur, new_pts
        n += 1
    return n / (time.perf_counter() - t0)


def summary(scaling, cloned, fps1, lk_ms, tri_mps, eff, base, device_info,
            ba, corridor, loop):
    """The JSON line: the headline is the best point of the divergent
    sweep; ``ba`` is ``bench_ba_iters``'s dict, ``corridor``
    ``bench_corridor_cg``'s, ``loop`` ``bench_loopclosure``'s."""
    best_A = max(scaling, key=lambda k: scaling[k])
    headline = scaling[best_A]
    return {
        "metric": METRIC,
        "value": headline,
        "unit": "frames/s",
        "vs_baseline": headline / base,
        "extra": {
            "best_A": best_A,
            "agents_scaling_fps": {str(k): v for k, v in scaling.items()},
            "cloned_agents_fps": {str(k): v for k, v in cloned.items()},
            "single_agent_vs_cv2": fps1 / base,
            **ba,
            "lk_per_call_ms": lk_ms,
            "triangulation_mpts_per_s": tri_mps,
            "corridor_cg": corridor,
            "loop_closure": loop,
            "efficiency": eff,
            "cv2_ladder_fps_host": base,
            "device": device_info,
        },
    }


def _device_info(device):
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        smi = []
    return {"kind": torch.cuda.get_device_name(device),
            "count": torch.cuda.device_count(),
            "nvidia_smi": smi[0].strip() if smi else "unknown",
            "torch": torch.__version__, "cuda": torch.version.cuda}


def main():
    device = resolve_device(None)
    _log("rendering the single-agent sequence and the 32-agent fleet")
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        fleet = ex.submit(render_fleet, 32)
        imgs, P_list, f, size, plane_z = synthetic.build_sequence()
        seqs = fleet.result()

    cal, config, state = _bootstrap_state(imgs, P_list, f, size, plane_z,
                                          device=device)
    fps1, ok1, n1 = bench_single(cal, config, state, imgs, device=device)
    _log(f"single-agent: {fps1:.2f} frames/s ({ok1}/{n1} tracked)")

    states = [_bootstrap_state(*s, device=device, config=config)[2]
              for s in seqs]
    scaling = {1: fps1}
    for A in (2, 4, 8, 16, 32):
        fpsA, okA, nA = bench_multi_divergent(cal, config, A, device=device,
                                              seqs=seqs, states=states)
        scaling[A] = fpsA
        _log(f"A={A} divergent: {fpsA:.2f} aggregate frames/s "
             f"({okA}/{nA} tracked)")
        if okA < nA:  # tracking broke down: no bogus point
            _log(f"A={A}: only {okA}/{nA} tracked; stopping the sweep")
            break

    cloned = {}
    for A in (8, 16):
        fpsA, okA, nA = bench_multi(cal, config, state, imgs, A,
                                    device=device)
        cloned[A] = fpsA
        _log(f"A={A} cloned: {fpsA:.2f} aggregate frames/s "
             f"({okA}/{nA} tracked)")

    lk_ms = bench_lk_impls(imgs, device=device)
    _log(f"LK ms per call: {lk_ms}")
    tri_mps = bench_triangulation(device=device)
    _log(f"triangulation Mpoints/s: {tri_mps}")
    corridor = bench_corridor_cg(device=device)
    _log(f"corridor CG: {corridor}")
    eff = lk_efficiency(lk_ms)
    eff.update(cg_efficiency(corridor))
    _log(f"LK and CG against the memory bound: {eff}")
    ba = bench_ba_iters(device=device)
    _log(f"BA: {ba}")
    loop = bench_loopclosure(device=device)
    _log(f"loop closure: {loop}")

    base = bench_opencv_baseline(imgs, P_list, f, size, plane_z)
    if base is None:
        base = 30.0
        _log("cv2 does not import: baseline = 30 frames/s (real time)")
    else:
        _log(f"baseline: cv2 ladder {base:.2f} frames/s on the host's CPU")
    print(json.dumps(summary(scaling, cloned, fps1, lk_ms, tri_mps, eff,
                             base, _device_info(device), ba, corridor,
                             loop)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
