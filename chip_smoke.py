#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on a GPU.

    python3 chip_smoke.py

Needs one CUDA device (exits non-zero without one), the CUDA toolkit's
``nvcc`` and nothing else; imports only ``mqslam_tpu_torch``.  It

  1. builds every kernel under ``mqslam_tpu_torch/csrc/`` from source,
  2. holds each kernel against its plain PyTorch version on the card, at the
     shapes the main path gives it, and times both beside the kernel's bound,
  3. drives the main path — ``make_multi_agent_runner`` at full width: 16
     divergent agents, 640x480, 33 frames, ``TrackerConfig()`` defaults —
     with the launch counts set to 0 just before and read just after,
  4. runs the port on the card against itself on the CPU at a small size.

Every phase must pass; the last line of the output is
``{"ok": true, "device": {...}}``.  One JSON object per line before it.
"""

import concurrent.futures
import json
import multiprocessing
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12       # H100 SXM data sheet, outside the tensor cores

T0 = time.perf_counter()


def log(msg):
    print(f"[chip_smoke +{time.perf_counter() - T0:6.1f}s] {msg}",
          file=sys.stderr, flush=True)


def emit(obj):
    print(json.dumps(obj), flush=True)


class PhaseFailed(Exception):
    pass


def require(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


# ----------------------------------------------------------------- inputs --

def _render_agent(args):
    """One agent's sequence (runs in a worker process; NumPy only)."""
    from mqslam_tpu_torch.frontend import synthetic
    return synthetic.build_sequence(**args)


def render_fleet(A, n_frames, size, f, plane_z=4.0, workers=8):
    """``synthetic.build_divergent_fleet`` with the agents rendered in
    parallel worker processes (the host-side long pole of this script)."""
    from mqslam_tpu_torch.frontend import synthetic
    jobs = synthetic.divergent_fleet_params(A, n_frames, size, f, plane_z)
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=min(workers, A), mp_context=ctx) as pool:
        return list(pool.map(_render_agent, jobs))


def bootstrap_fleet(seqs, config, device):
    """Each agent bootstrapped on its own first frame: corners from the
    port's detector, 3D points by back-projection onto the known plane."""
    from mqslam_tpu_torch import convert
    from mqslam_tpu_torch.frontend import synthetic, tracker as trk
    from mqslam_tpu_torch.ops import features

    _, _, f, size, plane_z = seqs[0]
    cal = convert.cal_from_numpy(
        [f, f, 0.0, size[0] / 2, size[1] / 2, 0, 0, 0, 0], device=device)
    states = []
    for imgs, P_list, *_ in seqs:
        img0 = torch.as_tensor(imgs[0]).to(device)
        uv, valid = features.detect_corners(img0, max_corners=160, cell=14)
        uv = uv[valid][:128].cpu().numpy()
        objp = synthetic.backproject_to_plane(
            uv, P_list[0], f, (size[0] / 2, size[1] / 2), plane_z)
        states.append(trk.bootstrap(uv.astype(np.float32),
                                    objp.astype(np.float32), cal, imgs[0],
                                    config, device=device))
    stacked = trk.TrackerState(*(torch.stack(x) for x in zip(*states)))
    imgs = np.stack([s[0] for s in seqs])
    return cal, stacked, imgs


# ---------------------------------------------------------------- kernels --

def time_ms(fn, reps=20, rounds=5, warmup=3):
    """Device milliseconds per call: ``reps`` calls back to back between one
    pair of CUDA events (the device stays busy, so the host's launch gaps
    are not counted), median over ``rounds``."""
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return statistics.median(out)


def time_each_ms(fn, reps=20, warmup=1, flush=None):
    """Median milliseconds of ``reps`` calls, each between its own pair of
    CUDA events (host gaps inside a call count: right for a function that
    synchronizes).  ``flush``, a tensor larger than the L2 cache, is
    overwritten before every timed call so the call finds the cache cold;
    the overwrite also lets the host run ahead of the device, so a short
    kernel's launch latency is hidden as in the back-to-back timing."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def lk_level_bound(args, n_it):
    """Least time for one level on these inputs: (ms, by, working).

    Bytes: every input read once, every output written once — the images
    count as the smaller of (the regions the valid tracks touch) and (both
    atlas levels whole).  Operations: the lerps, gradients, structure
    tensor, the Newton steps this input actually took, and the error."""
    imgJ, _, cJ, _, _, _, valid, A, win, _, _, hiX, want_err = args
    from mqslam_tpu_torch.ops import lk_tile
    P = lk_tile.search_side(win, hiX)
    T = cJ.shape[0]
    n_valid = int((valid != 0).sum())
    region_b = n_valid * ((win + 3) ** 2 + P * P) * 4
    atlas_b = 2 * imgJ.numel() * 4
    io_b = T * (2 * 8 + 2 * 8 + 1 + 8 + 4 + 4)
    nbytes = min(region_b, atlas_b) + io_b
    W2 = win + 2
    per_track = 3 * W2 * (W2 + 1) + 3 * W2 * W2 + 10 * win * win + 16
    per_iter = 14 * win * win + 12
    flops = (n_valid * (per_track + (11 * win * win if want_err else 0))
             + int(n_it.sum()) * per_iter)
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = flops / FP32_FLOP_PER_S * 1e3
    working = dict(n_valid=n_valid, region_bytes=region_b,
                   atlas_bytes=atlas_b, io_bytes=io_b, bytes=nbytes,
                   flops=flops, newton_steps=int(n_it.sum()),
                   bytes_ms=b_ms, operations_ms=o_ms)
    return max(b_ms, o_ms), ("bytes" if b_ms >= o_ms else "operations"), \
        working


def phase_kernels(states, imgs, config):
    """K1 (lk_level) against its plain version at the main path's shapes:
    the three level calls of one frame-group's LK, inputs recorded from
    ``lk_track_pyr`` on two consecutive rendered frames, with inactive and
    NaN-poisoned slots."""
    from mqslam_tpu_torch.ops import lk, lk_tile

    A, K = states.active.shape
    pad = lk.lk_pad(config.lk_win)
    dev = states.active.device
    atlas = lambda im: [l.reshape(-1, l.shape[-1]) for l in lk.build_pyramid(
        torch.as_tensor(im).to(dev), config.lk_levels, pad=pad)]
    uv = states.cur_uv.clone()
    uv[~states.active] = float("nan")     # never-initialised slots
    recorded = []
    real = lk_tile.lk_level

    def recorder(*args, **kw):
        recorded.append(args + (kw["want_err"],))
        return real(*args, **kw)

    lk_tile.lk_level = recorder
    try:
        lk.lk_track_pyr(atlas(imgs[:, 0]), atlas(imgs[:, 1]),
                        uv.reshape(A * K, 2), states.active.reshape(A * K),
                        win=config.lk_win, prepad=True, atlas_tiles=A,
                        atlas_contiguous=True)
    finally:
        lk_tile.lk_level = real
    torch.cuda.synchronize()
    require(len(recorded) == config.lk_levels, "expected one call per level")

    levels = []
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MB
    for args in recorded:
        call = lambda fn: fn(*args[:-1], want_err=args[-1])
        a_k, eig_k, err_k = call(lk_tile.lk_level)
        torch.cuda.synchronize()
        a_p, eig_p, err_p, n_it = lk_tile.lk_level_plain(
            *args[:-1], want_err=args[-1], return_iters=True)
        ok = args[6] != 0
        bad = ~ok
        # skipped tracks: a0 passed through bit for bit (NaN included)
        same = (a_k[bad] == args[5][bad]) | (a_k[bad].isnan()
                                             & args[5][bad].isnan())
        require(bool(same.all()) and bool((eig_k[bad] == 0).all())
                and bool((err_k[bad] == 0).all()),
                "skipped tracks must return a0, 0, 0")
        require(bool(torch.isfinite(a_k[ok]).all()), "non-finite anchors")
        d_a = float((a_k[ok] - a_p[ok]).abs().max())
        d_eig = float(((eig_k[ok] - eig_p[ok]).abs()
                       / eig_p[ok].abs().clamp(min=1e-6)).max())
        d_err = float((err_k[ok] - err_p[ok]).abs().max())
        # Tolerances: the kernel sums the 441 window terms lane-strided and
        # by warp shuffle, the plain version row by row, and nvcc contracts
        # the lerps into FMAs — so b, G and err differ in the last bits, a
        # Newton step by ~1e-4 px, and a track sitting at |step| = eps may
        # take one step more or less (<= eps = 1e-2 px apart; 2e-3 holds in
        # practice because the extra step is itself below eps and shrinks
        # quadratically).
        require(d_a <= 2e-3, f"a_final differs by {d_a} px")
        require(d_eig <= 1e-4, f"min_eig differs by {d_eig} (relative)")
        require(d_err <= 1e-2, f"err differs by {d_err}")
        bound_ms, by, working = lk_level_bound(args, n_it)
        ms = time_ms(lambda: call(lk_tile.lk_level))
        cold_ms = time_each_ms(lambda: call(lk_tile.lk_level), flush=flush)
        plain_ms = time_each_ms(lambda: call(lk_tile.lk_level_plain))
        levels.append(dict(
            shape=[int(x) for x in args[0].shape], T=int(args[2].shape[0]),
            valid=int(ok.sum()), want_err=bool(args[-1]),
            max_abs_err=d_a, min_eig_rel=d_eig, err_abs=d_err, ms=ms,
            ms_l2_flushed=cold_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
            bound_working=working))
        log(f"lk_level {levels[-1]['shape']}: kernel {ms:.4f} ms "
            f"({cold_ms:.4f} L2-flushed), plain "
            f"{plain_ms:.2f} ms, bound {bound_ms:.4f} ms ({by}), "
            f"|da| {d_a:.2e}")
    tot = lambda k: sum(l[k] for l in levels)
    return dict(
        name="lk_level", route="cuda",
        source="mqslam_tpu_torch/csrc/lk_level.cu",
        replaces="mqslam_tpu/ops/lk_tile_pallas.py:234",
        launches=None, max_abs_err=max(l["max_abs_err"] for l in levels),
        ms=tot("ms"), ms_l2_flushed=tot("ms_l2_flushed"),
        plain_ms=tot("plain_ms"), bound_ms=tot("bound_ms"),
        bound_by=max(levels, key=lambda l: l["bound_ms"])["bound_by"],
        library_ms=None,
        note="ms / plain_ms / bound_ms are sums over the three level calls "
             "of one frame-group (T = 6144 tracks, 16 tiles); ms: 20 "
             "launches back to back, median of 5 rounds; plain_ms and "
             "ms_l2_flushed: median of 20 single calls; tolerances: "
             "a_final 2e-3 px, min_eig 1e-4 relative, err 1e-2",
        levels=levels)


# -------------------------------------------------------------- main path --

def camera_centers(rvec, tvec):
    from mqslam_tpu_torch.core import so3
    R = so3.exp(rvec)
    return -(R.transpose(-1, -2) @ tvec[..., None])[..., 0]


def phase_main_path(cal, config, states, imgs, seqs, device):
    from mqslam_tpu_torch.frontend import tracker as trk
    from mqslam_tpu_torch.ops import lk_tile

    A, n = imgs.shape[0], imgs.shape[1] - 1
    imgs_dev = torch.as_tensor(imgs).to(device)
    gen = lambda: torch.Generator(device=device).manual_seed(0)
    run = trk.make_multi_agent_runner(cal, config, device=device)

    lk_tile.launches = 0
    final, (acc, rvec, tvec) = run(states, imgs_dev, generator=gen())
    torch.cuda.synchronize()
    launches = lk_tile.launches
    require(launches == config.lk_levels * n,
            f"lk_level launched {launches} times, expected "
            f"{config.lk_levels * n}")
    require(bool(torch.isfinite(rvec).all() and torch.isfinite(tvec).all()),
            "non-finite pose")
    require(acc.shape == (n, A) and tvec.shape == (n, A, 3), "output shape")
    acc_np = acc.cpu().numpy()
    tracked = int((acc_np > 0).sum())
    require(tracked >= 0.9 * A * n,
            f"tracked {tracked} of {A * n} frames (< 90 %)")
    # the repo's own means: the estimated camera centres against the known
    # trajectory of the synthetic world (metric, no alignment needed)
    c_est = camera_centers(rvec, tvec).cpu().numpy()           # [n, A, 3]
    P_gt = np.stack([s[1] for s in seqs])[:, 1:]               # [A, n, 4, 4]
    c_gt = -np.einsum("anji,anj->ani", P_gt[..., :3, :3], P_gt[..., :3, 3])
    err = np.linalg.norm(c_est - c_gt.transpose(1, 0, 2), axis=-1)
    err_ok = err[acc_np > 0]
    rmse = float(np.sqrt((err_ok ** 2).mean()))
    require(rmse < 0.05, f"camera-centre RMSE {rmse} m vs ground truth")

    # timing: host clock around whole runs that end in a synchronize
    def timed(stage_ms=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, (acc2, _, _) = run(states, imgs_dev, generator=gen(),
                              stage_ms=stage_ms)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        require(torch.equal(acc2, acc), "a repeated run changed results")
        return dt

    seconds = min(timed(), timed())
    stage_ms = {}
    timed(stage_ms)
    return dict(
        agents=A, size=[int(imgs.shape[3]), int(imgs.shape[2])], frames=n + 1,
        frame_groups=n, max_tracks=config.max_tracks,
        max_landmarks=config.max_landmarks,
        ransac_hypotheses=config.ransac_hypotheses,
        tracked=tracked, total=A * n, keyframes=int((acc_np == 2).sum()),
        keyframe_groups=int((acc_np == 2).any(axis=1).sum()),
        landmarks=[int(x) for x in final.n_objp.cpu()],
        camera_centre_rmse_m=rmse, camera_centre_max_m=float(err_ok.max()),
        aggregate_frames_per_s=A * n / seconds, seconds=seconds,
        stage_ms_per_frame_group={k: v / n for k, v in stage_ms.items()},
        launches={"lk_level": launches}), launches


def phase_cuda_vs_cpu(device):
    """The port on the card against itself on the CPU: A = 2, 320x240,
    128 tracks, 6 frames, the same injected RANSAC draws."""
    from mqslam_tpu_torch.frontend import tracker as trk

    config = trk.TrackerConfig(max_tracks=128, target_keypoints=100)
    seqs = render_fleet(2, 6, (320, 240), 250.0, workers=2)
    scores = np.random.RandomState(0).uniform(
        size=(5, 2, config.ransac_hypotheses, config.max_tracks)
    ).astype(np.float32)
    res = {}
    for dev in ("cpu", device):
        cal, states, imgs = bootstrap_fleet(seqs, config, dev)
        run = trk.make_multi_agent_runner(cal, config, device=dev)
        _, outs = run(states, imgs, ransac_scores=scores)
        res[str(dev)] = [x.cpu().numpy() for x in outs]
    (acc_c, rv_c, tv_c), (acc_g, rv_g, tv_g) = res["cpu"], res[str(device)]
    require((acc_c == acc_g).all(), f"accepted differs: {acc_c} vs {acc_g}")
    require((acc_c > 0).all(), f"rejected frames on the clean pair: {acc_c}")
    d_t = float(np.abs(tv_c - tv_g).max())
    d_r = float(np.abs(rv_c - rv_g).max())
    # same arithmetic; the kernel's sums run in another order than the
    # plain version's, and RANSAC picks the same sets from the same draws
    require(d_t <= 2e-3 and d_r <= 2e-3, f"poses differ: {d_t}, {d_r}")
    return dict(agents=2, size=[320, 240], frames=6,
                accepted=acc_g.tolist(), tvec_max_abs_diff=d_t,
                rvec_max_abs_diff=d_r, atol=2e-3)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); this script runs on a GPU only", file=sys.stderr)
        return 1
    from mqslam_tpu_torch import csrc
    from mqslam_tpu_torch.frontend import tracker as trk

    device = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    smi = smi[0].strip() if smi else "unknown"

    log("rendering the 16-agent fleet (host, NumPy) while nvcc runs")
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        build = ex.submit(csrc.build_all)
        seqs = render_fleet(16, 33, (640, 480), 500.0)
        logs = build.result()
    for name, text in logs.items():
        log(f"nvcc {name}.cu:\n{text.strip()}")
    emit({"device": {
        "nvidia_smi": smi, "kind": torch.cuda.get_device_name(0),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "python": sys.version.split()[0], "kernels_built": sorted(logs),
        "kernel_build_seconds": csrc.last_build_seconds}})
    print(smi, flush=True)

    config = trk.TrackerConfig()
    try:
        log("bootstrapping 16 agents")
        cal, states, imgs = bootstrap_fleet(seqs, config, device)
        log("phase kernels")
        k1 = phase_kernels(states, imgs, config)
        log("phase main_path")
        main_path, launches = phase_main_path(cal, config, states, imgs,
                                              seqs, device)
        k1["launches"] = launches
        emit({"kernels": [k1]})
        emit({"main_path": main_path})
        log("phase cuda_vs_cpu")
        emit({"cuda_vs_cpu": phase_cuda_vs_cpu(device)})
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log("done")
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
