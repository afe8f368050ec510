#!/usr/bin/env python3
"""Where the port's paths spend a frame-group on the GPU.

    python3 prof_torch_multi.py [--groups 3]
    python3 prof_torch_multi.py --single [--groups 8]

Runs ``mqslam_tpu_torch``'s multi-agent runner at full width (16 divergent
agents, 640x480, TrackerConfig() defaults, the fleet of ``chip_smoke.py``)
under ``torch.profiler`` for a few frame-groups after a warm-up run, and
prints one JSON object: wall time of the window with and without the
profiler, the device's busy time and its idle share of the unprofiled wall
time, kernel launches per frame-group, and the kernels that take the most
device time.  With ``--single`` the window is the single-agent path instead:
``run_frontend`` over ``--groups`` tracked 1280x720 frames of
``chip_smoke.py``'s single sequence (its first frames), its bootstrap on
frame 0 included (a frame-group is then one frame).  Needs a CUDA device;
imports only the port.
"""

import argparse
import json
import sys
import time

import torch

import chip_smoke


def lk_on_path_inputs(run, states, imgs, device):
    """The tile kernel's level calls of one frame-group of the window,
    recorded, then timed alone per launch from a CUDA graph (caches warm)
    and with the L2 cache flushed before each launch, beside the valid
    tracks and the Newton steps those inputs take (plain version): what the
    profiled time per launch on the path is made of."""
    from mqslam_tpu_torch.ops import lk_tile
    calls = chip_smoke.record_level_calls(lk_tile, lambda: run(
        states, imgs, generator=torch.Generator(device=device).manual_seed(1)))
    flush = torch.empty(64 << 20, dtype=torch.float32, device=device)
    out = []
    for a, we in calls:
        call = lambda: lk_tile.lk_level(*a, want_err=we)
        n_it = lk_tile.lk_level_plain(*a, want_err=we, return_iters=True)[3]
        out.append(dict(
            shape=list(a[0].shape), valid=int((a[6] != 0).sum()),
            newton_steps=int(n_it.sum()),
            graph_ms=chip_smoke.time_graph_ms(call),
            l2_flushed_ms=chip_smoke.time_each_ms(call, flush=flush)))
    return dict(levels=out, graph_ms_per_launch=sum(
        x["graph_ms"] for x in out) / len(out), l2_flushed_ms_per_launch=sum(
        x["l2_flushed_ms"] for x in out) / len(out))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--groups", type=int, default=None,
                    help="frame-groups inside the profiled window (default "
                         "3, with --single 8)")
    ap.add_argument("--single", action="store_true",
                    help="profile the single-agent run_frontend instead")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    if args.groups is None:
        args.groups = 8 if args.single else 3
    if not torch.cuda.is_available():
        print("prof_torch_multi: needs a CUDA device", file=sys.stderr)
        return 1
    from mqslam_tpu_torch import csrc
    from mqslam_tpu_torch.frontend import tracker as trk
    from mqslam_tpu_torch.frontend.runner import run_frontend
    from torch.profiler import ProfilerActivity, profile

    device = torch.device("cuda")
    csrc.build_all()
    config = trk.TrackerConfig()
    if args.single:
        # the first frames of the smoke script's sequence, at its motion
        seq = chip_smoke._render_agent(dict(
            chip_smoke.SINGLE, frames=slice(0, args.groups + 1)))
        cal = chip_smoke.calibration(seq, device)
        uv0, objp = chip_smoke.init_correspondences(seq, device)

        def window():
            """The same frames from the same bootstrap and draws each
            time."""
            g = torch.Generator(device=device).manual_seed(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = run_frontend(list(seq[0]), cal, config, uv0, objp,
                               generator=g, collect_ba=True, device=device)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3, \
                torch.tensor(res.accepted[1:])[:, None]

        window()                                   # warm-up
    else:
        n_warm = 4
        seqs, _ = chip_smoke.render_all(16, n_warm + args.groups + 1,
                                        (640, 480), 500.0)
        cal, states, imgs = chip_smoke.bootstrap_fleet(seqs, config, device)
        imgs = torch.as_tensor(imgs).to(device)
        run = trk.make_multi_agent_runner(cal, config, device=device)
        gen = torch.Generator(device=device).manual_seed(0)
        states, _ = run(states, imgs[:, :n_warm + 1], generator=gen)
        torch.cuda.synchronize()

        def window():
            """The same frame-groups from the same state and draws each
            time."""
            g = torch.Generator(device=device).manual_seed(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, (acc, _, _) = run(states, imgs[:, n_warm:], generator=g)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3, acc

    # the profiler slows the host, and the host sets this path's pace: the
    # idle share is taken against the window's wall time without it
    wall_ms = min(window()[0], window()[0])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled_wall_ms, acc = window()

    # device rows only: an operator row repeats its kernels' device time
    from torch.autograd import DeviceType
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
    rows = [(e.key, dev_us(e), e.count) for e in prof.key_averages()
            if dev_us(e) > 0 and e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows) / 1e3
    n_kernels = sum(r[2] for r in rows)
    path_inputs = None if args.single else lk_on_path_inputs(
        run, states, imgs[:, n_warm:n_warm + 2], device)
    smi = chip_smoke.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(json.dumps({
        "device": smi,
        "path": "single_agent" if args.single else "multi_agent",
        "frame_groups": args.groups,
        "keyframe_groups": int((acc == 2).any(dim=1).sum()),
        "wall_ms_per_frame_group": wall_ms / args.groups,
        "device_busy_ms_per_frame_group": busy_ms / args.groups,
        "profiled_wall_ms_per_frame_group": profiled_wall_ms / args.groups,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_idle_share_under_profiler": 1.0 - busy_ms / profiled_wall_ms,
        "device_ops_per_frame_group": n_kernels / args.groups,
        "lk_kernel_device_ms_per_frame_group": sum(
            us for k, us, _ in rows
            if "lk_level" in k or "lk_strip" in k) / 1e3 / args.groups,
        # each level kernel's own time per launch on the path (profiled)
        "lk_kernel_ms_per_launch": {
            k[:80]: us / 1e3 / c for k, us, c in rows
            if "lk_level" in k or "lk_strip" in k},
        "lk_path_inputs": path_inputs,
        "note": "wall_ms and device_idle_share: the window without the "
                "profiler (best of 2); busy time: the profiled window; "
                "lk_path_inputs: the tile kernel on the window's first "
                "frame-group's own level calls, alone",
        "top": [{"name": k[:80], "device_ms_per_frame_group":
                 us / 1e3 / args.groups, "calls_per_frame_group":
                 c / args.groups} for k, us, c in rows[:args.top]],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
