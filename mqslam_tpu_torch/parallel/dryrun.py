"""Multi-process dry run of the collaborative pipeline (BASELINE config #5).

    python -m mqslam_tpu_torch.parallel.dryrun --procs N --backend gloo|nccl

spawns N ranks (gloo: CPU tensors; nccl: rank r on ``cuda:r``, one GPU a
rank, since NCCL refuses two ranks on one card) over a fresh
``tcp://127.0.0.1`` port, and in each:

1. the fleet front-end split across ranks (``parallel.fleet``: max(2, N)
   agents, rank r tracking its share; no collectives), 9 frames at
   320x240, the RANSAC draws injected from one seeded stream so that the
   split does not change them;
2. each rank's per-agent BA dumps (``multiagent.fleet_dump``) gathered on
   every rank (``all_gather_object``), merged with rendezvous cross-factors
   between agents a and a + 1 every 4th frame (``multiagent.merge``);
3. the joint graph solved by ``sharded_lm_solve`` over the group, held
   within 5e-3 relative of the single-process ``lm_solve(method="cg")``,
   and the mean ATE must improve from front-end to joint;
4. the corridor at F = 256 on the sharded packed layout against the
   single-process solve (5e-3), and the 2-robot cube (cross-camera
   odometry) likewise.

The counterpart of ``__graft_entry__.py::dryrun_multichip`` and
``_fleet_pipeline_stage``.  Rank 0 prints one JSON line of figures; the
exit code is 0 when every rank passed every check.
"""

import argparse
import json
import multiprocessing
import queue
import sys
import time

import numpy as np

TIMEOUT_S = 600


def _require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def fleet_pipeline_stage(group, device, A, n_frames=9, size=(320, 240),
                         f=280.0, plane_z=4.0):
    """Fleet -> dumps -> merge -> joint sharded BA over ``group``; the
    figures as a dict.  Raises RuntimeError when a check fails."""
    import torch
    import torch.distributed as dist

    from mqslam_tpu_torch import convert
    from mqslam_tpu_torch.ba import problem as bp, solver as bs
    from mqslam_tpu_torch.cli.collab_demo import (_traj, gt_traj,
                                                  traj_from_vars)
    from mqslam_tpu_torch.eval import ate as ate_mod
    from mqslam_tpu_torch.frontend import synthetic, tracker as trk
    from mqslam_tpu_torch.io import tum
    from mqslam_tpu_torch.io.nputil import matrix_to_quat_np
    from mqslam_tpu_torch.multiagent import (CrossOdometry, ba_data_from_scan,
                                             merge_agents, scan_to_host)
    from mqslam_tpu_torch.ops import features
    from mqslam_tpu_torch.parallel import sharded_lm_solve
    from mqslam_tpu_torch.parallel.fleet import make_fleet_runner

    rank, world = dist.get_rank(group), dist.get_world_size(group)
    rng = np.random.RandomState(11)
    cal = convert.cal_from_numpy(
        [f, f, 0.0, size[0] / 2, size[1] / 2, 0, 0, 0, 0], device=device)
    config = trk.TrackerConfig(max_tracks=128, max_landmarks=1024,
                               target_keypoints=90, ransac_hypotheses=64)
    tex = synthetic.make_texture(rng)

    gt, states, img_stacks = [], [], []
    for a in range(A):
        sgn = 1.0 if a % 2 == 0 else -1.0
        g = _traj(n_frames, [0.3 * a, 0.05 * (a % 3), 0.0],
                  [sgn * 0.8, 0.1, 0.12 + 0.02 * (a % 2)],
                  sgn * (0.05 + 0.01 * (a % 4)))
        gt.append(g)
        imgs = synthetic.render_plane_sequence(g, tex, size=size, f=f,
                                               plane_z=plane_z)
        uv, valid = features.detect_corners(
            torch.as_tensor(imgs[0], dtype=torch.float32, device=device),
            max_corners=80, cell=14)
        uv = uv[valid][:64].cpu().numpy()
        objp = synthetic.backproject_to_plane(
            uv, g[0], f, (size[0] / 2, size[1] / 2), plane_z)
        states.append(trk.bootstrap(uv.astype(np.float32),
                                    objp.astype(np.float32), cal, imgs[0],
                                    config, device=device))
        img_stacks.append(imgs)
    init = trk.TrackerState(*(torch.stack(x) for x in zip(*states)))
    imgs_a = torch.as_tensor(np.stack(img_stacks), device=device)
    scores = torch.as_tensor(np.random.RandomState(12).rand(
        n_frames - 1, A, config.ransac_hypotheses, config.max_tracks
    ).astype(np.float32), device=device)

    fleet = make_fleet_runner(cal, config, group, collect=True, device=device)
    t0 = time.perf_counter()
    final, outs = fleet(init, imgs_a, ransac_scores=scores)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    fleet_s = time.perf_counter() - t0
    lo = rank * A // world
    local_init = trk.TrackerState(*(x[lo:lo + A // world] for x in init))
    h_init, h_final, h_outs = scan_to_host(local_init, final, outs)
    acc = h_outs[0]
    _require((acc > 0).all(), f"rank {rank}: fleet rejected frames: {acc}")
    mine = [ba_data_from_scan(h_init, h_final, h_outs, cal, a)
            for a in range(A // world)]
    gathered = [None] * world
    dist.all_gather_object(gathered, mine, group=group)
    datas = [d for part in gathered for d in part]

    cross = []
    for fidx in range(0, n_frames, 4):
        for a in range(A - 1):
            Wa = np.linalg.inv(gt[a][fidx])
            Wb = np.linalg.inv(gt[a + 1][fidx])
            cross.append(CrossOdometry(
                step=fidx, from_agent=a, from_frame=fidx, to_agent=a + 1,
                to_frame=fidx, measured=np.linalg.inv(Wa) @ Wb,
                sigmas=np.array([0.002] * 3 + [0.004] * 3)))
    merged = merge_agents(datas, cross_odometry=cross)
    prob = bp.problem_from_ba_data(merged, pad_multiple=world, device=device)
    O_valid = int(prob.obs_valid.sum())

    t0 = time.perf_counter()
    v_joint, hist = sharded_lm_solve(prob, group, max_iters=20, cg_iters=200)
    joint_s = time.perf_counter() - t0
    rep = dict(agents=A, ranks=world, fleet_seconds=fleet_s,
               keyframes=int((acc == 2).sum()), steps=merged.nr_steps,
               landmarks=len(merged.points3D), O=O_valid,
               cross_factors=len(cross), joint_history=[hist[0], hist[-1]],
               joint_iterations=len(hist) - 1, joint_seconds=joint_s)
    if rank == 0:
        _, hist_1d = bs.lm_solve(prob, max_iters=20, cg_iters=200,
                                 method="cg")
        rel = abs(hist[-1] - hist_1d[-1]) / max(abs(hist_1d[-1]), 1e-12)
        _require(rel < 5e-3, f"joint fleet BA left the single-process "
                 f"basin: {hist[-1]:.6e} vs {hist_1d[-1]:.6e}")
        S = merged.nr_steps
        fe, joint = [], []
        for a in range(A):
            g = gt_traj(gt[a])
            Ps = [n[0] for n in datas[a].poses[0]]
            fe_traj = tum.CamTrajectory(
                np.arange(n_frames) / 30.0, np.stack([p[:3, 3] for p in Ps]),
                np.stack([matrix_to_quat_np(p[:3, :3]) for p in Ps]))
            fe.append(ate_mod.evaluate_ate(fe_traj, g,
                                           max_difference=1e-3).rmse)
            joint.append(ate_mod.evaluate_ate(
                traj_from_vars(v_joint, a, S, merged), g,
                max_difference=1e-3).rmse)
        fe_m, joint_m = float(np.mean(fe)), float(np.mean(joint))
        _require(joint_m < fe_m, f"joint BA did not improve the mean fleet "
                 f"ATE: {fe_m:.4f} -> {joint_m:.4f}")
        rep.update(single_process_rel=rel, ate_front_end_m=fe_m,
                   ate_joint_m=joint_m)
    return rep


def _single_vs_sharded(prob, group, layout, max_iters, cg_iters):
    """(sharded history, single-process history or None off rank 0)."""
    import torch.distributed as dist
    from mqslam_tpu_torch.ba import solver as bs
    from mqslam_tpu_torch.parallel import sharded_lm_solve
    _, hist = sharded_lm_solve(prob, group, max_iters=max_iters,
                               cg_iters=cg_iters, layout=layout)
    if dist.get_rank(group):
        return hist, None
    _, hist_1d = bs.lm_solve(prob, max_iters=max_iters, cg_iters=cg_iters,
                             method="cg")
    rel = abs(hist[-1] - hist_1d[-1]) / max(abs(hist_1d[-1]), 1e-12)
    _require(np.isfinite(hist[-1]) and rel < 5e-3,
             f"sharded LM left the single-process basin: {hist[-1]:.6e} vs "
             f"{hist_1d[-1]:.6e} (rel {rel:.2e})")
    return hist, rel


def corridor_and_cube_stage(group, device):
    """The corridor at F = 256 on the sharded packed layout and the 2-robot
    cube, each against the single-process solve."""
    import torch.distributed as dist
    from mqslam_tpu_torch.ba import problem as bp, synthetic as basyn
    from mqslam_tpu_torch.parallel.sharded_ba import (build_layout_for_mesh,
                                                      pad_problem_for_shards)
    world = dist.get_world_size(group)
    prob, _ = basyn.generate_corridor_problem(nr_frames=256,
                                              points_per_frame=6,
                                              device=device)
    padded = pad_problem_for_shards(prob, world)
    lay = build_layout_for_mesh(padded, group)
    _require(lay is not None, "the sharded packed layout refused the "
             "corridor")
    t0 = time.perf_counter()
    hist, rel = _single_vs_sharded(padded, group, lay, 12, 150)
    rep = dict(corridor=dict(F=prob.n_poses, O=int(prob.obs_valid.sum()),
                             history=[hist[0], hist[-1]],
                             iterations=len(hist) - 1,
                             seconds=time.perf_counter() - t0,
                             single_process_rel=rel))
    data = basyn.generate_cube_scenario(nr_cameras=2, nr_frames=8, seed=0)
    cube = bp.problem_from_ba_data(data, pad_multiple=world, device=device)
    hist, rel = _single_vs_sharded(cube, group, "auto", 15, 150)
    rep["cube"] = dict(history=[hist[0], hist[-1]], single_process_rel=rel)
    return rep


def rank_main(rank, world, port, backend, agents, results):
    """One rank: join the group, run the stages, leave the group; rank 0
    puts its figures on ``results`` (a queue)."""
    import torch
    import torch.distributed as dist
    from mqslam_tpu_torch.parallel import multihost

    if backend == "nccl":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    else:
        # CPU ranks share the host's cores: one thread each, so that a
        # rank waiting in a collective does not wait for the other's
        # thread pool
        device = torch.device("cpu")
        torch.set_num_threads(1)
    multihost.initialize(f"tcp://127.0.0.1:{port}", world, rank,
                         backend=backend, timeout_s=TIMEOUT_S / 2)
    try:
        group = dist.group.WORLD
        rep = dict(backend=backend, device=str(device))
        rep["fleet"] = fleet_pipeline_stage(group, device, agents)
        rep.update(corridor_and_cube_stage(group, device))
        if rank == 0:
            results.put(rep)
    finally:
        dist.destroy_process_group()


def main(argv=None):
    from mqslam_tpu_torch.parallel.multihost import free_port
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=1)
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="nccl")
    args = ap.parse_args(argv)
    agents = max(2, args.procs)          # one agent a rank, at least two
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=rank_main,
                         args=(r, args.procs, port, args.backend, agents,
                               results))
             for r in range(args.procs)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + TIMEOUT_S
    rep = None
    try:
        # drain the queue before joining: rank 0 writes to it
        while rep is None and any(p.is_alive() for p in procs) \
                and time.monotonic() < deadline:
            try:
                rep = results.get(timeout=1.0)
            except queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
    codes = [p.exitcode for p in procs]
    if rep is None or any(c != 0 for c in codes):
        print(f"dryrun: FAILED, rank exit codes {codes}", file=sys.stderr)
        return 1
    print(json.dumps(rep), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
