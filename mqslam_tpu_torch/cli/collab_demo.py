"""Two-agent collaborative SLAM demo (BASELINE config #4).

Two cameras fly different trajectories over the same scene; each runs the
front-end independently (tracking drift accumulates per agent), the
per-agent BA dumps are merged into ONE 2-camera factor graph with
cross-agent between factors at rendezvous frames (the reference's 2-robot
graph shape: GenerateData.hpp:256-269 cross-camera odometry,
bundle_adjust.cpp:300-309), and joint bundle adjustment solves the shared
graph sharded over the process group of every process
(``parallel.multihost.global_group``: one rank in a single process, an
all-reduce assembly of the reduced camera system).  Per-agent ATE: front-end
-> independent BA -> joint BA.

Synthetic by construction (no dataset needed); runs on the CUDA device
unless given ``--device cpu``:

    python -m mqslam_tpu_torch.cli.collab_demo [--device cpu]

The counterpart of ``mqslam_tpu/cli/collab_demo.py`` at its defaults, with
the port's own Rodrigues, rotation and quaternion functions (no OpenCV) and
explicit RANSAC draws (a generator seeded ``seed + agent``).
"""

import argparse
import sys

import numpy as np


def _traj(n_frames, start, vel, yaw_rate):
    """World-to-camera poses [n, 4, 4] of a camera translating along
    ``vel`` from ``start`` while yawing by ``yaw_rate`` in all."""
    from mqslam_tpu_torch.multiagent.fleet_dump import rodrigues
    Ps = []
    for i in range(n_frames):
        frac = i / max(n_frames - 1, 1)
        R = rodrigues([0.0, yaw_rate * frac, 0.0])
        c = np.asarray(start) + np.asarray(vel) * frac
        P = np.eye(4)
        P[:3, :3] = R
        P[:3, 3] = -R @ c
        Ps.append(P)
    return np.stack(Ps)


def traj_from_vars(v, cam, S, data):
    """TUM trajectory of camera ``cam``'s poses in the solved variables
    (pose index cam * S + frame), at the dump's timestamps."""
    import torch
    from mqslam_tpu_torch.core import quat as quat_mod, so3
    from mqslam_tpu_torch.io import tum
    idx, ts = [], []
    for fr in range(S):
        node = data.poses[cam][fr] if fr < len(data.poses[cam]) else None
        if node is not None:
            idx.append(cam * S + fr)
            ts.append(node[1])
    sel = torch.as_tensor(idx, dtype=torch.long, device=v.pose_r.device)
    R = so3.exp(v.pose_r[sel].float())
    quats = quat_mod.from_matrix(R).cpu().numpy()
    return tum.CamTrajectory(np.asarray(ts),
                             v.pose_t[sel].cpu().numpy().reshape(-1, 3),
                             quats.reshape(-1, 4))


def gt_traj(P_gt, fps=30.0):
    """The known world-to-camera poses as a TUM trajectory, frame i at
    i / fps."""
    from mqslam_tpu_torch.io import tum
    from mqslam_tpu_torch.io.nputil import matrix_to_quat_np
    W = np.linalg.inv(P_gt)
    q = np.stack([matrix_to_quat_np(w[:3, :3]) for w in W])
    return tum.CamTrajectory(np.arange(len(P_gt)) / fps, W[:, :3, 3], q)


def rendezvous(gt, n_frames, every, rng, pairs=((0, 1),)):
    """Rendezvous cross-factors: the relative pose between two agents'
    cameras measured at every ``every``-th frame, from the ground truth with
    noise (1 mrad, 2 mm a component, as GenerateData.hpp does), sigmas
    2 mrad / 4 mm."""
    from mqslam_tpu_torch.multiagent import CrossOdometry
    from mqslam_tpu_torch.multiagent.fleet_dump import rodrigues
    cross = []
    for fidx in range(0, n_frames, every):
        for a, b in pairs:
            Wa = np.linalg.inv(gt[a][fidx])
            Wb = np.linalg.inv(gt[b][fidx])
            meas = np.linalg.inv(Wa) @ Wb
            dr = 0.001 * rng.randn(3)
            dt = 0.002 * rng.randn(3)
            D = np.eye(4)
            D[:3, :3] = rodrigues(dr)
            D[:3, 3] = dt
            cross.append(CrossOdometry(
                step=fidx, from_agent=a, from_frame=fidx, to_agent=b,
                to_frame=fidx, measured=meas @ D,
                sigmas=np.array([0.002] * 3 + [0.004] * 3)))
    return cross


def run_stages(n_frames=32, size=(320, 240), f=280.0, plane_z=4.0, seed=7,
               rendezvous_every=4, verbose=True, device=None):
    """The demo's pipeline: (table, details).  ``table[a]`` is agent a's
    (front-end, independent BA, joint BA) ATE RMSE in metres; ``details``
    holds the merged dump, its problem and the joint solve's history."""
    import torch

    from mqslam_tpu_torch import convert, resolve_device
    from mqslam_tpu_torch.ba import problem as bp, solver as bs
    from mqslam_tpu_torch.eval import ate as ate_mod
    from mqslam_tpu_torch.frontend import synthetic, tracker as trk
    from mqslam_tpu_torch.frontend.runner import run_frontend
    from mqslam_tpu_torch.multiagent import merge_agents
    from mqslam_tpu_torch.ops import features
    from mqslam_tpu_torch.parallel import multihost, sharded_lm_solve

    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    cal = convert.cal_from_numpy(
        [f, f, 0.0, size[0] / 2, size[1] / 2, 0, 0, 0, 0], device=device)
    config = trk.TrackerConfig(max_tracks=192, max_landmarks=2048,
                               target_keypoints=120, ransac_hypotheses=64)
    tex = synthetic.make_texture(rng)

    # two overlapping trajectories over the same plane
    gt = [_traj(n_frames, [0.0, 0.0, 0.0], [1.8, 0.2, 0.3], 0.09),
          _traj(n_frames, [2.4, 0.15, 0.0], [-1.8, -0.1, 0.25], -0.1)]

    datas, results = [], []
    for a in range(2):
        imgs = synthetic.render_plane_sequence(gt[a], tex, size=size, f=f,
                                               plane_z=plane_z)
        uv, valid = features.detect_corners(
            torch.as_tensor(imgs[0], dtype=torch.float32, device=device),
            max_corners=100, cell=14)
        uv = uv[valid][:80].cpu().numpy()
        objp = synthetic.backproject_to_plane(
            uv, gt[a][0], f, (size[0] / 2, size[1] / 2), plane_z=plane_z)
        gen = torch.Generator(device=device).manual_seed(seed + a)
        res = run_frontend(imgs, cal, config, uv.astype(np.float32),
                           objp.astype(np.float32), fps=30.0,
                           collect_ba=True, generator=gen, device=device)
        datas.append(res.ba_data)
        results.append(res)
        if verbose:
            print(f"agent {a}: {sum(1 for x in res.accepted if x > 0)}"
                  f"/{len(res.accepted)} frames, "
                  f"{res.n_keyframes} keyframes")

    merged = merge_agents(datas, cross_odometry=rendezvous(
        gt, n_frames, rendezvous_every, rng))
    prob = bp.problem_from_ba_data(merged, device=device)

    with multihost.global_group(multihost.backend_for(device)) as group:
        world = torch.distributed.get_world_size(group)
        v_joint, hist = sharded_lm_solve(prob, group, max_iters=25,
                                         cg_iters=400)
    if verbose:
        print(f"joint BA over {world} rank(s): cost {hist[0]:.4e} -> "
              f"{hist[-1]:.4e}")

    # independent per-agent BA (no cross factors)
    v_indep = []
    for a in range(2):
        pa = bp.problem_from_ba_data(datas[a], device=device)
        va, _ = bs.lm_solve(pa, max_iters=25, cg_iters=400)
        v_indep.append(va)

    S = merged.nr_steps
    table = {}
    for a in range(2):
        g = gt_traj(gt[a])
        fe = ate_mod.evaluate_ate(results[a].trajectory, g,
                                  max_difference=1e-3).rmse
        ind = ate_mod.evaluate_ate(
            traj_from_vars(v_indep[a], 0, datas[a].nr_steps, datas[a]), g,
            max_difference=1e-3).rmse
        joint = ate_mod.evaluate_ate(
            traj_from_vars(v_joint, a, S, merged), g,
            max_difference=1e-3).rmse
        table[a] = (fe, ind, joint)
        if verbose:
            print(f"agent {a} ATE: front-end {fe:.4f} m | independent BA "
                  f"{ind:.4f} m | joint BA {joint:.4f} m")
    return table, dict(merged=merged, problem=prob, history=hist,
                       v_joint=v_joint, world=world)


def run(n_frames=32, size=(320, 240), f=280.0, plane_z=4.0, seed=7,
        rendezvous_every=4, verbose=True, device=None):
    """The per-agent ATE table {agent: (front-end, independent BA, joint
    BA)} in metres (``run_stages``)."""
    return run_stages(n_frames, size, f, plane_z, seed, rendezvous_every,
                      verbose, device)[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: the CUDA device)")
    args = ap.parse_args(argv)
    table = run(device=args.device)
    mean_fe = np.mean([v[0] for v in table.values()])
    mean_joint = np.mean([v[2] for v in table.values()])
    print(f"mean ATE: front-end {mean_fe:.4f} m -> joint BA "
          f"{mean_joint:.4f} m")
    return 0


if __name__ == "__main__":
    sys.exit(main())
