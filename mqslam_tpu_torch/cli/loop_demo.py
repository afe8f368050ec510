"""Loop-closure end-to-end demo: drift -> detected closure -> PGO fix.

A camera flies a closed square circuit over the textured plane (synthetic,
fully known ground truth), long enough for front-end drift to accumulate;
on return the ORB keyframe DB (frontend/loopclosure.py) detects the
revisit, the verified edge feeds the pose-graph solver (ba/posegraph.py)
through run_frontend's correction pass, and ATE must improve vs the same
run with loop closure disabled.

The reference has no loop closure (slam2.py tracks forward-only; the
north-star components list in BASELINE.json names it) — trajectory
semantics follow the reference's keyframe chain.  The counterpart of
``mqslam_tpu/cli/loop_demo.py`` at its defaults, with explicit RANSAC draws
(a generator seeded ``seed``; run_frontend seeds the loop verification's
``seed + 1``).  Runs on the CUDA device unless given ``--device cpu``:

    python -m mqslam_tpu_torch.cli.loop_demo [--device cpu]
"""

import argparse
import sys

import numpy as np

__all__ = ["circuit_trajectory", "run", "main"]


def circuit_trajectory(n_frames: int, side: float = 4.2,
                       height: float = 0.0):
    """Closed square circuit over the plane: +x, +y, -x, -y back to the
    start.  ``side`` is chosen larger than the camera's footprint on the
    plane so mid-circuit views don't co-observe the start region — loop
    edges then fire only on the true revisit.  Returns [n, 4, 4]
    world-to-cam extrinsics."""
    legs = 4
    per = n_frames // legs
    waypoints = [np.array([0.0, 0.0, height]),
                 np.array([side, 0.0, height]),
                 np.array([side, side * 0.7, height]),
                 np.array([0.0, side * 0.7, height]),
                 np.array([0.0, 0.0, height])]
    Ps = []
    for i in range(n_frames):
        leg = min(i // per, legs - 1)
        frac = (i - leg * per) / per
        c = waypoints[leg] * (1 - frac) + waypoints[leg + 1] * frac
        P = np.eye(4)
        P[:3, 3] = -c
        Ps.append(P)
    return np.stack(Ps)


def run(n_frames=240, size=(320, 240), f=280.0, plane_z=4.0, seed=5,
        verbose=True, device=None):
    """(ATE off, ATE on, loop edges, {False: result, True: result}): the
    circuit tracked with loop closure off and on, ATE RMSE in metres."""
    import torch

    from mqslam_tpu_torch import convert, resolve_device
    from mqslam_tpu_torch.eval import ate as ate_mod
    from mqslam_tpu_torch.frontend import synthetic, tracker as trk
    from mqslam_tpu_torch.frontend.runner import run_frontend
    from mqslam_tpu_torch.io import tum
    from mqslam_tpu_torch.io.nputil import matrix_to_quat_np
    from mqslam_tpu_torch.ops import features

    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    cal = convert.cal_from_numpy(
        [f, f, 0.0, size[0] / 2, size[1] / 2, 0, 0, 0, 0], device=device)
    config = trk.TrackerConfig(max_tracks=192, max_landmarks=4096,
                               target_keypoints=120, ransac_hypotheses=64)
    tex = synthetic.make_texture(rng)
    gt = circuit_trajectory(n_frames)
    imgs = synthetic.render_plane_sequence(gt, tex, size=size, f=f,
                                           plane_z=plane_z)
    # mild sensor noise so front-end drift actually accumulates
    imgs = np.clip(imgs + rng.randn(*imgs.shape) * 3.0, 0, 255
                   ).astype(np.float32)

    uv, valid = features.detect_corners(
        torch.as_tensor(imgs[0], device=device), max_corners=120, cell=12)
    uv = uv[valid][:96].cpu().numpy()
    objp = synthetic.backproject_to_plane(
        uv, gt[0], f, (size[0] / 2, size[1] / 2), plane_z=plane_z)

    results = {}
    for lc in (False, True):
        # min_gap well above a leg's keyframe count: only the true
        # revisit of the start region can fire (near-neighbor
        # co-visibility matches would re-smooth, not close the loop)
        res = run_frontend(imgs, cal, config, uv.astype(np.float32),
                           objp.astype(np.float32), fps=30.0,
                           collect_ba=False,
                           generator=torch.Generator(
                               device=device).manual_seed(seed),
                           loop_closure=lc, loop_min_gap=40,
                           loop_min_matches=30, device=device)
        results[lc] = res
        if verbose:
            n_acc = sum(1 for a in res.accepted if a > 0)
            print(f"loop_closure={lc}: {n_acc}/{len(res.accepted)} frames, "
                  f"{res.n_keyframes} keyframes, "
                  f"{len(res.loop_edges)} loop edges")

    W = np.linalg.inv(gt)
    g_traj = tum.CamTrajectory(
        np.arange(n_frames) / 30.0, W[:, :3, 3],
        np.stack([matrix_to_quat_np(w[:3, :3]) for w in W]))
    ates = {}
    for lc, res in results.items():
        ates[lc] = ate_mod.evaluate_ate(res.trajectory, g_traj,
                                        max_difference=1e-3).rmse
    edges = results[True].loop_edges
    if verbose:
        print(f"ATE without loop closure: {ates[False]:.4f} m")
        print(f"ATE with    loop closure: {ates[True]:.4f} m "
              f"({len(edges)} edges)")
    return ates[False], ates[True], len(edges), results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: the CUDA device)")
    args = ap.parse_args(argv)
    ate_off, ate_on, n_edges, _ = run(device=args.device)
    ok = n_edges > 0 and ate_on <= ate_off
    print(f"loop-closure demo: ATE {ate_off:.4f} -> {ate_on:.4f} m with "
          f"{n_edges} verified closure edges "
          f"({'OK' if ok else 'NO IMPROVEMENT'})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
