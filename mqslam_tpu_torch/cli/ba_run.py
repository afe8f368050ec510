"""Offline bundle adjustment over a BA_info dump — the bundle_adjust CLI.

  python -m mqslam_tpu_torch.cli.ba_run <baseDir> <baseName> <nrCameras>
         <fps> [useOdometry [fullOptimizeAtSecondPoints3DBatch [startTime
         [firstFrameStartsAfterStartTime [mode [runFromGenerated]]]]]]
         [--device cuda|cpu]

The argument surface of the reference back-end (bundle_adjust.cpp) and of
the JAX package's ``ba_run``.  ``mode`` 0 = full batch LM (``lm_solve``,
then the float64 ``polish64`` pass); 1 and 2 = the step-batched
incremental solve (``incremental_solve``, the counterpart of the
reference's iSAM modes; both modes run it, with no polish, as the JAX
package's CLI does).  ``runFromGenerated`` 1 solves the synthetic cube
scenario instead of the dump.  Writes traj_out.camC-<baseName>-BA.txt and
map_out-<baseName>-BA.pcd into baseDir.  ``--device`` (anywhere in the
arguments) picks the torch device: the CUDA device by default.
``refine(data)`` is the solve alone, between the load and the writes, for
a caller that holds a ``BAData`` in memory.
"""

import sys

import numpy as np
import torch

from mqslam_tpu_torch import resolve_device


def refine(data, use_odometry=True, mode=0, max_iters=60, cg_iters=1000,
           verbose=False, device=None):
    """The solve of one loaded ``BAData``: validation, the problem on
    ``device`` (None: the CUDA device), then mode 0's LM and float64 polish
    or modes 1 and 2's incremental solve.  Returns (BAVariables on the
    device, the solve's costs, the polish's costs).  The solve's: mode 0
    the start's and one an LM outer iteration; modes 1 and 2 one a step.
    The polish's: its float64 cost of the LM's answer and one an
    iteration; none in modes 1 and 2."""
    from mqslam_tpu_torch.ba import incremental as binc
    from mqslam_tpu_torch.ba import problem as bp, solver as bs
    from mqslam_tpu_torch.ba.polish64 import polish64
    from mqslam_tpu_torch.ba.validate import (
        validate_data_integrity, validate_sufficiently_constrained)

    validate_data_integrity(data)
    validate_sufficiently_constrained(data, use_odometry)

    prob = bp.problem_from_ba_data(data, device=device)
    if not use_odometry:
        prob = prob._replace(odo_valid=torch.zeros_like(prob.odo_valid))

    if mode == 0:
        v, hist = bs.lm_solve(prob, max_iters=max_iters, cg_iters=cg_iters,
                              verbose=verbose)
        # float64 finishing pass: the float32 LM converges to the float32
        # cost floor; the last stretch of the valley is below that
        # resolution
        v, hist64 = polish64(prob, v, max_iters=12, verbose=verbose)
        return v, hist, hist64
    v, hist = binc.incremental_solve(data, prob, use_odometry=use_odometry,
                                     verbose=verbose)
    return v, hist, []


def run(base_dir, base_name, nr_cameras, fps, use_odometry=True,
        full_optimize_at_second_batch=True, start_time=0.0,
        first_frame_after=True, mode=0, run_from_generated=False,
        max_iters=60, cg_iters=1000, verbose=True, device=None):
    """One BA run over a dump (or the cube scenario) through ``refine``,
    written out in the reference's -BA naming; returns (BAVariables, cost
    history: mode 0 LM's, then the polish's; modes 1 and 2 one cost a
    step)."""
    from mqslam_tpu_torch.ba import synthetic as bsyn
    from mqslam_tpu_torch.core import so3
    from mqslam_tpu_torch.io import ba_info, pcd, tum
    from mqslam_tpu_torch.io.nputil import matrix_to_quat_np

    device = resolve_device(device)
    if run_from_generated:
        data = bsyn.generate_cube_scenario(nr_cameras=nr_cameras)
    else:
        data = ba_info.load_ba_data(base_dir, base_name, nr_cameras, fps,
                                    start_time, first_frame_after)
    v, hist, hist64 = refine(data, use_odometry=use_odometry, mode=mode,
                             max_iters=max_iters, cg_iters=cg_iters,
                             verbose=verbose, device=device)
    hist = hist + hist64[1:]
    if verbose:
        print(f"cost: {hist[0]:.4e} -> {hist[-1]:.4e} "
              f"({len(hist) - 1} accepted iterations)")

    # outputs in the reference's -BA naming
    fn = ba_info.make_filenames(base_dir, base_name, nr_cameras)
    S = data.nr_steps
    pose_t = v.pose_t.cpu().numpy()
    # float32 rotations, as the JAX package's so3.exp gives them
    Rs = so3.exp(v.pose_r.cpu()).numpy()
    for c in range(nr_cameras):
        ts, locs, quats = [], [], []
        for f in range(S):
            idx = c * S + f
            node = data.poses[c][f]
            if node is None:        # a hole: not optimized, not written
                continue
            ts.append(node[1])
            locs.append(pose_t[idx])
            quats.append(matrix_to_quat_np(Rs[idx]))
        tum.save_trajectory(fn.trajectories_out[c], tum.CamTrajectory(
            np.asarray(ts), np.asarray(locs).reshape(-1, 3),
            np.asarray(quats).reshape(-1, 4)))
    pts = v.points.cpu().numpy()[:len(data.points3D)]
    colors = None
    if data.point_colors is not None:
        colors = np.ascontiguousarray(
            np.asarray(data.point_colors, np.float32)).view(
            np.uint8).reshape(-1, 4)
    pcd.save_pcd(fn.map_out, pts, colors)
    if verbose:
        print(f"wrote {fn.map_out} and "
              f"{', '.join(fn.trajectories_out)}")
    return v, hist


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    device = None
    if "--device" in argv:
        i = argv.index("--device")
        if i + 1 >= len(argv):
            print("--device needs a value (cuda or cpu)")
            return 1
        device = argv[i + 1]
        del argv[i:i + 2]
    if len(argv) < 4:
        print(__doc__)
        return 1
    base_dir, base_name = argv[0], argv[1]
    nr_cameras, fps = int(argv[2]), int(argv[3])
    opt = {"use_odometry": True, "full_optimize_at_second_batch": True,
           "start_time": 0.0, "first_frame_after": True, "mode": 0,
           "run_from_generated": False}
    keys = list(opt.keys())
    for i, raw in enumerate(argv[4:]):
        if i >= len(keys):
            break
        opt[keys[i]] = type(opt[keys[i]])(float(raw)) \
            if keys[i] == "start_time" else type(opt[keys[i]])(int(raw))
    run(base_dir, base_name, nr_cameras, fps, device=device, **opt)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
