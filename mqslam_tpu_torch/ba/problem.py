"""BA problem container: static-shape factor tensors + conversion from
BAData.

The data model: per-camera pose chains over steps, a shared landmark store,
2D observations bound to (camera, frame, landmark), odometry (between)
factors — cross-camera ones included — and priors on each camera's first
pose and on the first landmark batch.

Poses are cam-to-world (rvec, tvec), the convention the BA wire format
stores.  Every index tensor is flattened and padded to a static size with a
validity mask: O, Q and Rq round up to a multiple of 128, as in the JAX
package, so both packages hold the same shapes; the padded slots are inert.
"""

from typing import NamedTuple

import numpy as np
import torch

from mqslam_tpu_torch import resolve_device
from mqslam_tpu_torch.core import so3
from mqslam_tpu_torch.utils import profiling

__all__ = ["BAProblem", "BAVariables", "problem_from_ba_data",
           "problem_to", "variables_from_problem"]


class BAVariables(NamedTuple):
    """The optimized quantities."""
    pose_r: torch.Tensor    # [F, 3] rvec of cam-to-world
    pose_t: torch.Tensor    # [F, 3] camera center in world
    points: torch.Tensor    # [P, 3]


class BAProblem(NamedTuple):
    """Constant problem data (tensors on one device)."""
    # initial values
    init: BAVariables
    pose_valid: torch.Tensor    # [F] bool (False = hole, not optimized)
    point_valid: torch.Tensor   # [P] bool
    # calibration per camera [C, 9] (Cal3DS2 order)
    calibrations: torch.Tensor
    # projection factors
    obs_uv: torch.Tensor        # [O, 2] pixels
    obs_pose: torch.Tensor      # [O] int32 flattened cam * S + frame
    obs_cam: torch.Tensor       # [O] int32
    obs_point: torch.Tensor     # [O] int32
    obs_sigma: torch.Tensor     # [O] isotropic pixel sigma
    obs_valid: torch.Tensor     # [O] bool
    # between (odometry) factors: measured = W_from^-1 W_to
    odo_r: torch.Tensor         # [Q, 3]
    odo_t: torch.Tensor         # [Q, 3]
    odo_from: torch.Tensor      # [Q] int32 (flattened pose index)
    odo_to: torch.Tensor        # [Q] int32
    odo_sigma: torch.Tensor     # [Q, 6] (rot xyz, trans xyz) sigmas
    odo_valid: torch.Tensor     # [Q] bool
    # pose priors
    prior_pose_idx: torch.Tensor    # [Rp] int32
    prior_pose_r: torch.Tensor      # [Rp, 3]
    prior_pose_t: torch.Tensor      # [Rp, 3]
    prior_pose_sigma: torch.Tensor  # [Rp, 6]
    prior_pose_valid: torch.Tensor  # [Rp] bool
    # point priors
    prior_point_idx: torch.Tensor    # [Rq] int32
    prior_point_xyz: torch.Tensor    # [Rq, 3]
    prior_point_sigma: torch.Tensor  # [Rq]
    prior_point_valid: torch.Tensor  # [Rq] bool

    @property
    def n_poses(self):
        return self.init.pose_r.shape[0]

    @property
    def n_points(self):
        return self.init.points.shape[0]

    @property
    def device(self):
        return self.init.pose_r.device


def variables_from_problem(problem: BAProblem) -> BAVariables:
    return problem.init


def _pad(a, n, fill=0):
    a = np.asarray(a)
    out = np.full((n,) + a.shape[1:], fill, dtype=a.dtype)
    out[:len(a)] = a
    return out


def _round_up(n, m=128):
    return max(m, ((n + m - 1) // m) * m)


def _log_f32(Rs):
    """Rotation vectors [n, 3] of rotation matrices [n, 3, 3], computed in
    float32 on the CPU: the JAX package runs without 64-bit mode, so its
    initial rotation vectors are float32 logs of the float64 matrices."""
    Rs = np.asarray(Rs, np.float64).reshape(-1, 3, 3)
    return so3.log(torch.as_tensor(Rs, dtype=torch.float32)).numpy()


def problem_from_ba_data(data, pad_multiple: int = 128,
                         step_limit: int = None, device=None) -> BAProblem:
    """Build a BAProblem from a loaded or collected BA_info dump.

    Follows the reference back-end's graph construction: initial pose
    estimates from the front-end trajectory (holes stay unoptimized),
    initial landmarks from the map, projection factors from the point2D3D
    associations, between factors from the odometry associations, priors on
    each camera's first valid pose and on the first landmark batch.
    ``step_limit`` truncates to the first N steps.  The build is host code;
    the result lands on ``device`` (None: the CUDA device).  Span
    ``ba.build`` covers both."""
    device = resolve_device(device)
    with profiling.span("ba.build", device):
        return problem_to(_host_problem(data, pad_multiple, step_limit),
                          device)


def _host_problem(data, pad_multiple, step_limit):
    """``problem_from_ba_data``'s build, as host tensors."""
    C = data.nr_cameras
    S = data.nr_steps if step_limit is None else min(step_limit,
                                                    data.nr_steps)
    F = C * S

    pose_r = np.zeros((F, 3))
    pose_t = np.zeros((F, 3))
    pose_valid = np.zeros(F, dtype=bool)
    rot = []
    for c in range(C):
        for f in range(S):
            node = data.poses[c][f]
            if node is None:
                continue
            W, _ = node
            pose_valid[c * S + f] = True
            rot.append(W[:3, :3])
            pose_t[c * S + f] = W[:3, 3]
    if rot:
        pose_r[pose_valid] = _log_f32(rot)

    # landmarks active up to the step limit
    P_n = len(data.points3D)
    point_valid = np.zeros(P_n, dtype=bool)
    for s in range(S):
        for idx in data.point3D_added_idxs[s]:
            if idx < P_n:
                point_valid[idx] = True
    points = np.asarray(data.points3D, dtype=np.float64)

    # projection factors
    obs_uv, obs_pose, obs_cam, obs_point, obs_sigma = [], [], [], [], []
    for c in range(C):
        sigma_px = float(data.point2D_noise[c].sigmas[0])
        for s in range(min(S, len(data.point2D3D_assocs[c]))):
            for (f_idx, p2d, p3d) in data.point2D3D_assocs[c][s]:
                f_idx, p2d, p3d = int(f_idx), int(p2d), int(p3d)
                if f_idx >= S or not pose_valid[c * S + f_idx]:
                    continue
                if p3d >= P_n or not point_valid[p3d]:
                    continue
                obs_uv.append(data.points2D[c][f_idx][p2d])
                obs_pose.append(c * S + f_idx)
                obs_cam.append(c)
                obs_point.append(p3d)
                obs_sigma.append(sigma_px)

    # odometry factors
    odo_R, odo_t, odo_from, odo_to, odo_sigma = [], [], [], [], []
    for s in range(min(S, len(data.odometry_assocs))):
        for k, (fc, ff, tc, tf) in enumerate(data.odometry_assocs[s]):
            if ff >= S or tf >= S:
                continue
            if not (pose_valid[fc * S + ff] and pose_valid[tc * S + tf]):
                continue
            M = data.odometry[s][k]
            odo_R.append(M[:3, :3])
            odo_t.append(M[:3, 3])
            odo_from.append(fc * S + ff)
            odo_to.append(tc * S + tf)
            nm = data.odometry_noise[fc][tc]
            odo_sigma.append(np.asarray(nm.sigmas, dtype=np.float64)
                             if nm is not None else np.ones(6))
    odo_r = _log_f32(odo_R) if odo_R else np.zeros((0, 3))

    # priors: each camera's first valid pose
    pp_idx, pp_r, pp_t, pp_sig = [], [], [], []
    for c in range(C):
        for f in range(S):
            if pose_valid[c * S + f]:
                pp_idx.append(c * S + f)
                pp_r.append(pose_r[c * S + f])
                pp_t.append(pose_t[c * S + f])
                pp_sig.append(np.asarray(data.pose_noise[c].sigmas,
                                         dtype=np.float64))
                break
    # first landmark batch priors
    pq_idx, pq_xyz, pq_sig = [], [], []
    first_batch = data.point3D_added_idxs[0] if S > 0 else []
    for idx in first_batch:
        if idx < P_n:
            pq_idx.append(idx)
            pq_xyz.append(points[idx])
            pq_sig.append(float(data.point3D_noise.sigmas[0]))

    O = _round_up(max(len(obs_uv), 1), pad_multiple)
    Q = _round_up(max(len(odo_r), 1), pad_multiple)
    Rp = max(len(pp_idx), 1)
    Rq = _round_up(max(len(pq_idx), 1), pad_multiple)

    def f32(a, n, width, fill=0.0):
        a = np.asarray(a, np.float64).reshape((-1,) + width)
        return torch.as_tensor(_pad(a, n, fill), dtype=torch.float32)

    def i32(a, n):
        return torch.as_tensor(_pad(np.asarray(a, np.int32), n))

    def valid(n_used, n):
        return torch.as_tensor(np.arange(n) < n_used)

    return BAProblem(
        init=BAVariables(
            pose_r=torch.as_tensor(pose_r, dtype=torch.float32),
            pose_t=torch.as_tensor(pose_t, dtype=torch.float32),
            points=torch.as_tensor(points, dtype=torch.float32)),
        pose_valid=torch.as_tensor(pose_valid),
        point_valid=torch.as_tensor(point_valid),
        calibrations=torch.as_tensor(np.stack(data.calibrations),
                                     dtype=torch.float32),
        obs_uv=f32(obs_uv, O, (2,)),
        obs_pose=i32(obs_pose, O),
        obs_cam=i32(obs_cam, O),
        obs_point=i32(obs_point, O),
        obs_sigma=f32(obs_sigma, O, (), fill=1.0),
        obs_valid=valid(len(obs_uv), O),
        odo_r=f32(odo_r, Q, (3,)),
        odo_t=f32(odo_t, Q, (3,)),
        odo_from=i32(odo_from, Q),
        odo_to=i32(odo_to, Q),
        odo_sigma=f32(odo_sigma, Q, (6,), fill=1.0),
        odo_valid=valid(len(odo_r), Q),
        prior_pose_idx=i32(pp_idx, Rp),
        prior_pose_r=f32(pp_r, Rp, (3,)),
        prior_pose_t=f32(pp_t, Rp, (3,)),
        prior_pose_sigma=f32(pp_sig, Rp, (6,), fill=1.0),
        prior_pose_valid=valid(len(pp_idx), Rp),
        prior_point_idx=i32(pq_idx, Rq),
        prior_point_xyz=f32(pq_xyz, Rq, (3,)),
        prior_point_sigma=f32(pq_sig, Rq, (), fill=1.0),
        prior_point_valid=valid(len(pq_idx), Rq),
    )


def problem_to(problem: BAProblem, device, dtype=None) -> BAProblem:
    """The same problem with every tensor on ``device``, and its floating
    tensors in ``dtype`` if given (float64: the reference the float32 solve
    is held against where float32 cannot resolve a result; the BA functions
    follow their inputs' dtype)."""
    def move(x):
        x = x.to(device)
        return x.to(dtype) if dtype is not None and x.is_floating_point() \
            else x

    return BAProblem(init=BAVariables(*map(move, problem.init)),
                     **{k: move(getattr(problem, k)) for k in
                        problem._fields if k != "init"})
