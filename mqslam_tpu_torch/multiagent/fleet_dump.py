"""Rebuild per-agent BA dumps from a collect=True multi-agent scan.

The fleet runner (``parallel.fleet.make_fleet_runner(collect=True)``)
returns per-frame track-level arrays for every agent; this module replays
``run_frontend``'s collect_ba bookkeeping over those arrays on the host,
producing one ``ba_info.BAData`` per agent, so the whole fleet -> merge ->
joint-BA pipeline runs from one fleet run (the reference's shape: N slam2
front-ends writing BA_info dumps consumed by one bundle_adjust.cpp process,
bundle_adjust.cpp:289-309).

Semantics match the host-loop runner for accepted frames; rejected frames
contribute empty per-frame lists exactly like the host loop.  (The scan's
internal reject recovery differs slightly from the host loop, which freezes
prev_img on rejects, so dumps from a scan that hit rejects are
self-consistent but not byte-identical to ``run_frontend``'s.)

The counterpart of ``mqslam_tpu/multiagent/fleet_dump.py``, with two
differences of form: each tensor moves to the host once
(``scan_to_host``), and the rotation of a pose is this module's float64
NumPy Rodrigues (``rodrigues``), not OpenCV's, which the port does not
depend on.
"""

import numpy as np
import torch

from mqslam_tpu_torch.io import ba_info as ba_io

__all__ = ["ba_data_from_scan", "rodrigues", "scan_to_host"]


def rodrigues(rvec):
    """Rotation matrix [3, 3] of a rotation vector [3], float64, by OpenCV's
    Rodrigues formula (the identity below an angle of float64's machine
    epsilon, as there)."""
    r = np.asarray(rvec, np.float64).reshape(3)
    theta = float(np.sqrt(r @ r))
    if theta < np.finfo(np.float64).eps:
        return np.eye(3)
    k = r / theta
    c, s = np.cos(theta), np.sin(theta)
    K = np.array([[0.0, -k[2], k[1]],
                  [k[2], 0.0, -k[0]],
                  [-k[1], k[0], 0.0]])
    return c * np.eye(3) + (1.0 - c) * np.outer(k, k) + s * K


def _cam_to_world(rvec, tvec):
    R = rodrigues(rvec)
    P = np.eye(4)
    P[:3, :3] = R.T
    P[:3, 3] = -R.T @ np.asarray(tvec, np.float64)
    return P


def _frame_2d_list(uv, alive):
    idxs = np.flatnonzero(alive)
    comp = -np.ones(len(alive), dtype=np.int64)
    comp[idxs] = np.arange(len(idxs))
    return uv[idxs], comp


def _host(x):
    """A tensor's host copy as NumPy (one transfer); NumPy passes through."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def scan_to_host(init_state, final_state, outs):
    """The scan's states and outputs as NumPy, each tensor moved to the
    host once: rebuild every agent's dump from these, not from the
    tensors (``ba_data_from_scan`` would move each tensor once an agent)."""
    st = lambda s: type(s)(*(_host(x) for x in s))
    return st(init_state), st(final_state), tuple(_host(x) for x in outs)


def ba_data_from_scan(init_state, final_state, outs, cal, agent: int,
                      fps: float = 30.0, t0: float = 0.0):
    """BAData for ``agent`` from a collect=True multi-agent scan.

    init_state / final_state: the A-stacked tracker states before / after
    the scan (``TrackerState`` of tensors, or any object with the same
    fields as NumPy arrays, ``scan_to_host``).  outs: the scan's
    per-frame tuple (accepted, rvec, tvec, cur_uv, alive, triangulated,
    new_landmarks, pnp_inlier, objp_idx), each [T, A, ...].  cal: a
    ``Cal3DS2`` (its ``as_array()``).
    """
    (acc, rvec, tvec, cur_uv, alive, tri, newlm, inlier, oidx) = (
        (_host(x)[:, agent] if x.ndim > 1 else _host(x)) for x in outs)
    T = acc.shape[0]

    data = ba_io.BAData(nr_cameras=1)
    data.pose_noise = [ba_io.NoiseModel.diagonal([0.002] * 3 + [0.001] * 3)]
    data.odometry_noise = [[ba_io.NoiseModel.diagonal(
        [0.05] * 3 + [0.2] * 3)]]
    data.point3D_noise = ba_io.NoiseModel.isotropic(3, 0.2)
    data.point2D_noise = [ba_io.NoiseModel.isotropic(2, 1.0)]
    data.calibrations = [_host(cal.as_array()).astype(np.float64)]

    # frame 0: the bootstrap state
    g = lambda leaf: _host(leaf)[agent]
    uv0 = g(init_state.cur_uv)
    alive0 = g(init_state.active)
    uv_list, comp = _frame_2d_list(uv0, alive0)
    data.points2D = [[uv_list]]
    tri0 = g(init_state.triangulated) & alive0
    oidx0 = g(init_state.objp_idx)
    sl0 = np.flatnonzero(tri0)
    data.point2D3D_assocs = [[np.stack(
        [np.zeros(len(sl0), np.int64), comp[sl0], oidx0[sl0]], axis=1)]]
    n_init = int(g(init_state.n_objp))
    data.point3D_added_idxs = [list(range(n_init))]
    data.odometry = [[]]
    data.odometry_assocs = [[]]

    poses = [_cam_to_world(g(init_state.rvec), g(init_state.tvec))]
    history = [(0, uv0, alive0, comp)]
    last_kf = 0
    for i in range(T):
        f = i + 1
        data.points2D[0].append(np.zeros((0, 2)))
        data.point2D3D_assocs[0].append(np.zeros((0, 3), np.int64))
        data.point3D_added_idxs.append([])
        data.odometry.append([])
        data.odometry_assocs.append([])
        if acc[i] == 0:
            poses.append(None)
            continue
        poses.append(_cam_to_world(rvec[i], tvec[i]))
        uv_f, alive_f = cur_uv[i], alive[i]
        uv_list, comp = _frame_2d_list(uv_f, alive_f)
        data.points2D[0][f] = uv_list
        sl = np.flatnonzero(inlier[i] & alive_f & tri[i] & ~newlm[i])
        data.point2D3D_assocs[0][f] = np.stack(
            [np.full(len(sl), f, np.int64), comp[sl],
             oidx[i][sl].astype(np.int64)], axis=1)
        history.append((f, uv_f, alive_f, comp))
        if acc[i] == 2:  # keyframe: add landmarks + backfilled assocs
            new_slots = np.flatnonzero(newlm[i])
            data.point3D_added_idxs[f] = [int(x) for x in
                                          oidx[i][new_slots]]
            rows = [(fh, comp_h[s], int(oidx[i][s]))
                    for (fh, uv_h, alive_h, comp_h) in history
                    for s in new_slots if alive_h[s] and comp_h[s] >= 0]
            if rows:
                data.point2D3D_assocs[0][f] = np.concatenate(
                    [data.point2D3D_assocs[0][f],
                     np.asarray(rows, np.int64)], axis=0)
            if poses[last_kf] is not None:
                data.odometry[f] = [np.linalg.inv(poses[last_kf])
                                    @ poses[f]]
                data.odometry_assocs[f] = [(0, last_kf, 0, f)]
            last_kf = f
            history = [(f, uv_f, alive_f, comp)]

    n_pts = int(g(final_state.n_objp))
    data.points3D = np.asarray(g(final_state.objp)[:n_pts], np.float64)
    gray = np.clip(np.asarray(g(final_state.objp_color)[:n_pts]),
                   0, 255).astype(np.uint8)
    bgra = np.stack([gray, gray, gray,
                     np.full(n_pts, 0xFD, np.uint8)], axis=1)
    data.point_colors = np.ascontiguousarray(bgra).view(
        np.float32).reshape(-1)
    data.poses = [[(P, t0 + i / fps) if P is not None else None
                   for i, P in enumerate(poses)]]
    return data
