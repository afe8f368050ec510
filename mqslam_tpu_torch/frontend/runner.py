"""Host loop around the tracker step: IO, trajectory, BA-info export.

The device does all per-frame compute (frontend.tracker.make_step); this loop
only feeds images and keeps the factor-graph bookkeeping the reference's
BundleAdjustmentInfoContainer did (reference: Work/SLAM/application/own/
slam2.py:743-865 writer, :1203-1253 main loop). Rejected frames are dropped
entirely — the next flow starts from the last accepted image and the
trajectory keeps a hole (slam2.py:1221-1225).

Every read of a device value makes the host wait for the device, so what the
loop needs of a frame comes back in ONE transfer (``_fetch``); each frame
pays one pyramid build (the previous frame's pyramid is kept).  Loop closure
adds one or two reads per keyframe (whether a candidate was found, whether
it verified) and a pose-graph solve after the sequence.
"""

import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from mqslam_tpu_torch import resolve_device
from mqslam_tpu_torch.ba import posegraph as pg
from mqslam_tpu_torch.core import camera as cam_mod, se3, so3
from mqslam_tpu_torch.frontend import checkpoint as ckpt
from mqslam_tpu_torch.frontend import loopclosure as lc
from mqslam_tpu_torch.frontend import tracker as trk
from mqslam_tpu_torch.io import ba_info as ba_io, pcd as pcd_mod, tum
from mqslam_tpu_torch.io.nputil import matrix_to_quat_np
from mqslam_tpu_torch.ops import lk, orb
from mqslam_tpu_torch.utils import profiling

__all__ = ["FrontendResult", "run_frontend"]


@dataclass
class FrontendResult:
    trajectory: "tum.CamTrajectory"        # accepted frames only
    poses: List[Optional[np.ndarray]]      # per frame 4x4 cam-to-world | None
    points3d: np.ndarray                   # [P, 3]
    point_colors: np.ndarray               # [P] intensity
    point_groups: np.ndarray               # [P]
    ba_data: Optional[ba_io.BAData]
    n_keyframes: int
    accepted: List[int]                    # per-frame 0/1/2
    loop_edges: List[tuple] = field(default_factory=list)
    # (kf_i, kf_j, meas_r [3], meas_t [3]) accepted loop closures


def _cam_to_world(rvec, tvec):
    """4x4 cam-to-world from a world->cam (rvec, tvec); host arithmetic."""
    as_cpu = lambda x: torch.as_tensor(np.asarray(x, np.float32))
    return se3.inv(se3.from_rvec_tvec(as_cpu(rvec), as_cpu(tvec))).numpy()


def _trajectory(poses, fps, t0):
    """TUM trajectory of the accepted frames (frame i at ``t0 + i / fps``)."""
    ts, locs, quats = [], [], []
    for i, P in enumerate(poses):
        if P is None:
            continue
        ts.append(t0 + i / fps)
        locs.append(P[:3, 3])
        quats.append(matrix_to_quat_np(P[:3, :3]))
    return tum.CamTrajectory(np.asarray(ts),
                             np.asarray(locs).reshape(-1, 3),
                             np.asarray(quats).reshape(-1, 4))


def _fetch(out):
    """Every field of a NamedTuple of tensors as NumPy arrays of the same
    shapes, moved to the host in one transfer (one wait for the device)."""
    flat = [x.reshape(-1).contiguous() for x in out]
    buf = torch.cat([x.view(torch.uint8) for x in flat]).cpu().numpy()
    fields, pos = [], 0
    for x, f in zip(out, flat):
        n = f.numel() * f.element_size()
        dtype = torch.empty(0, dtype=x.dtype).numpy().dtype
        fields.append(buf[pos:pos + n].view(dtype).reshape(tuple(x.shape)))
        pos += n
    return type(out)(*fields)


def run_frontend(images, cal: cam_mod.Cal3DS2, config: trk.TrackerConfig,
                 init_uv, init_objp, fps: float = 30.0, generator=None,
                 ransac_scores=None, collect_ba: bool = True,
                 verbose: bool = False, live_update_period: int = 0,
                 traj_out_file: str = None, map_out_file: str = None,
                 loop_closure: bool = False, loop_min_gap: int = 5,
                 loop_min_matches: int = 25, max_keyframes: int = 256,
                 loop_ransac_scores=None, t0: float = 0.0,
                 checkpoint_every: int = 0, checkpoint_path: str = None,
                 resume_from: str = None, debug_dir: str = None,
                 debug_every: int = 10, device=None, stage_ms=None):
    """Run the front-end over a grayscale image sequence.

    images: iterable of [H, W] float arrays (0..255). init_uv/init_objp:
    frame-0 2D-3D correspondences (chessboard grid or predefined points,
    slam2.py:1121-1146). With ``live_update_period`` > 0 and output paths
    set, the trajectory + map are flushed every N frames — the reference's
    live Blender-viewer hook (slam2.py:1244-1248, blender_tools.py:501-596
    polls these files).

    loop_closure=True maintains an ORB keyframe database (``max_keyframes``
    slots); at every keyframe the DB is queried (keyframes at least
    ``loop_min_gap`` keyframes old, ``loop_min_matches`` matches), the best
    candidate verified by RANSAC PnP and kept as a loop edge; after the
    sequence, verified loop edges + keyframe odometry feed a pose-graph
    optimization that corrects every pose and landmark (the capability the
    reference lacks — its drift correction is offline BA only).

    ``t0`` is the timestamp of frame 0; the reference convention is
    t0 = 1/fps (dataset_tools.py:275-294 convert_cam_poses_to_cam_trajectory
    "Timestamp of first pose starts at 1.0 / fps"), which the CLI uses so
    trajectories associate with the ICL-NUIM/SVO ground-truth files.

    With ``checkpoint_every`` > 0 and ``checkpoint_path`` set, the full
    resumable state (tracker state, generator states, host bookkeeping) is
    written after every accepted frame whose index is a multiple of N;
    ``resume_from`` restarts mid-sequence bit-identically to an
    uninterrupted run (frontend/checkpoint.py; pass the same ``images``,
    ``ransac_scores`` or a ``generator``, whose state is restored).

    ``device=None`` is the CUDA device (raises without one); pass ``"cpu"``
    to run there.  The RANSAC draws are explicit: ``ransac_scores``
    [n_frames - 1, n_hyp, K] (frame i uses row i - 1) or a
    ``torch.Generator`` on the device; with neither, torch's global
    generator draws.  Loop verification draws from ``loop_ransac_scores``
    [n_verifications, 128, K] (one row per verification, in order) or, when
    None, from a generator seeded ``generator.initial_seed() + 1`` (the JAX
    package's ``PRNGKey(seed + 1)``), or torch's global one without a
    ``generator``.  ``stage_ms`` (a dict) receives accumulated milliseconds
    per stage; asking for it synchronizes after every stage.

    ``debug_dir`` writes the Composite 2D/3D debug views (viz/painter.py —
    the headless equivalent of slam2's __debug__ windows, slam2.py:78-286,
    1227-1242) as PNGs every ``debug_every`` frames, plus every keyframe
    and every rejected frame (red border).  Only a frame that draws copies
    its image and the landmark store to the host.
    """
    if resume_from and loop_closure:
        raise ValueError("resume_from with loop_closure is not supported")
    device = resolve_device(device)
    cal = cal.to(device)
    _, refill_kf, step_pyr = trk.make_step(cal, config, device)
    pad = lk.lk_pad(config.lk_win)
    clock = profiling.Stages(stage_ms, device)

    def to_device(img):
        return torch.as_tensor(np.asarray(img, dtype=np.float32)).to(device)

    def pyramid(img_dev):
        return lk.build_pyramid(img_dev, config.lk_levels, pad=pad)

    images = iter(images)
    first = np.asarray(next(images), dtype=np.float32)
    debug = None if not debug_dir else _DebugViews(
        debug_dir, debug_every, first.shape[:2], cal)
    if resume_from:
        (state, frame_idx, prev_np, poses, accepted_flags, bk,
         rng) = ckpt.load_checkpoint(resume_from, device=device)
        for _ in range(frame_idx):  # frame 0 already consumed
            next(images)
        if generator is not None and "generator" in rng:
            generator.set_state(rng["generator"])
    else:
        with torch.no_grad():
            state = trk.bootstrap(init_uv, init_objp, cal, first, config,
                                  device=device)
        state0 = _fetch(state)
        poses = [_cam_to_world(state0.rvec, state0.tvec)]
        accepted_flags = [2]
        frame_idx, prev_np = 0, first
    with torch.no_grad():
        prev_pyr = pyramid(to_device(prev_np))
    n_init = len(init_uv)

    # --- BA bookkeeping ---
    data = ba_io.BAData(nr_cameras=1) if collect_ba else None
    # tracking history: frames since last keyframe (inclusive), as
    # (frame_idx, uv [K,2], alive [K], compact_index [K])
    history = []
    last_kf_frame = 0

    def frame_2d_list(uv, alive):
        """Compact per-frame 2D list + slot->list-index map."""
        idxs = np.flatnonzero(alive)
        comp = -np.ones(len(alive), dtype=np.int64)
        comp[idxs] = np.arange(len(idxs))
        return uv[idxs], comp

    if resume_from:
        data, history, last_kf_frame = bk
    elif collect_ba:
        data.pose_noise = [ba_io.NoiseModel.diagonal(
            [0.002] * 3 + [0.001] * 3)]
        data.odometry_noise = [[ba_io.NoiseModel.diagonal(
            [0.05] * 3 + [0.2] * 3)]]
        data.point3D_noise = ba_io.NoiseModel.isotropic(3, 0.2)
        data.point2D_noise = [ba_io.NoiseModel.isotropic(2, 1.0)]
        data.calibrations = [cal.as_array().cpu().numpy().astype(np.float64)]

        uv0 = state0.cur_uv
        alive0 = state0.active
        uv_list, comp = frame_2d_list(uv0, alive0)
        data.points2D = [[uv_list]]
        tri0 = state0.triangulated & alive0
        oidx0 = state0.objp_idx
        assoc0 = np.stack([np.zeros(tri0.sum(), np.int64),
                           comp[np.flatnonzero(tri0)],
                           oidx0[np.flatnonzero(tri0)]], axis=1)
        data.point2D3D_assocs = [[assoc0]]
        data.point3D_added_idxs = [list(range(n_init))]
        data.odometry = [[]]
        data.odometry_assocs = [[]]
        history.append((0, uv0, alive0, comp))

    # --- loop-closure bookkeeping (keyframe DB + edges) ---
    loop_edges = []
    lc_gen = None
    if loop_closure:
        db = lc.empty_db(capacity=max_keyframes, k=config.max_tracks,
                         device=device)
        if generator is not None:
            lc_gen = torch.Generator(device=device).manual_seed(
                generator.initial_seed() + 1)
        n_verify = 0
        kf_frames = [0]
        with torch.no_grad():
            desc0, _, okd0 = orb.brief_describe(
                to_device(first), state.cur_uv, state.active)
            db = lc.add_keyframe(
                db, desc0, okd0, state.cur_uv, _landmarks_of(state),
                state.active & state.triangulated & okd0,
                _pose6_from_w2c(state0.rvec, state0.tvec, device))
        lm_ranges = [(0, int(state0.n_objp), 0)]
        last_n_objp = int(state0.n_objp)

    for img in images:
        frame_idx += 1
        clock.mark()
        with torch.no_grad():
            new_img = to_device(img)
            new_pyr = pyramid(new_img)
            clock.mark("pyramid")
            sc = None if ransac_scores is None else \
                torch.as_tensor(ransac_scores[frame_idx - 1]).to(device)
            state, out_dev = step_pyr(state, prev_pyr, new_pyr, sc,
                                      generator, clock=clock)
            out = _fetch(out_dev)
        acc = int(out.accepted)
        accepted_flags.append(acc)
        if collect_ba:
            data.points2D[0].append(np.zeros((0, 2)))
            data.point2D3D_assocs[0].append(np.zeros((0, 3), np.int64))
            data.point3D_added_idxs.append([])
            data.odometry.append([])
            data.odometry_assocs.append([])

        if acc == 0:
            poses.append(None)
            if verbose:
                why = {1: "lost-tracks", 2: "too-few-triangulated",
                       3: "pnp-outlier-ratio", 4: "reprojection-rms"}.get(
                           int(out.reject_code), "?")
                print(f"frame {frame_idx}: REJECTED ({why}, "
                      f"lost_ratio={float(out.lost_ratio):.2f})")
            if debug is not None:
                debug.draw(frame_idx, img, 0, out, state)
            clock.mark("host")
            continue  # prev_pyr stays the last accepted image's

        poses.append(_cam_to_world(out.rvec, out.tvec))
        if collect_ba:
            uv = out.cur_uv
            alive = out.track_alive
            uv_list, comp = frame_2d_list(uv, alive)
            data.points2D[0][frame_idx] = uv_list
            # tracked, already-triangulated associations (slam2.py:517-522)
            inl = out.pnp_inlier & alive
            oidx = out.objp_idx
            sl = np.flatnonzero(inl & out.track_triangulated
                                & ~out.new_landmarks)
            assoc = np.stack([np.full(len(sl), frame_idx, np.int64),
                              comp[sl], oidx[sl]], axis=1)
            data.point2D3D_assocs[0][frame_idx] = assoc
            history.append((frame_idx, uv, alive, comp))

        if acc == 2:  # keyframe
            if collect_ba:
                new_slots = np.flatnonzero(out.new_landmarks)
                data.point3D_added_idxs[frame_idx] = [
                    int(oidx[s]) for s in new_slots]
                # associations of the new landmarks for every frame since the
                # last keyframe (slam2.py:633-641). They are introduced at
                # THIS step (assoc list index = current step) but each row's
                # frame field points at the historical frame — the
                # add_points2D_3Dassoc semantics (slam2.py:777-783), which
                # is also what keeps the incremental no-future-refs
                # invariant (DataStructures.hpp:139,156-158).
                rows = []
                for (f_idx, uv_h, alive_h, comp_h) in history:
                    for s in new_slots:
                        if alive_h[s] and comp_h[s] >= 0:
                            rows.append((f_idx, comp_h[s], oidx[s]))
                if rows:
                    data.point2D3D_assocs[0][frame_idx] = np.concatenate([
                        data.point2D3D_assocs[0][frame_idx],
                        np.asarray(rows, np.int64)], axis=0)
                # odometry between previous and current keyframe
                # (slam2.py:680-687): measured = W_prev^-1 W_cur
                P_prev = poses[last_kf_frame]
                P_cur = poses[frame_idx]
                if P_prev is not None:
                    odo = np.linalg.inv(P_prev) @ P_cur
                    data.odometry[frame_idx] = [odo]
                    data.odometry_assocs[frame_idx] = [
                        (0, last_kf_frame, 0, frame_idx)]
                last_kf_frame = frame_idx
                history = [(frame_idx, uv, alive, comp)]
            if loop_closure:
                kf_ord = len(kf_frames)
                if kf_ord == max_keyframes:
                    # DB saturated: later keyframes are not queryable as
                    # loop candidates (add_keyframe becomes a no-op)
                    print(f"WARNING: loop-closure keyframe DB full "
                          f"({max_keyframes}); frame {frame_idx} and later "
                          f"keyframes will not be stored", flush=True)
                with torch.no_grad():
                    alive_j = out_dev.track_alive
                    desc, _, okd = orb.brief_describe(
                        new_img, out_dev.cur_uv, alive_j)
                    # query before inserting (recency gate in KF ordinals)
                    scores, i1, good = lc.loop_scores(
                        db, desc, okd, cur_index=kf_ord,
                        min_gap=loop_min_gap)
                    cand, found = lc.best_candidate(
                        scores, min_matches=loop_min_matches)
                    if bool(found):
                        sc = None if loop_ransac_scores is None else \
                            torch.as_tensor(
                                loop_ransac_scores[n_verify]).to(device)
                        n_verify += 1
                        rv, tv, n_inl, okv = lc.verify_loop(
                            db, cand, i1, good, out_dev.cur_uv, okd, cal,
                            scores=sc, generator=lc_gen)
                        if bool(okv):
                            mr, mt = lc.relative_edge(db.pose[cand], rv, tv)
                            loop_edges.append((int(cand), kf_ord,
                                               mr.cpu().numpy(),
                                               mt.cpu().numpy()))
                            if verbose:
                                print(f"frame {frame_idx}: LOOP "
                                      f"kf{int(cand)}->kf{kf_ord} "
                                      f"({int(n_inl)} inliers)")
                    db = lc.add_keyframe(
                        db, desc, okd, out_dev.cur_uv, _landmarks_of(state),
                        alive_j & out_dev.track_triangulated & okd,
                        _pose6_from_w2c(out.rvec, out.tvec, device))
                kf_frames.append(frame_idx)
                n_now = int(state.n_objp)
                lm_ranges.append((last_n_objp, n_now, kf_ord))
                last_n_objp = n_now
            clock.mark("host")
            with torch.no_grad():
                state = refill_kf(state, new_img)
            clock.mark("refill")

        if verbose:
            print(f"frame {frame_idx}: acc={acc} "
                  f"tracks={int(out.n_tracks)} "
                  f"H-cond={float(out.homography_condition):.3f}")
        if debug is not None:
            debug.draw(frame_idx, img, acc, out, state)
        if (live_update_period and traj_out_file
                and frame_idx % live_update_period == 0):
            _write_live(state, poses, fps, traj_out_file, map_out_file,
                        t0=t0)
        prev_pyr = new_pyr
        prev_np = img
        if (checkpoint_every and checkpoint_path
                and frame_idx % checkpoint_every == 0):
            ckpt.save_checkpoint(
                checkpoint_path, state, frame_idx,
                np.asarray(prev_np, np.float32), poses, accepted_flags,
                bookkeeping=(data, history, last_kf_frame),
                generators=dict(generator=generator, loop_generator=lc_gen))
        clock.mark("host")

    # --- pose-graph loop-closure correction ---
    n_pts = int(state.n_objp)
    points3d = state.objp[:n_pts].cpu().numpy().copy()
    if loop_closure and loop_edges:
        poses, T_kf = _pgo_correct(poses, kf_frames, loop_edges, device)
        # landmarks move with the keyframe that created them
        for (lo, hi, kf_ord) in lm_ranges:
            T = T_kf[kf_ord]
            pts = points3d[lo:min(hi, n_pts)]
            points3d[lo:min(hi, n_pts)] = pts @ T[:3, :3].T + T[:3, 3]

    # --- outputs ---
    colors = state.objp_color[:n_pts].cpu().numpy()
    groups = state.objp_group[:n_pts].cpu().numpy()
    traj = _trajectory(poses, fps, t0)
    if collect_ba:
        data.points3D = points3d.astype(np.float64)
        gray = np.clip(colors, 0, 255).astype(np.uint8)
        bgra = np.stack([gray, gray, gray,
                         np.full(n_pts, 0xFD, np.uint8)], axis=1)
        data.point_colors = np.ascontiguousarray(bgra).view(
            np.float32).reshape(-1)
        data.poses = [[(P, t0 + i / fps) if P is not None else None
                       for i, P in enumerate(poses)]]
    return FrontendResult(
        trajectory=traj, poses=poses, points3d=points3d,
        point_colors=colors, point_groups=groups, ba_data=data,
        n_keyframes=sum(1 for a in accepted_flags if a == 2),
        accepted=accepted_flags, loop_edges=loop_edges)


class _DebugViews:
    """The headless debug views of ``run_frontend``: the Composite 2D/3D
    painters, drawn every ``every`` frames, on keyframes and on rejected
    frames, each to ``composite{2d,3d}_{frame:05d}.png``."""

    def __init__(self, out_dir, every, shape, cal):
        from mqslam_tpu_torch.viz.painter import (Composite2DPainter,
                                                  Composite3DPainter)
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir, self.every = out_dir, max(every, 1)
        h0, w0 = shape
        self.painter2d = Composite2DPainter((w0, h0))
        # bird's-eye-ish view pulled back along +z (navigable in the
        # interactive reference; fixed here — headless)
        P_view = np.eye(4)
        P_view[2, 3] = 12.0
        self.painter3d = Composite3DPainter(P_view[:3], (w0, h0))
        self.K = cam_mod.K_from_cal(cal).cpu().numpy().astype(np.float64)
        self.dist = cal.as_array()[5:9].cpu().numpy().astype(np.float64)
        self.neg_fy = float(cal.fy) < 0

    def draw(self, frame_idx, img, status, out, state):
        """Draw frame ``frame_idx`` (status 0 rejected, 1 tracked, 2
        keyframe) if it is due; ``out`` is the frame's host output, and
        ``state`` the tracker state, read only when the frame draws."""
        if status > 0 and not (status == 2 or frame_idx % self.every == 0):
            return
        objp = state.objp.cpu().numpy()
        groups = state.objp_group.cpu().numpy()
        colors = state.objp_color.cpu().numpy()
        n, group_id = int(state.n_objp), int(state.group_id)
        self.painter2d.draw(np.asarray(img, np.float32), out.rvec, out.tvec,
                            status, self.K, self.dist, out.cur_uv,
                            out.track_alive, out.track_triangulated,
                            out.objp_idx, objp, groups, group_id,
                            depth_labels=False)
        self.painter2d.save(os.path.join(
            self.out_dir, f"composite2d_{frame_idx:05d}.png"))
        self.painter3d.draw(out.rvec, out.tvec, status, objp[:n],
                            colors[:n], groups[:n], neg_fy=self.neg_fy)
        self.painter3d.save(os.path.join(
            self.out_dir, f"composite3d_{frame_idx:05d}.png"))


def _landmarks_of(state):
    """[K] landmark positions of the track slots, ``objp[objp_idx]`` (the
    tracker keeps the indices in range; the clamp is the JAX gather's)."""
    idx = torch.clamp(state.objp_idx.long(), 0, state.objp.shape[0] - 1)
    return state.objp[idx]


def _so3_log(R):
    return so3.log(torch.as_tensor(np.asarray(R, np.float32))).numpy()


def _so3_exp(r):
    return so3.exp(torch.as_tensor(np.asarray(r, np.float32))).numpy()


def _pose6_from_w2c(rvec, tvec, device=None):
    """(rvec, center) cam-to-world pose6 from a world->cam (rvec, tvec),
    on the host in float32; a tensor on ``device`` when one is given."""
    rvec = np.asarray(rvec, np.float32)
    c = -(_so3_exp(rvec).T @ np.asarray(tvec, np.float32))
    p6 = np.concatenate([-rvec, c]).astype(np.float32)
    return p6 if device is None else torch.as_tensor(p6).to(device)


def _pgo_correct(poses, kf_frames, loop_edges, device=None):
    """Pose-graph optimization over the keyframes; every frame and landmark
    is corrected by its governing keyframe's world transform.  The graph is
    solved on ``device`` (None: the CUDA device).

    Returns (new_poses list, T_kf [n_kf, 4, 4] world corrections)."""
    device = resolve_device(device)
    n = len(kf_frames)
    p6 = np.zeros((n, 6), np.float32)
    for k, f in enumerate(kf_frames):
        P = poses[f]
        p6[k, :3] = _so3_log(P[:3, :3])
        p6[k, 3:] = P[:3, 3]

    def between(i, j):
        Pi, Pj = poses[kf_frames[i]], poses[kf_frames[j]]
        D = np.linalg.inv(Pi) @ Pj
        return _so3_log(D[:3, :3]), D[:3, 3].astype(np.float32)

    E = n - 1 + len(loop_edges)
    ei = np.zeros(E, np.int32)
    ej = np.zeros(E, np.int32)
    mr = np.zeros((E, 3), np.float32)
    mt = np.zeros((E, 3), np.float32)
    sig = np.zeros((E, 6), np.float32)
    for k in range(n - 1):
        ei[k], ej[k] = k, k + 1
        mr[k], mt[k] = between(k, k + 1)
        sig[k] = [1 / 0.01] * 3 + [1 / 0.05] * 3   # odometry confidence
    for e, (i, j, r, t) in enumerate(loop_edges):
        k = n - 1 + e
        ei[k], ej[k] = i, j
        mr[k], mt[k] = r, t
        sig[k] = [1 / 0.005] * 3 + [1 / 0.02] * 3  # verified loops: tight
    prior_mask = np.zeros(n, bool)
    prior_mask[0] = True
    prior_r = np.zeros((n, 3), np.float32)
    prior_t = np.zeros((n, 3), np.float32)
    prior_r[0], prior_t[0] = p6[0, :3], p6[0, 3:]
    prior_sig = np.tile(np.asarray([1e3] * 6, np.float32), (n, 1))
    dev = lambda x: torch.as_tensor(x).to(device)
    g = pg.PoseGraph(
        poses=dev(p6), pose_valid=dev(np.ones(n, bool)), edge_i=dev(ei),
        edge_j=dev(ej), edge_meas_r=dev(mr), edge_meas_t=dev(mt),
        edge_inv_sigma=dev(sig), edge_valid=dev(np.ones(E, bool)),
        prior_mask=dev(prior_mask), prior_r=dev(prior_r),
        prior_t=dev(prior_t), prior_inv_sigma=dev(prior_sig))
    with torch.no_grad():
        new_p6 = pg.pgo_solve(g, iters=25)[0].cpu().numpy()

    T_kf = np.zeros((n, 4, 4), np.float64)
    for k, f in enumerate(kf_frames):
        Pn = np.eye(4)
        Pn[:3, :3] = _so3_exp(new_p6[k, :3])
        Pn[:3, 3] = new_p6[k, 3:]
        T_kf[k] = Pn @ np.linalg.inv(poses[f])

    # governing keyframe of each frame = last keyframe at or before it
    new_poses = list(poses)
    kf_ptr = 0
    for f in range(len(poses)):
        while kf_ptr + 1 < n and kf_frames[kf_ptr + 1] <= f:
            kf_ptr += 1
        if poses[f] is not None:
            new_poses[f] = T_kf[kf_ptr] @ poses[f]
    return new_poses, T_kf


def _write_live(state, poses, fps, traj_out_file, map_out_file,
                t0: float = 0.0):
    """Periodic trajectory/map flush (write_output, slam2.py:698-740)."""
    tum.save_trajectory(traj_out_file, _trajectory(poses, fps, t0))
    if map_out_file:
        n = int(state.n_objp)
        pts = state.objp[:n].cpu().numpy()
        gray = np.clip(state.objp_color[:n].cpu().numpy(), 0,
                       255).astype(np.uint8)
        pcd_mod.save_pcd(map_out_file, pts,
                         np.stack([gray, gray, gray], axis=1))
