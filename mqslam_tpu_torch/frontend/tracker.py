"""The front-end step: flow -> reject ladder -> PnP -> keyframe logic.

Per frame:

  1. pyramidal LK flow, drop tracks with err >= max_of_error
  2. reject the frame when the lost-track ratio > 0.5
  3. reject when < 8 triangulated tracks survive
  4. RANSAC PnP (2 px, outlier ratio <= 0.33) else reject
  5. refine PnP on inliers from the extrinsic guess; reject if RMS > 2 px
  6. homography-degeneracy keyframe test (sigma0 / sigma2 > 1.04)
  7. on a keyframe: triangulate new landmarks against the last keyframe,
     refine the pose on all points, re-triangulate, gate on reprojection,
     store the landmarks, refill features up to the target count

The track table is fixed capacity (slots + masks, no index rebasing); every
stage is batched masked arithmetic; frame rejection is a where-select back to
the previous state.  Every function here takes states and tensors with any
leading batch dims (none for one agent, ``[A]`` for a fleet): what the JAX
package got from ``vmap`` is written out.  Sequences are Python loops over
frames.  RANSAC draws are explicit (``scores`` / ``generator``).
"""

from dataclasses import dataclass
from typing import NamedTuple

import torch

from mqslam_tpu_torch import resolve_device
from mqslam_tpu_torch.core import camera as cam_mod, se3, so3
from mqslam_tpu_torch.ops import features, homography, lk, pnp
from mqslam_tpu_torch.ops import triangulation as tri
from mqslam_tpu_torch.utils import cuda_graph, profiling

__all__ = ["TrackerConfig", "TrackerState", "TrackInterm", "StepOutput",
           "make_step", "bootstrap", "make_scan_runner",
           "make_multi_agent_runner"]


@dataclass(frozen=True)
class TrackerConfig:
    """Static tuning parameters."""
    max_tracks: int = 384
    max_landmarks: int = 8192
    target_keypoints: int = 300          # min(300, area/(pi r^2))
    max_of_error: float = 12.0
    max_lost_tracks_ratio: float = 0.5
    coverage_radius: int = 12            # keypoint coverage radius
    corner_quality_level: float = 0.01
    homography_threshold: float = 1.04
    max_pnp_reproj_error: float = 2.0
    max_pnp_outlier_ratio: float = 0.33
    min_triangulated: int = 8
    ransac_hypotheses: int = 128
    lk_win: int = 21
    lk_levels: int = 3
    max_new_landmark_reproj: float = 1.0  # px gate on fresh triangulations


class TrackerState(NamedTuple):
    """Fixed-capacity tracker state (tensors on one device; any leading
    batch dims).  The JAX package's state also carries a PRNG key; here the
    RANSAC draws are arguments of the step."""
    base_uv: torch.Tensor        # [K, 2] position at last keyframe
    cur_uv: torch.Tensor         # [K, 2] position at current frame
    active: torch.Tensor         # [K] bool
    triangulated: torch.Tensor   # [K] bool
    objp_idx: torch.Tensor       # [K] int32 into landmark store
    objp: torch.Tensor           # [M, 3]
    objp_color: torch.Tensor     # [M] f32 sampled base-image intensity
    objp_group: torch.Tensor     # [M] int32
    n_objp: torch.Tensor         # scalar int32
    rvec: torch.Tensor           # [3] current pose (world -> cam)
    tvec: torch.Tensor           # [3]
    rvec_keyfr: torch.Tensor     # [3] last keyframe pose
    tvec_keyfr: torch.Tensor     # [3]
    group_id: torch.Tensor       # scalar int32


class TrackInterm(NamedTuple):
    """Intermediates between the tracking phase and the keyframe phase
    (see make_step: track_phase / kf_phase / finalize)."""
    new_uv: torch.Tensor
    lost_ratio: torch.Tensor
    tri_alive: torch.Tensor
    track_objp: torch.Tensor
    inlier: torch.Tensor
    keep: torch.Tensor
    rejected: torch.Tensor
    reject_code: torch.Tensor
    rvec_f: torch.Tensor
    tvec_f: torch.Tensor
    base_n: torch.Tensor
    new_n: torch.Tensor
    cond: torch.Tensor
    is_kf: torch.Tensor


class StepOutput(NamedTuple):
    """Per-frame results for the host (trajectory + BA bookkeeping)."""
    accepted: torch.Tensor       # int32: 0 rejected, 1 tracked, 2 keyframe
    rvec: torch.Tensor
    tvec: torch.Tensor
    cur_uv: torch.Tensor         # [K, 2] (valid where track_alive)
    track_alive: torch.Tensor    # [K] bool after this frame
    track_triangulated: torch.Tensor  # [K] bool after this frame
    objp_idx: torch.Tensor       # [K]
    pnp_inlier: torch.Tensor     # [K] bool (triangulated tracks used as 2D3D)
    new_landmarks: torch.Tensor  # [K] bool tracks triangulated THIS frame
    n_tracks: torch.Tensor
    lost_ratio: torch.Tensor
    homography_condition: torch.Tensor
    reject_code: torch.Tensor    # 0 ok, 1 lost-tracks, 2 too-few-triangulated,
    #                              3 pnp-outlier-ratio, 4 reprojection-rms


def _take(x, idx):
    """x[..., idx[..., k], :] for x [..., M, D], idx [..., K] -> [..., K, D]."""
    return torch.gather(x, -2, idx.long()[..., None].expand(
        idx.shape + (x.shape[-1],)))


def _put(x, idx, val, mask):
    """x [..., M(, D)] with val [..., K(, D)] written at idx [..., K] where
    mask [..., K]; masked-out rows go to a scratch row that is dropped, so
    the result does not depend on the order duplicate indices are written
    in (the unmasked indices must be unique)."""
    M = x.shape[idx.dim() - 1]
    vec = x.dim() == idx.dim()
    if vec:
        x, val = x[..., None], val[..., None]
    dest = torch.where(mask, idx.long(), torch.full_like(idx, M).long())
    ext = torch.cat([x, torch.zeros_like(x[..., :1, :])], dim=-2)
    ext = ext.scatter(-2, dest[..., None].expand(val.shape), val.to(x.dtype))
    out = ext[..., :M, :]
    return out[..., 0] if vec else out


def bootstrap(uv, objp, cal, img, config: TrackerConfig, device=None):
    """Frame-0 initialization from known 2D-3D correspondences: absolute
    pose (coplanar-safe) + feature refill.  uv [n0, 2], objp [n0, 3], img
    [H, W] (arrays or tensors); the state lives on ``device``."""
    device = resolve_device(device)
    f32 = torch.float32
    uv, objp, img = (torch.as_tensor(x, dtype=f32).to(device)
                     for x in (uv, objp, img))
    cal = cal.to(device)
    K = config.max_tracks
    M = config.max_landmarks
    n0 = uv.shape[0]
    if n0 > K:
        raise ValueError(f"{n0} init points exceed the track capacity {K}")

    uvn = cam_mod.undistort_points(uv, cal)
    R, t = pnp.pnp_solve(objp, uvn)
    rvec0 = so3.log(R)
    rvec, tvec = pnp.pnp_refine(objp, uv, cal, rvec0, t, iters=20)

    base_uv = torch.zeros((K, 2), dtype=f32, device=device)
    base_uv[:n0] = uv
    active = torch.zeros(K, dtype=torch.bool, device=device)
    active[:n0] = True
    objp_idx = torch.zeros(K, dtype=torch.int32, device=device)
    objp_idx[:n0] = torch.arange(n0, dtype=torch.int32, device=device)
    objp_store = torch.zeros((M, 3), dtype=f32, device=device)
    objp_store[:n0] = objp
    objp_color = torch.zeros(M, dtype=f32, device=device)
    objp_color[:n0] = lk.bilinear_sample(img, uv)

    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=device)
    state = TrackerState(
        base_uv=base_uv, cur_uv=base_uv.clone(), active=active,
        triangulated=active.clone(), objp_idx=objp_idx, objp=objp_store,
        objp_color=objp_color,
        objp_group=torch.zeros(M, dtype=torch.int32, device=device),
        n_objp=i32(n0), rvec=rvec, tvec=tvec, rvec_keyfr=rvec.clone(),
        tvec_keyfr=tvec.clone(), group_id=i32(1))
    return _refill(state, img, config, bump_group=False)


def _refill(state: TrackerState, img, config: TrackerConfig,
            bump_group=True):
    """Detect new corners (masked by existing tracks) and place them into
    free slots up to target_keypoints."""
    K = config.max_tracks
    det_uv, det_valid = features.detect_corners(
        img, max_corners=K, quality_level=config.corner_quality_level,
        cell=config.coverage_radius, existing=state.cur_uv,
        existing_valid=state.active)
    n_cur = torch.sum(state.active, dim=-1, keepdim=True)
    to_add = torch.clamp(config.target_keypoints - n_cur, min=0)

    # free slots first (stable order), new detections ranked by response
    free_order = torch.argsort(state.active.to(torch.int32), dim=-1,
                               stable=True)
    n_free = K - n_cur
    det_rank = torch.arange(K, device=img.device)
    det_take = det_valid & (det_rank < torch.minimum(to_add, n_free))
    # detection j -> slot free_order[j]: a permutation, so plain scatters
    put = lambda old, new: torch.scatter(
        old, -1, free_order, torch.where(det_take, new,
                                         torch.gather(old, -1, free_order)))
    new_active = put(state.active, torch.ones_like(det_take))
    new_tri = put(state.triangulated, torch.zeros_like(det_take))
    fo2 = free_order[..., None].expand(det_uv.shape)
    t2 = det_take[..., None]
    new_cur = torch.scatter(state.cur_uv, -2, fo2, torch.where(
        t2, det_uv, torch.gather(state.cur_uv, -2, fo2)))
    new_base = torch.scatter(state.base_uv, -2, fo2, torch.where(
        t2, det_uv, torch.gather(state.base_uv, -2, fo2)))
    added_any = torch.sum(det_take, dim=-1) > 0
    group_id = state.group_id + (1 if bump_group else 0) * added_any.to(
        torch.int32)
    return state._replace(base_uv=new_base, cur_uv=new_cur,
                          active=new_active, triangulated=new_tri,
                          group_id=group_id)


def _select_states(mask, a: TrackerState, b: TrackerState):
    """Per-agent select: b where mask [...] else a."""
    return TrackerState(*(
        torch.where(mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim())),
                    y, x) for x, y in zip(a, b)))


def make_step(cal: cam_mod.Cal3DS2, config: TrackerConfig, device=None):
    """Build the per-frame step closed over calibration + config.

    Returns (step, refill_kf, step_pyr).  ``step(state, prev_img, new_img,
    scores=None, generator=None)`` builds both pyramids; sequential runners
    use the pyramid-reusing ``step_pyr(state, prev_pyr, new_pyr, ...)`` (one
    pyramid build per frame).  ``scores`` [..., n_hyp, K] are the frame's
    RANSAC draws (see ``pnp.pnp_ransac``)."""
    device = resolve_device(device)
    cal = cal.to(device)
    pad = lk.lk_pad(config.lk_win)

    def track_phase(state: TrackerState, new_uv, st_of, err_of, scores=None,
                    generator=None):
        """Per-frame tracking up to the keyframe DECISION: reject ladder,
        RANSAC PnP, pose refinement, homography keyframe test.  Returns the
        intermediates the (rare, expensive) keyframe phase and the finalizer
        consume."""
        alive = state.active & st_of & (err_of < config.max_of_error)
        n_act = torch.sum(state.active, dim=-1)
        lost_ratio = (n_act - torch.sum(alive, dim=-1)) / torch.clamp(
            n_act, min=1)
        reject_lost = lost_ratio > config.max_lost_tracks_ratio

        # ---- 2. PnP on triangulated survivors ----
        tri_alive = alive & state.triangulated
        n_tri = torch.sum(tri_alive, dim=-1)
        reject_few = n_tri < config.min_triangulated

        track_objp = _take(state.objp, state.objp_idx)  # [..., K, 3]
        rvec_r, tvec_r, inlier, n_inl = pnp.pnp_ransac(
            track_objp, new_uv, cal, tri_alive, scores=scores,
            generator=generator, n_hyp=config.ransac_hypotheses,
            reproj_threshold=config.max_pnp_reproj_error)
        outlier_ratio = (n_tri - n_inl) / torch.clamp(n_tri, min=1)
        reject_outl = (outlier_ratio > config.max_pnp_outlier_ratio) | (
            n_inl < config.min_triangulated)

        # ---- 3. refinement on inliers + reprojection gate ----
        rvec_f, tvec_f = pnp.pnp_refine(track_objp, new_uv, cal, rvec_r,
                                        tvec_r, valid=inlier, iters=20)
        rms, _ = pnp.reprojection_error(track_objp, new_uv, cal, rvec_f,
                                        tvec_f, valid=inlier)
        reject_rms = rms > config.max_pnp_reproj_error

        rejected = reject_lost | reject_few | reject_outl | reject_rms

        # tracks kept after PnP: triangulated inliers + all non-triangulated
        keep = (inlier & tri_alive) | (alive & ~state.triangulated)

        # ---- 4. keyframe test ----
        base_n = cam_mod.undistort_points(state.base_uv, cal)
        new_n = cam_mod.undistort_points(new_uv, cal)
        H = homography.fit_homography(base_n, new_n, keep)
        cond = homography.homography_condition(H)
        is_kf = (~rejected) & (cond > config.homography_threshold)

        code = torch.zeros_like(n_tri, dtype=torch.int32)
        for c, flag in ((4, reject_rms), (3, reject_outl), (2, reject_few),
                        (1, reject_lost)):
            code = torch.where(flag, torch.full_like(code, c), code)
        return TrackInterm(
            new_uv=new_uv, lost_ratio=lost_ratio, tri_alive=tri_alive,
            track_objp=track_objp, inlier=inlier, keep=keep,
            rejected=rejected, reject_code=code, rvec_f=rvec_f,
            tvec_f=tvec_f, base_n=base_n, new_n=new_n, cond=cond,
            is_kf=is_kf)

    def kf_phase(state: TrackerState, t: TrackInterm, new_img_padded):
        """Keyframe processing: triangulate new landmarks vs the last
        keyframe, refine the pose on all points, re-triangulate, append to
        the landmark store.  Expensive — runners call it only when a
        keyframe actually fires."""
        M = config.max_landmarks
        P_keyfr = se3.from_rvec_tvec(state.rvec_keyfr, state.tvec_keyfr)
        P_cur = se3.from_rvec_tvec(t.rvec_f, t.tvec_f)
        nontri = t.keep & ~state.triangulated
        # optimal's bool status has no chirality term: check both depths
        x_new, st_tri = tri.optimal(t.base_n, P_keyfr, t.new_n, P_cur)
        d_kf = tri._depth(tri._prep(P_keyfr), x_new)
        d_cu = tri._depth(tri._prep(P_cur), x_new)
        ok1 = nontri & st_tri & (d_kf > 0) & (d_cu > 0)

        # refine pose on inlier-triangulated + freshly triangulated pts
        objp_all = torch.where(ok1[..., None], x_new, t.track_objp)
        use_pts = (t.inlier & t.tri_alive) | ok1
        rvec_kf, tvec_kf = pnp.pnp_refine(objp_all, t.new_uv, cal,
                                          t.rvec_f, t.tvec_f,
                                          valid=use_pts, iters=20)
        # re-triangulate with the refined pose; the reprojection gate below
        # enforces chirality (z > 0 in both views) for this pass
        P_cur2 = se3.from_rvec_tvec(rvec_kf, tvec_kf)
        x_new2, st_tri2 = tri.optimal(t.base_n, P_keyfr, t.new_n, P_cur2)
        ok2 = ok1 & st_tri2

        # quality gate on the NEW landmarks: both-view reprojection must
        # close to within max_new_landmark_reproj px (short-baseline
        # keyframe pairs otherwise inject noisy depths that skew every
        # later PnP)
        def _reproj_ok2(x, P, uvn, thr2):
            Xc = torch.sum(P[..., None, :3, :3] * x[..., None, :], dim=-1) \
                + P[..., None, :3, 3]
            z = Xc[..., 2]
            uv = Xc[..., :2] / torch.clamp(z[..., None], min=1e-6)
            return (z > 1e-6) & (torch.sum((uv - uvn) ** 2, dim=-1) < thr2)

        thr_n = config.max_new_landmark_reproj / torch.abs(cal.fx)
        ok2 = (ok2 & _reproj_ok2(x_new2, P_keyfr, t.base_n, thr_n ** 2)
               & _reproj_ok2(x_new2, P_cur2, t.new_n, thr_n ** 2))

        # landmark store append (capped at M); tracks that cannot store
        # write nowhere (see _put), so slot M-1 belongs to the landmark
        # that lands there
        new_rank = torch.cumsum(ok2.to(torch.int32), dim=-1) - 1
        dest = (state.n_objp[..., None] + new_rank).to(torch.int32)
        can_store = ok2 & (dest < M)
        dest_safe = torch.where(can_store, dest,
                                torch.full_like(dest, M - 1))
        objp_store = _put(state.objp, dest_safe, x_new2, can_store)
        # this frame becomes the new base image, so sampling it at the
        # tracked positions gives the landmark colors drift-free
        color_new = lk.bilinear_sample(new_img_padded, t.new_uv + pad)
        objp_color = _put(state.objp_color, dest_safe, color_new, can_store)
        objp_group = _put(state.objp_group, dest_safe,
                          state.group_id[..., None].expand(dest.shape),
                          can_store)
        n_objp_new = state.n_objp + torch.sum(can_store, dim=-1).to(
            torch.int32)

        # at a keyframe: drop non-triangulated failed tracks
        keep_kf = (t.inlier & t.tri_alive) | can_store
        return (rvec_kf, tvec_kf, objp_store, objp_color, objp_group,
                n_objp_new, can_store, dest_safe, keep_kf)

    def no_kf_phase(state: TrackerState, t: TrackInterm):
        M = config.max_landmarks
        return (t.rvec_f, t.tvec_f, state.objp, state.objp_color,
                state.objp_group, state.n_objp,
                torch.zeros_like(t.keep),
                torch.full_like(state.objp_idx, M - 1), t.keep)

    def finalize(state: TrackerState, t: TrackInterm, kf_out):
        """Assemble the three outcomes (keyframe / accepted / rejected)."""
        (rvec_kf, tvec_kf, objp_store, objp_color, objp_group, n_objp_new,
         can_store, dest_safe, keep_kf) = kf_out
        is_kf, rejected = t.is_kf, t.rejected
        kf1, rej1 = is_kf[..., None], rejected[..., None]
        kf2, rej2 = kf1[..., None], rej1[..., None]

        def sel(kf_val, acc_val, rej_val):
            return torch.where(kf1, kf_val,
                               torch.where(rej1, rej_val, acc_val))

        new_state = TrackerState(
            base_uv=torch.where(kf2, t.new_uv, state.base_uv),
            cur_uv=torch.where(rej2, state.cur_uv, t.new_uv),
            active=sel(keep_kf, t.keep, state.active),
            triangulated=torch.where(kf1, state.triangulated | can_store,
                                     state.triangulated),
            objp_idx=torch.where(kf1 & can_store,
                                 dest_safe.to(torch.int32), state.objp_idx),
            objp=torch.where(kf2, objp_store, state.objp),
            objp_color=torch.where(kf1, objp_color, state.objp_color),
            objp_group=torch.where(kf1, objp_group, state.objp_group),
            n_objp=torch.where(is_kf, n_objp_new, state.n_objp),
            rvec=sel(rvec_kf, t.rvec_f, state.rvec),
            tvec=sel(tvec_kf, t.tvec_f, state.tvec),
            rvec_keyfr=torch.where(kf1, rvec_kf, state.rvec_keyfr),
            tvec_keyfr=torch.where(kf1, tvec_kf, state.tvec_keyfr),
            group_id=state.group_id,
        )
        one = torch.ones_like(state.n_objp)
        out = StepOutput(
            accepted=torch.where(rejected, 0 * one,
                                 torch.where(is_kf, 2 * one, one)),
            rvec=new_state.rvec, tvec=new_state.tvec,
            cur_uv=new_state.cur_uv,
            track_alive=new_state.active,
            track_triangulated=new_state.triangulated,
            objp_idx=new_state.objp_idx,
            pnp_inlier=t.inlier & t.tri_alive,
            new_landmarks=kf1 & can_store,
            n_tracks=torch.sum(new_state.active, dim=-1),
            lost_ratio=t.lost_ratio,
            homography_condition=t.cond,
            reject_code=t.reject_code,
        )
        return new_state, out

    def post_flow(state: TrackerState, new_img_padded, new_uv, st_of,
                  err_of, scores=None, generator=None):
        """Everything after optical flow: reject ladder, PnP, keyframe
        logic.  ``any(is_kf)`` is read back to the host and the keyframe
        phase skipped when no keyframe fired; ``finalize`` selects by
        ``is_kf``, so skipping changes no number."""
        t = track_phase(state, new_uv, st_of, err_of, scores, generator)
        if bool(t.is_kf.any()):
            kf_out = kf_phase(state, t, new_img_padded)
        else:
            kf_out = no_kf_phase(state, t)
        return finalize(state, t, kf_out)

    post_flow.track_phase = track_phase
    post_flow.kf_phase = kf_phase
    post_flow.no_kf_phase = no_kf_phase
    post_flow.finalize = finalize

    def step_pyr(state: TrackerState, prev_pyr, new_pyr, scores=None,
                 generator=None, clock=None):
        """Per-frame step of ONE agent over pyramids pre-padded by
        ``lk.lk_pad(win)`` (build via lk.build_pyramid(img, levels, pad)).
        ``clock`` (a ``profiling.Stages``) is marked after the flow and
        after the rest."""
        new_uv, st_of, err_of = lk.lk_track_pyr(
            prev_pyr, new_pyr, state.cur_uv, state.active,
            win=config.lk_win, prepad=True)
        if clock is not None:
            clock.mark("lk")
        res = post_flow(state, new_pyr[0], new_uv, st_of, err_of, scores,
                        generator)
        if clock is not None:
            clock.mark("track_keyframe")
        return res

    step_pyr.post_flow = post_flow

    def step(state: TrackerState, prev_img, new_img, scores=None,
             generator=None):
        pyr = lambda im: lk.build_pyramid(
            torch.as_tensor(im, dtype=torch.float32).to(device),
            config.lk_levels, pad=pad)
        return step_pyr(state, pyr(prev_img), pyr(new_img), scores,
                        generator)

    def refill_kf(state: TrackerState, new_img):
        """Feature refill — run after a keyframe step (accepted == 2)."""
        return _refill(state, new_img, config, bump_group=True)

    return step, refill_kf, step_pyr


def make_scan_runner(cal: cam_mod.Cal3DS2, config: TrackerConfig,
                     device=None):
    """Whole-sequence runner for one agent: a loop of step (+ keyframe
    refill) over a device-resident image stack; each frame pays exactly one
    ``build_pyramid``.

    Returns fn: (state, imgs [T+1, H, W], ransac_scores=None [T, n_hyp, K],
    generator=None) -> (final_state, (accepted [T], rvec [T, 3], tvec))."""
    device = resolve_device(device)
    _, _, step_pyr = make_step(cal, config, device)
    pad = lk.lk_pad(config.lk_win)

    @torch.no_grad()
    def run(state: TrackerState, imgs, ransac_scores=None, generator=None):
        imgs = torch.as_tensor(imgs, dtype=torch.float32).to(device)
        state = TrackerState(*(x.to(device) for x in state))
        prev_pyr = lk.build_pyramid(imgs[0], config.lk_levels, pad=pad)
        outs = []
        for idx in range(imgs.shape[0] - 1):
            new_img = imgs[idx + 1]
            new_pyr = lk.build_pyramid(new_img, config.lk_levels, pad=pad)
            sc = None if ransac_scores is None else \
                torch.as_tensor(ransac_scores[idx]).to(device)
            state, out = step_pyr(state, prev_pyr, new_pyr, sc, generator)
            if bool(out.accepted == 2):
                state = _refill(state, new_img, config)
            prev_pyr = new_pyr
            outs.append((out.accepted, out.rvec, out.tvec))
        return state, tuple(torch.stack(x) for x in zip(*outs))

    return run


def make_multi_agent_runner(cal: cam_mod.Cal3DS2, config: TrackerConfig,
                            collect: bool = False, device=None):
    """Whole-sequence runner for A agents tracked concurrently — the
    multi-quadrotor throughput path.  Per frame-group: one atlas pyramid,
    ONE LK call for all agents' tracks (three launches of the level
    kernel), then the batched track phase, keyframe phase and refill.

    Returns fn: (states [A-stacked], imgs [A, T+1, H, W],
    ransac_scores=None [T, A, n_hyp, K], generator=None, stage_ms=None) ->
    (final states, per-frame (accepted [T, A], rvec [T, A, 3], tvec)).

    The keyframe phase and the refill are skipped on frame-groups where no
    agent keyframed, at one host read-back of ``any(is_kf)`` each.
    ``stage_ms`` (a dict) receives accumulated milliseconds per stage
    (``pyramid``, ``lk``, ``track_phase``, ``keyframe_refill``); asking for
    it synchronizes after every stage.

    While tracing is on (``utils.profiling``), each call records the spans
    ``fleet.group`` (the call), ``fleet.upload`` (frames and states to the
    device), ``fleet.pyramid`` (each atlas build: the previous frame's and
    the new one's), ``fleet.lk``, ``fleet.track_phase``, ``fleet.kf_gate``
    (the ``any(is_kf)`` read-back) and, on groups where an agent keyframed,
    ``fleet.keyframe`` (the keyframe phase, finalize and the refill).

    The track phase and the keyframe branch (``kf_phase``, ``finalize``,
    the refill and the per-agent select: ``run.kf_branch``) each go through
    a ``utils.cuda_graph.Graphed``: on a card, one CUDA graph captured on
    the first frame-group of each shape (the first keyframe group, for the
    branch) and replayed, inside the span ``fleet.track_graph`` or
    ``fleet.kf_graph``, on every one after it; elsewhere, the function run
    eagerly.  The track phase is many thousands of small kernels, which the
    host would otherwise launch one by one.  Its RANSAC draw
    (``pnp.ransac_draw``) is made before the call, as ``pnp_ransac`` makes
    it, so the graph's outputs are bit-equal to the eager phase's.  Each
    keyframe group's returned outputs, and the states the call returns, are
    copies: nothing the runner returns is a buffer of either graph.

    ``collect=True`` appends the per-frame track-level outputs (cur_uv,
    track_alive, track_triangulated, new_landmarks, pnp_inlier, objp_idx)
    from which each agent's BA data can be reconstructed on the host."""
    device = resolve_device(device)
    _, _, step_pyr = make_step(cal, config, device)
    pad = lk.lk_pad(config.lk_win)
    pf = step_pyr.post_flow
    K = config.max_tracks
    n_st, n_t = len(TrackerState._fields), len(TrackInterm._fields)
    returned = ("accepted", "rvec", "tvec") + (
        ("cur_uv", "track_alive", "track_triangulated", "new_landmarks",
         "pnp_inlier", "objp_idx") if collect else ())

    def kf_branch(*args):
        """(state fields, track-phase fields, tiles0, new) -> (states,
        StepOutput) of a frame-group where some agent keyframed."""
        states = TrackerState(*args[:n_st])
        t = TrackInterm(*args[n_st:n_st + n_t])
        tiles0, new = args[n_st + n_t:]
        states, out = pf.finalize(states, t, pf.kf_phase(states, t, tiles0))
        # full-image corner detection per agent is the most expensive op
        # of the body: only on frame-groups where SOME agent keyframed
        return _select_states(out.accepted == 2, states,
                              _refill(states, new, config)), out

    def track(active, triangulated, objp, objp_idx, base_uv, new_uv, st_of,
              err_of, scores):
        # the fields the track phase reads; the others cannot be read
        st = TrackerState._make([None] * n_st)
        st = st._replace(active=active, triangulated=triangulated, objp=objp,
                         objp_idx=objp_idx, base_uv=base_uv)
        return pf.track_phase(st, new_uv, st_of, err_of, scores)

    graphed = cuda_graph.Graphed(track, device, "fleet.track_graph")
    kf_graphed = cuda_graph.Graphed(kf_branch, device, "fleet.kf_graph")

    def atlas_pyramid(imgs_a):
        """[A, H, W] -> per-level [A*Hp, Wp] vertical atlases (each tile
        pre-padded): one shared image per level lets ALL agents' tracks go
        through a single LK call."""
        return [l.reshape(l.shape[0] * l.shape[1], l.shape[2])
                for l in lk.build_pyramid(imgs_a, config.lk_levels, pad=pad)]

    @torch.no_grad()
    def run(states: TrackerState, imgs, ransac_scores=None, generator=None,
            stage_ms=None):
        with profiling.span("fleet.group", device):
            return _run(states, imgs, ransac_scores, generator, stage_ms)

    run.kf_branch = kf_branch

    def _run(states, imgs, ransac_scores, generator, stage_ms):
        with profiling.span("fleet.upload", device):
            imgs = torch.as_tensor(imgs, dtype=torch.float32).to(device)
            states = TrackerState(*(x.to(device) for x in states))
        A = imgs.shape[0]
        clock = profiling.Stages(stage_ms, device)
        with profiling.span("fleet.pyramid", device):
            prev_atlas = atlas_pyramid(imgs[:, 0])
        outs, keyframed = [], False
        for idx in range(imgs.shape[1] - 1):
            clock.mark()
            new = imgs[:, idx + 1]
            with clock.span("fleet.pyramid", "pyramid"):
                new_atlas = atlas_pyramid(new)
            with clock.span("fleet.lk", "lk"):
                new_uv, st_of, err_of = lk.lk_track_pyr(
                    prev_atlas, new_atlas, states.cur_uv.reshape(A * K, 2),
                    states.active.reshape(A * K), win=config.lk_win,
                    prepad=True, atlas_tiles=A, atlas_contiguous=True)
            with clock.span("fleet.track_phase", "track_phase"):
                if ransac_scores is None:
                    sc = pnp.ransac_draw(A, config.ransac_hypotheses, K,
                                         states.objp.dtype, device, generator)
                else:
                    sc = torch.as_tensor(ransac_scores[idx]).to(device)
                t = graphed(states.active, states.triangulated, states.objp,
                            states.objp_idx, states.base_uv,
                            new_uv.reshape(A, K, 2), st_of.reshape(A, K),
                            err_of.reshape(A, K), sc)
            # per-agent padded level-0 tiles for the keyframe color sampling
            tiles0 = new_atlas[0].reshape(A, -1, new_atlas[0].shape[1])
            with profiling.span("fleet.kf_gate", device, drained=True):
                any_kf = bool(t.is_kf.any())
            # the keyframe span covers kf_phase, finalize, the refill and
            # the copy-out; the stage runs from the track phase's end on
            # every group
            with clock.span("fleet.keyframe" if any_kf else None,
                            "keyframe_refill"):
                if not any_kf:
                    states, out = pf.finalize(states, t,
                                              pf.no_kf_phase(states, t))
                else:
                    states, out = kf_graphed(*states, *t, tiles0, new)
                    # on a card the next replay overwrites the outputs
                    out = out._replace(**{k: getattr(out, k).clone()
                                          for k in returned})
                    keyframed = True
            outs.append(tuple(getattr(out, k) for k in returned))
            prev_atlas = new_atlas
        if keyframed:
            # the states of a keyframe group are the graph's outputs on a
            # card, and finalize passes group_id through the groups after it
            states = TrackerState(*(x.clone() for x in states))
        return states, tuple(torch.stack(x) for x in zip(*outs))

    return run
