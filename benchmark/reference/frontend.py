"""The front-end's judge: what the timed path produced against the plain
reference, stage by stage from the program's own state.

A case is one agent's frame: the two images the program was handed, the
tracks it went in with (positions, which were active, which triangulated
and onto which landmark), its pose before the frame and its last
keyframe's, and its answer: the accept flag, the tracked positions and
which tracks it kept, its PnP inliers, its pose, and the landmarks it
triangulated.  The reference

* tracks the same points on the same images with the plain LK of
  ``reference/lk.py`` (float32, the configuration's precision) and takes
  the largest distance to the program's tracked positions
  (``flow_gap_px``); the share of compared tracks whose survival differs
  (``flow_status_share``) is reported beside, not compared: the control
  does not separate it from sound runs;
* takes the accept decision from its own flows and its own float64 pose
  with its own inliers (within the reprojection threshold), by the
  tracker's reject ladder (lost-track ratio, triangulated survivors,
  outlier ratio, reprojection RMS), and counts the frames where it
  differs from the program's (``accept_mismatch``, an exact comparison);
* solves the pose in float64 over the program's inliers at the program's
  tracked positions and takes the largest pixel distance between the two
  poses' projections of those landmarks (``pose_gap_px``);
* triangulates each landmark the program added in float64 from the
  keyframe's and this frame's observations at the program's poses, and
  takes the largest distance to the program's landmark over its depth
  (``landmark_gap_rel``);
* chooses, on each keyframe, which landmarks the keyframe adds by the
  tracker's rule from the same state: every active track that is not yet
  triangulated and that its own flows keep, triangulated in float64 from
  the keyframe's observation and its own tracked position at the
  keyframe's pose and its own float64 pose (the one its accept decision
  takes), kept where it lies in front of both views and reprojects into
  both within ``max_new_landmark_reproj`` pixels
  (over ``fx``, in normalised coordinates, as the tracker measures it),
  as far as the landmark store holds them; and counts the tracks on which
  its choice and the program's differ, over the number it chose
  (``landmark_set_gap``).

``bootstrap_gap`` checks the start, which the cases skip, by itself.
``control_answers`` is the lower-precision control: the same reference
put in the program's place and computed in bfloat16 (LK windows and sums,
pose and triangulation arithmetic, the choice of new landmarks), judged
the same way; stage by stage as the judge is, it places the landmarks the
program chose.  Imports nothing
of the program.
"""

import numpy as np
import torch

from benchmark.reference import geometry, lk

__all__ = ["judge", "control_answers", "bootstrap_gap", "NUMBERS"]

NUMBERS = ("flow_gap_px", "accept_mismatch", "pose_gap_px",
           "landmark_gap_rel", "landmark_set_gap")

F64 = torch.float64


def _stack(cases, key, dev, dtype=None):
    x = torch.stack([torch.as_tensor(c[key]) for c in cases]).to(dev)
    return x if dtype is None else x.to(dtype)


def _ref_track(cases, tracker, dev, dtype):
    prev = _stack(cases, "prev_img", dev, torch.float32)
    new = _stack(cases, "new_img", dev, torch.float32)
    L = tracker["lk_levels"]
    uv, st, err = lk.track(lk.pyramid(prev, L), lk.pyramid(new, L),
                           _stack(cases, "prev_uv", dev, torch.float32),
                           _stack(cases, "active", dev), win=tracker["lk_win"],
                           dtype=dtype)
    return uv, st & (err < tracker["max_of_error"])


def _poses(cases, key, dev):
    return (_stack(cases, key + "_R", dev, F64),
            _stack(cases, key + "_t", dev, F64))


def _worst(x):
    """The largest value of x, a NaN counting as infinite."""
    return float(torch.nan_to_num(x, nan=float("inf")).max())


def _block(cases, answers, camera, tracker, dev):
    """The numbers of one block of cases (same image size)."""
    K4 = torch.tensor([camera["fx"], camera["fy"], camera["cx"],
                       camera["cy"]], dtype=F64, device=dev)
    ref_uv, ref_alive = _ref_track(cases, tracker, dev, torch.float32)
    acc = _stack(answers, "accepted", dev)
    uv = _stack(answers, "uv", dev, torch.float32)
    alive = _stack(answers, "alive", dev)
    active = _stack(cases, "active", dev)
    tri = _stack(cases, "triangulated", dev)
    inl = _stack(cases, "inlier", dev)
    X = _stack(cases, "landmark", dev, F64)
    is_kf = acc == 2
    ok = acc != 0

    # ---- flows ----
    tracked = active & alive & ok[:, None]
    both = tracked & ref_alive
    gap = torch.where(both, (uv - ref_uv).norm(dim=-1),
                      torch.zeros_like(uv[..., 0]))
    gap = torch.where(tracked & ~torch.isfinite(uv).all(-1),
                      torch.full_like(gap, float("inf")), gap)
    # kept by the program, lost by the reference; and (on a plain tracked
    # frame) the reverse for tracks that are not triangulated, whose
    # survival is the flow's alone
    flips = (tracked & ~ref_alive).sum(-1) + (
        (ok & ~is_kf)[:, None] & active & ~tri & ref_alive & ~alive).sum(-1)
    n_cmp = tracked.sum(-1)

    # ---- accept decision from the reference's own flows and pose ----
    n_act = active.sum(-1)
    ref_alive_a = ref_alive & active
    lost = (n_act - ref_alive_a.sum(-1)) / torch.clamp(n_act, min=1)
    tri_alive = ref_alive_a & tri
    n_tri = tri_alive.sum(-1)
    R0, t0 = _poses(cases, "pose_before", dev)
    ruv = ref_uv.to(F64)
    thr = tracker["max_pnp_reproj_error"]

    def fit(mask, R, t):
        R, t = geometry.pose_gauss_newton(X, ruv, mask.to(F64), R, t, K4)
        d2 = ((geometry.project(R, t, X, K4) - ruv) ** 2).sum(-1)
        return R, t, torch.where(mask, d2, torch.zeros_like(d2))

    Rr, tr, d2 = fit(tri_alive, R0, t0)
    inl_ref = tri_alive & (d2 < thr * thr)
    Rr, tr, d2 = fit(inl_ref, Rr, tr)
    n_inl = inl_ref.sum(-1)
    rms = torch.sqrt(d2.sum(-1) / torch.clamp(n_inl, min=1))
    outl = (n_tri - n_inl) / torch.clamp(n_tri, min=1)
    ref_ok = ~((lost > tracker["max_lost_tracks_ratio"])
               | (n_tri < tracker["min_triangulated"])
               | (outl > tracker["max_pnp_outlier_ratio"])
               | (n_inl < tracker["min_triangulated"])
               | (rms > thr))
    mismatch = (ref_ok != ok).sum()

    # ---- pose over the program's inliers at its tracked positions ----
    Rp, tp = _stack(answers, "R", dev, F64), _stack(answers, "t", dev, F64)
    new = _stack(answers, "new", dev) & is_kf[:, None]
    Xn = _stack(answers, "new_X", dev, F64)
    Xall = torch.where(new[..., None], Xn, X)
    wp = ((inl & tri & alive) | new) & ok[:, None]
    Rg, tg = geometry.pose_gauss_newton(Xall, uv.to(F64), wp.to(F64), R0, t0,
                                        K4)
    pg = (geometry.project(Rp, tp, Xall, K4)
          - geometry.project(Rg, tg, Xall, K4)).norm(dim=-1)
    pg = torch.where(wp, pg, torch.zeros_like(pg))

    # ---- new landmarks: positions of those the program chose ----
    Rk, tk = _poses(cases, "pose_keyframe", dev)
    base_all = _stack(cases, "base_uv", dev, F64)
    chosen = torch.stack([c["answer"]["new"] for c in cases]).to(dev) \
        & is_kf[:, None]
    lgap = torch.zeros((), dtype=F64, device=dev)
    n_new = int(chosen.sum())
    if n_new:
        b, k = torch.nonzero(chosen, as_tuple=True)
        Xr = geometry.triangulate(_norm(base_all[b, k], K4), Rk[b], tk[b],
                                  _norm(uv.to(F64)[b, k], K4), Rp[b], tp[b])
        centre = -(Rp[b].transpose(1, 2) @ tp[b][..., None])[..., 0]
        depth = (Xr - centre).norm(dim=-1)
        lgap = (Xn[b, k] - Xr).norm(dim=-1) / depth

    # ---- which landmarks each keyframe adds, at the reference's pose ----
    ref_new = _chosen(active & ~tri & ref_alive & is_kf[:, None],
                      base_all, ruv, (Rk, tk), (Rr, tr),
                      _stack(cases, "n_objp", dev), K4, tracker)
    return dict(flow_gap_px=_worst(gap),
                flow_flips=int(flips.sum()), flow_compared=int(n_cmp.sum()),
                accept_mismatch=int(mismatch), pose_gap_px=_worst(pg),
                landmark_gap_rel=_worst(lgap), new_landmarks=n_new,
                new_chosen=int(ref_new.sum()),
                new_differ=int((ref_new != new).sum()),
                cases=len(cases), accepted=int(ok.sum()),
                keyframes=int(is_kf.sum()))


def _norm(p, K4):
    """Normalised image coordinates of pixels p [..., 2]."""
    return torch.stack([(p[..., 0] - K4[2]) / K4[0],
                        (p[..., 1] - K4[3]) / K4[1]], -1)


def _chosen(cand, base_uv, cur_uv, keyframe, pose, n_objp, K4, tracker):
    """[B, K] the candidate tracks that a keyframe turns into landmarks:
    triangulated from ``base_uv`` (the keyframe's observation) and
    ``cur_uv`` at the keyframe's and the current world-to-camera poses,
    in front of both views and within the reprojection gate in both, in
    slot order as far as the store (``n_objp`` used of
    ``max_landmarks``) holds them; in the dtype of the inputs."""
    chosen = torch.zeros_like(cand)
    if not bool(cand.any()):
        return chosen
    b, k = torch.nonzero(cand, as_tuple=True)
    (Rk, tk), (Rc, tc) = keyframe, pose
    x1, x2 = _norm(base_uv[b, k], K4), _norm(cur_uv[b, k], K4)
    X = geometry.triangulate(x1, Rk[b], tk[b], x2, Rc[b], tc[b])
    thr = tracker["max_new_landmark_reproj"] / abs(float(K4[0]))
    ok = torch.ones_like(b, dtype=torch.bool)
    for R, t, x in ((Rk[b], tk[b], x1), (Rc[b], tc[b], x2)):
        Xc = (R @ X[..., None])[..., 0] + t
        z = Xc[:, 2]
        proj = Xc[:, :2] / torch.clamp(z[:, None], min=1e-6)
        ok = ok & (z > 1e-6) & (((proj - x) ** 2).sum(-1) < thr * thr)
    chosen[b, k] = ok
    rank = torch.cumsum(chosen.to(torch.int64), dim=-1) - 1
    return chosen & (n_objp[:, None].to(torch.int64) + rank
                     < tracker["max_landmarks"])


def _blocks(cases, answers, block):
    by_shape = {}
    for c, a in zip(cases, answers):
        by_shape.setdefault(tuple(c["prev_img"].shape), []).append((c, a))
    for items in by_shape.values():
        for i in range(0, len(items), block):
            part = items[i:i + block]
            yield [c for c, _ in part], [a for _, a in part]


def judge(cases, camera, tracker, device, answers=None, block=16):
    """The compared numbers over all cases (``answers``: the program's,
    from the cases, unless given) and the counts they were taken over."""
    answers = [c["answer"] for c in cases] if answers is None else answers
    tot = dict(flow_gap_px=0.0, flow_flips=0, flow_compared=0,
               accept_mismatch=0, pose_gap_px=0.0, landmark_gap_rel=0.0,
               new_landmarks=0, new_chosen=0, new_differ=0, cases=0,
               accepted=0, keyframes=0)
    with torch.no_grad():
        for cs, ans in _blocks(cases, answers, block):
            r = _block(cs, ans, camera, tracker, device)
            for k, v in r.items():
                tot[k] = max(tot[k], v) if k.endswith(("_px", "_rel")) \
                    else tot[k] + v
    tot["flow_status_share"] = tot.pop("flow_flips") / max(
        tot["flow_compared"], 1)
    tot["landmark_set_gap"] = tot["new_differ"] / max(tot["new_chosen"], 1)
    return tot


def control_answers(cases, camera, tracker, device, block=16):
    """Answers of the reference computed in bfloat16 in the program's
    place, from the same cases: its own flows, its pose over the
    program's inlier set, its own choice of new landmarks by the
    tracker's rule, the positions of those the program chose; accept
    flags as the program's (the control is judged on the numbers it
    computes)."""
    bf = torch.bfloat16
    out = []
    with torch.no_grad():
        for cs, _ in _blocks(cases, [None] * len(cases), block):
            dev = device
            K4 = torch.tensor([camera["fx"], camera["fy"], camera["cx"],
                               camera["cy"]], dtype=bf, device=dev)
            uv, alive = _ref_track(cs, tracker, dev, bf)
            inl = _stack(cs, "inlier", dev) & _stack(cs, "triangulated", dev)
            X = _stack(cs, "landmark", dev, bf)
            R0 = _stack(cs, "pose_before_R", dev, bf)
            t0 = _stack(cs, "pose_before_t", dev, bf)
            w = (inl & alive).to(bf)
            R, t = geometry.pose_gauss_newton(X, uv.to(bf), w, R0, t0, K4)
            Rk = _stack(cs, "pose_keyframe_R", dev, bf)
            tk = _stack(cs, "pose_keyframe_t", dev, bf)
            base = _stack(cs, "base_uv", dev, bf)
            kf = torch.stack([c["answer"]["accepted"] == 2
                              for c in cs]).to(dev)
            active = _stack(cs, "active", dev)
            tri = _stack(cs, "triangulated", dev)
            new = _chosen(active & ~tri & alive & kf[:, None], base,
                          uv.to(bf), (Rk, tk), (R, t),
                          _stack(cs, "n_objp", dev), K4, tracker)
            placed = torch.stack([c["answer"]["new"] for c in cs]).to(dev)
            Xn = torch.zeros(new.shape + (3,), dtype=bf, device=dev)
            if bool(placed.any()):
                b, k = torch.nonzero(placed, as_tuple=True)
                Xn[b, k] = geometry.triangulate(
                    _norm(base[b, k], K4), Rk[b], tk[b],
                    _norm(uv[b, k].to(bf), K4), R[b], t[b])
            for i, c in enumerate(cs):
                out.append(dict(
                    accepted=c["answer"]["accepted"],
                    uv=uv[i].float().cpu(), alive=alive[i].cpu(),
                    R=R[i].double().cpu(), t=t[i].double().cpu(),
                    new=new[i].cpu(), new_X=Xn[i].double().cpu()))
    return out


def bootstrap_gap(boots, camera, device, dtype=F64):
    """The start, by itself: for each bootstrap (frame 0's 2D-3D pairs
    ``uv`` [n, 2], ``objp`` [n, 3], the program's pose ``R``, ``t`` and the
    true pose ``R_true``, ``t_true`` it is solved from), the largest pixel
    distance between the program's projections of its points and those of
    the pose Gauss-Newton finds from the truth over the same pairs, in
    ``dtype`` (float64: the reference; bfloat16: the control, whose own
    pose is then compared with the float64 one)."""
    worst = 0.0
    K = torch.tensor([camera["fx"], camera["fy"], camera["cx"],
                      camera["cy"]], dtype=F64, device=device)
    for b in boots:
        g = lambda k, d=F64: torch.as_tensor(b[k]).to(device, d)[None]
        w = torch.ones(g("uv").shape[:2], dtype=F64, device=device)
        R, t = geometry.pose_gauss_newton(g("objp"), g("uv"), w, g("R_true"),
                                          g("t_true"), K)
        if dtype == F64:
            Rp, tp = g("R"), g("t")
        else:
            Rp, tp = geometry.pose_gauss_newton(
                g("objp", dtype), g("uv", dtype), w.to(dtype),
                g("R_true", dtype), g("t_true", dtype), K.to(dtype))
        X = g("objp")
        gap = (geometry.project(Rp.to(F64), tp.to(F64), X, K)
               - geometry.project(R, t, X, K)).norm(dim=-1)
        worst = max(worst, _worst(gap))
    return worst


def case_from_arrays(prev_img, new_img, prev_uv, active, triangulated,
                     landmark, inlier, base_uv, pose_before, pose_keyframe,
                     n_objp, answer):
    """One case from host arrays; poses as (R [3, 3], t [3]) world to
    camera; ``n_objp`` the landmarks stored before the frame; ``answer`` a
    dict with accepted, uv, alive, R, t, new, new_X."""
    t = lambda x, d=None: torch.as_tensor(np.asarray(x), dtype=d)
    return dict(prev_img=t(prev_img), new_img=t(new_img),
                prev_uv=t(prev_uv, torch.float32),
                active=t(active, torch.bool),
                triangulated=t(triangulated, torch.bool),
                landmark=t(landmark, F64), inlier=t(inlier, torch.bool),
                base_uv=t(base_uv, F64),
                pose_before_R=t(pose_before[0], F64),
                pose_before_t=t(pose_before[1], F64),
                pose_keyframe_R=t(pose_keyframe[0], F64),
                pose_keyframe_t=t(pose_keyframe[1], F64),
                n_objp=torch.tensor(int(n_objp)),
                answer=dict(
                    accepted=torch.tensor(int(answer["accepted"])),
                    uv=t(answer["uv"], torch.float32),
                    alive=t(answer["alive"], torch.bool),
                    R=t(answer["R"], F64), t=t(answer["t"], F64),
                    new=t(answer["new"], torch.bool),
                    new_X=t(answer["new_X"], F64)))
