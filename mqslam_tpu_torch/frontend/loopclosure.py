"""Loop-closure detection: ORB place recognition + metric verification.

The reference front-end has no loop closure (drift is handled purely by the
offline BA back-end); this module supplies the missing capability for the
full pipeline "incremental BA + pose-graph loop closure" — appearance-based
candidate retrieval over a keyframe database, geometric verification by
RANSAC PnP against the candidate keyframe's 3D landmarks, and emission of a
BetweenFactor edge for ba.posegraph / the BA graph (same edge semantics as
the reference's odometry constraints, bundle_adjust.cpp:301-309).

The database is one fixed-capacity set of tensors on the device; candidate
scoring is one batched Hamming matmul over ALL stored keyframes at once
(``ops/matching.pairwise_hamming``: [N, Kq, Kd] int32, 151 MB at the bench's
256 x 384), mutual-best + ratio gating done with masked reductions;
verification reuses ``ops.pnp.pnp_ransac`` with explicit draws.
"""

from typing import NamedTuple

import torch

from mqslam_tpu_torch import resolve_device
from mqslam_tpu_torch.core import so3
from mqslam_tpu_torch.core.smallmat import matmul_small, matvec_small
from mqslam_tpu_torch.ops import matching, pnp

__all__ = ["KeyframeDB", "empty_db", "add_keyframe", "loop_scores",
           "best_candidate", "verify_loop", "relative_edge"]


class KeyframeDB(NamedTuple):
    """Fixed-capacity keyframe store (tensors on one device)."""
    desc: torch.Tensor        # [N, K, 32] uint8 ORB descriptors
    desc_valid: torch.Tensor  # [N, K] bool
    uv: torch.Tensor          # [N, K, 2] keypoint pixels
    xyz: torch.Tensor         # [N, K, 3] landmark positions (world)
    xyz_valid: torch.Tensor   # [N, K] bool (descriptor has a 3D point)
    pose: torch.Tensor        # [N, 6] keyframe pose (rvec, center)
    used: torch.Tensor        # [N] bool
    count: torch.Tensor       # scalar int32


def empty_db(capacity: int, k: int, desc_bytes: int = 32, device=None):
    device = resolve_device(device)
    z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)
    return KeyframeDB(
        desc=z((capacity, k, desc_bytes), torch.uint8),
        desc_valid=z((capacity, k), torch.bool),
        uv=z((capacity, k, 2), torch.float32),
        xyz=z((capacity, k, 3), torch.float32),
        xyz_valid=z((capacity, k), torch.bool),
        pose=z((capacity, 6), torch.float32),
        used=z(capacity, torch.bool), count=z((), torch.int32))


def add_keyframe(db: KeyframeDB, desc, desc_valid, uv, xyz, xyz_valid,
                 pose6):
    """Append one keyframe (no-op when the DB is full).

    Writes into ``db``'s preallocated slot IN PLACE — no copy of the store,
    no read back to the host — and returns the DB with the new count."""
    cap = db.desc.shape[0]
    i = torch.clamp(db.count, max=cap - 1).to(torch.int64).reshape(1)
    can = db.count < cap

    def put(store, val):
        old = store.index_select(0, i)
        store.index_copy_(0, i, torch.where(can, val.to(store.dtype)[None],
                                            old))

    for store, val in ((db.desc, desc), (db.desc_valid, desc_valid),
                       (db.uv, uv), (db.xyz, xyz),
                       (db.xyz_valid, xyz_valid), (db.pose, pose6),
                       (db.used, torch.ones((), dtype=torch.bool,
                                            device=db.used.device))):
        put(store, val)
    return db._replace(count=db.count + can.to(torch.int32))


def _hamming_all(q_desc, db_desc):
    """[N, Kq, Kd] Hamming distances of the query against every stored
    keyframe, one batched matmul."""
    return matching.pairwise_hamming(q_desc, db_desc)


def _match_counts(q_desc, q_valid, db_desc, db_valid, max_dist, ratio):
    """[N] number of ratio-test mutual matches query -> each stored KF."""
    d = _hamming_all(q_desc, db_desc)  # [N, Kq, Kd]
    big = 10_000
    d = torch.where(q_valid[None, :, None] & db_valid[:, None, :], d,
                    torch.full_like(d, big))
    # best + second best over the DB axis (ties: first index)
    i1 = torch.argmin(d, dim=2)
    d1 = torch.gather(d, 2, i1[..., None])[..., 0]
    d2 = torch.amin(d.scatter(2, i1[..., None], big), dim=2)
    # mutual: query is also the best for its matched train descriptor
    bwd = torch.argmin(d, dim=1)                          # [N, Kd]
    mutual = torch.gather(bwd, 1, i1) == torch.arange(
        d.shape[1], device=d.device)[None, :]
    good = (d1 <= max_dist) & (d1.to(torch.float32)
                               < ratio * d2.to(torch.float32)) & mutual
    return torch.sum(good & q_valid[None, :], dim=1), i1, good


def loop_scores(db: KeyframeDB, q_desc, q_valid, cur_index,
                min_gap: int = 10, max_dist: int = 64, ratio: float = 0.8):
    """Similarity score of the query against every stored keyframe.

    Keyframes within ``min_gap`` of ``cur_index`` (recency window) and unused
    slots score 0 — loop closure must link to *old* places, not the local
    neighborhood (standard place-recognition gating).  Returns (scores [N],
    i1 [N, Kq] best DB descriptor per query, good [N, Kq])."""
    counts, i1, good = _match_counts(q_desc, q_valid, db.desc,
                                     db.desc_valid, max_dist, ratio)
    idx = torch.arange(db.desc.shape[0], device=counts.device)
    eligible = db.used & (idx <= cur_index - min_gap)
    return torch.where(eligible, counts, torch.zeros_like(counts)), i1, good


def best_candidate(scores, min_matches: int = 20):
    """(index, found) of the best-scoring eligible keyframe (first among
    ties)."""
    i = torch.argmax(scores)
    return i, scores[i] >= min_matches


def verify_loop(db: KeyframeDB, cand, i1, good, q_uv, q_valid, cal,
                scores=None, generator=None,
                reproj_threshold: float = 3.0):
    """Metric verification: RANSAC PnP of the query's 2D points against the
    candidate keyframe's 3D landmarks (via the descriptor matches).

    The minimal sets come from ``scores`` [128, Kq] (uniform draws in
    [0, 1)) or, when None, from ``generator`` (``pnp.pnp_ransac``).
    Returns (rvec, tvec (world->cam of the query), n_inliers, ok)."""
    matches_j = i1[cand]                 # [Kq] candidate landmark per query
    m_ok = good[cand] & q_valid & db.xyz_valid[cand][matches_j]
    objp = db.xyz[cand][matches_j]       # [Kq, 3]
    rvec, tvec, _, n_inl = pnp.pnp_ransac(
        objp, q_uv, cal, m_ok, scores=scores, generator=generator,
        reproj_threshold=reproj_threshold)
    need = (0.4 * torch.sum(m_ok).to(torch.float32)).to(n_inl.dtype)
    ok = n_inl >= torch.clamp(need, min=12)
    return rvec, tvec, n_inl, ok


def relative_edge(pose_i6, rvec_q, tvec_q):
    """BetweenFactor measurement from stored pose i to the verified query
    pose: (meas_r, meas_t) with Exp(meas_r)=R_i^T R_q, meas_t=R_i^T(c_q-c_i).

    pose_i6 is (rvec, center) cam-to-world as in ba/; (rvec_q, tvec_q) is
    the world->cam PnP result (R_q^w2c, t): c_q = -R^T t, R_q^c2w = R^T.
    """
    Ri = so3.exp(pose_i6[:3])
    ci = pose_i6[3:]
    Rq = so3.exp(rvec_q).T              # cam-to-world rotation
    cq = -matvec_small(Rq, tvec_q)      # camera center
    meas_r = so3.log(matmul_small(Ri.T, Rq))
    meas_t = matvec_small(Ri.T, cq - ci)
    return meas_r, meas_t
