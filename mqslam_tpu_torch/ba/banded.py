"""Run-major BANDED observation layout: a gather-free Schur-CG hot loop.

A landmark's observation list is a run of consecutive poses (it is tracked
frame to frame).  Index landmarks by (b, j) — the j-th landmark whose
observation run starts at pose b — and slots by k = obs_pose - b:

    slot grid [F, J, Ks]:   (b, j, k)  <->  observation (pose b+k, point (b,j))

With A_o = Jp_o^T Jt_o (the [6, 3] W-block of one observation) packed once
per linearization into Awt [F, 3J, 6Ks]:

    W^T v:   r[b,j]  = sum_k  A[b,j,k]^T  v[b+k]     -- one batched product
                                                        over SHIFTED copies
                                                        of v (no gather)
    W y:     out[f]  = sum_k  q_k[f-k],
             q_k[b]  = sum_j  A[b,j,k] y[b,j]        -- one batched product
                                                        + a skewed sum
                                                        (no scatter)

and the damped Hpp^-1 is folded into the w-leg table once per solve
attempt, so one CG iteration reads the two tables once each.

Landmarks that don't fit the grid (span > Ks after dropout holes, or
first-seen overflow past J at one pose) go to a LEFTOVER partition with a
dense [F*6, L*3] W-block: Hpp is block-diagonal per landmark, so
``W M W^T = W_b M_b W_b^T + W_l M_l W_l^T`` exactly.  The builder returns
None when the banded fraction or the padding make the grid a loss, and —
unlike the JAX package's builder — when two valid observations fall into
one grid slot (a duplicated (pose, point) pair): the JAX package's last
write wins there, its grid then holds one of the two observations while
its per-pose Grams hold both, and its CG solves an inconsistent system
(ROADMAP Queue 3).  ``solver._auto_layout`` then takes the packed layout,
whose applies sum duplicates consistently.

The CG legs and the preconditioner's block product run as batched matrix
products in full float32 (the solver turns TF32 off around them), where the
JAX package writes broadcast-multiplies and HIGHEST-precision
``dot_general``s: the same sums in another order.  The 3-term folds of the
damped point inverse M into the tables keep the JAX package's written-out
order (``banded_hooks``).

The sharded grid (``ShardedBandedLayout``) splits the base rows into D
pose blocks, one a rank: rank d owns base rows [d*Fb, (d+1)*Fb) and every
observation of every landmark based there, after the observation rows are
permuted device-major (``permute_obs``).  Its CG legs run on local tables
against the replicated state; each [F, 6]-shaped result is summed over the
ranks by one all-reduce (``banded_hooks_sharded``).  The sharded builder
refuses duplicated observations as the single-device one does.
"""

from typing import Callable, NamedTuple

import numpy as np
import torch

from mqslam_tpu_torch.ba.packed import _as_numpy, _i32, _table_device

__all__ = ["BandedLayout", "build_banded_layout", "pack_banded",
           "banded_hooks", "ShardedBandedLayout",
           "build_sharded_banded_layout", "permute_obs",
           "pack_banded_sharded", "banded_hooks_sharded"]


class BandedLayout(NamedTuple):
    """Host-built index grids (see the module docstring); tensors int32."""
    slot_obs: torch.Tensor       # [F, J, Ks] flat obs index per slot
                                 #   (sentinel O)
    slot_point: torch.Tensor     # [F, J] landmark id per grid row
                                 #   (sentinel P)
    point_slot: torch.Tensor     # [P] b*J + j of each banded landmark
                                 #   (sentinel F*J)
    op_ids_banded: torch.Tensor  # [O] obs_pose of banded obs (sentinel F)
    op_ids_left: torch.Tensor    # [O] obs_pose of leftover obs (sentinel F)
    left_pids: torch.Tensor      # [L] global id of each leftover landmark
    left_obs_f: torch.Tensor     # [O] pose row of the dense leftover
    left_obs_col: torch.Tensor   # [O] L-column of the dense leftover
                                 #   (sentinels F / L)
    F: int
    P: int
    J: int
    Ks: int
    n_obs: int
    n_banded: int
    n_left: int

    @property
    def L(self):
        return self.left_pids.shape[0]


def _grid_cost_ms(F, J, Ks, n_left_lms):
    """The JAX package's per-CG-iteration cost model, used only to pick
    (Ks, J): two reads of the grid tables and two of the dense [F*6, L*3]
    leftover block at 819 GB/s, a TPU v5e's memory rate, kept so that the
    port picks the JAX package's grid.  It is not a time on any GPU; the
    rate scales every candidate alike, so the choice does not depend on
    it."""
    by = 2 * F * J * Ks * 18 * 4 + 2 * F * n_left_lms * 18 * 4
    return by / 819e9 * 1e3


def build_banded_layout(obs_pose, obs_point, obs_valid, n_poses: int,
                        n_points: int, max_J: int = 128,
                        min_banded_frac: float = 0.5,
                        max_pad_ratio: float = 6.0, device=None):
    """Host-side build.  Scans Ks candidates, assigns each landmark whose
    observation span fits to the (first_pose, rank) grid slot, overflow and
    long-span landmarks to the dense leftover partition; picks the (Ks, J)
    minimizing the modelled iteration cost.  Returns None when there is no
    valid observation, the banded fraction stays below
    ``min_banded_frac``, the grid pads more than ``max_pad_ratio`` slots per
    banded observation, the dense leftover block would outgrow the grid, or
    two valid observations map to one grid slot.  Tables land on ``device``
    (None: the device of ``obs_pose`` if a tensor, else the CUDA device)."""
    device = _table_device(obs_pose, device)
    op = _as_numpy(obs_pose, np.int64)
    opt = _as_numpy(obs_point, np.int64)
    ov = _as_numpy(obs_valid, bool)
    O = op.shape[0]
    F, P = int(n_poses), int(n_points)
    vop, vopt = op[ov], opt[ov]
    if vop.size == 0:
        return None

    first = np.full(P, F, np.int64)
    last = np.full(P, -1, np.int64)
    np.minimum.at(first, vopt, vop)
    np.maximum.at(last, vopt, vop)
    span = last - first + 1          # <= 0 for unseen landmarks

    best = None
    for Ks in (4, 8, 12, 16):
        fits = (span > 0) & (span <= Ks)
        if not fits.any():
            continue
        cb = np.bincount(first[fits], minlength=F)
        # J at the 99th percentile of non-empty bases: one dense refill
        # frame must not inflate every row of the grid
        J = int(min(max(np.percentile(cb[cb > 0], 99.0), 1), max_J))
        # rank landmarks within their base; rank >= J -> leftover
        pid_fit = np.flatnonzero(fits)
        order = pid_fit[np.argsort(first[pid_fit], kind="stable")]
        rank = np.arange(order.size) - np.repeat(
            np.cumsum(np.concatenate([[0], cb]))[:-1], cb)
        banded_pts = order[rank < J]
        bmask_pt = np.zeros(P, bool)
        bmask_pt[banded_pts] = True
        bobs = ov & bmask_pt[opt]
        n_banded = int(bobs.sum())
        n_valid = int(ov.sum())
        if n_banded < min_banded_frac * n_valid:
            continue
        if F * J * Ks > max_pad_ratio * max(n_banded, 1):
            continue
        n_left_lms = int((~bmask_pt & (span > 0)).sum())
        cost = _grid_cost_ms(F, J, Ks, n_left_lms)
        if best is None or cost < best[0]:
            jslot = np.full(P, 0, np.int64)
            jslot[order] = rank
            best = (cost, Ks, J, bmask_pt.copy(), bobs.copy(),
                    jslot.copy())
    if best is None:
        return None
    _, Ks, J, bmask_pt, bobs, jslot = best

    oi = np.flatnonzero(bobs)
    b = first[opt[oi]]
    k = op[oi] - b
    j = jslot[opt[oi]]
    slot = b * J * Ks + j * Ks + k
    if np.unique(slot).size != slot.size:
        return None                  # a duplicated (pose, point) pair
    slot_obs = np.full(F * J * Ks, O, np.int64)
    slot_obs[slot] = oi
    slot_point = np.full(F * J, P, np.int64)
    pb = np.flatnonzero(bmask_pt)
    slot_point[first[pb] * J + jslot[pb]] = pb
    point_slot = np.full(P, F * J, np.int64)
    point_slot[pb] = first[pb] * J + jslot[pb]

    lmask = ov & ~bobs
    left_pids = np.unique(opt[lmask])
    L = int(left_pids.size)
    # Leftover landmarks are few but can observe many poses (long runs are
    # why they missed the grid): they get a dense [F*6, L*3] W-block, two
    # matrix-vector products an iteration, viable only while that table
    # stays small next to the grid.
    if L * F * 18 * 4 > max(64e6, 2.0 * F * J * Ks * 18 * 4):
        return None
    remap = np.zeros(P, np.int64)
    remap[left_pids] = np.arange(L)
    return BandedLayout(
        slot_obs=_i32(slot_obs.reshape(F, J, Ks), device),
        slot_point=_i32(slot_point.reshape(F, J), device),
        point_slot=_i32(point_slot, device),
        op_ids_banded=_i32(np.where(bobs, op, F), device),
        op_ids_left=_i32(np.where(lmask, op, F), device),
        left_pids=_i32(left_pids, device),
        left_obs_f=_i32(np.where(lmask, op, F), device),
        left_obs_col=_i32(np.where(lmask, remap[opt], L), device),
        F=F, P=P, J=J, Ks=Ks, n_obs=O,
        n_banded=int(bobs.sum()), n_left=int(lmask.sum()))


def _seg_drop(vals, idx, n):
    """segment_sum into ``n`` rows, dropping rows whose index is ``n`` (the
    sentinel), as the JAX package's ``segment_sum`` drops out-of-range
    ids."""
    out = vals.new_zeros((n + 1,) + vals.shape[1:])
    return out.index_add_(0, idx, vals)[:n]


def _skew_full(q):
    """q [F, Ks, ...] -> out [F + Ks, ...] with out[f] = sum_k q[f - k, k]:
    each q[b, k] is written to row b + k, column k of a zero buffer through
    a strided view, then the columns are summed (no scatter)."""
    F, Ks = q.shape[:2]
    rest = q.shape[2:]
    m = int(np.prod(rest, dtype=np.int64))
    buf = q.new_zeros((F + Ks, Ks) + rest)
    buf.as_strided((F, Ks, m), (Ks * m, Ks * m + m, 1)).copy_(
        q.reshape(F, Ks, m))
    return buf.sum(dim=1)


def _skew_sum(q):
    """``_skew_full`` cut to the F rows of q."""
    return _skew_full(q)[:q.shape[0]]


def pack_banded(lin, bl: BandedLayout):
    """Per-linearization tables:

        Awt [F, J*3, Ks*6]   Awt[b, y*J+j, k*6+x] = A[b,j,k][x,y]
        Aw2 [F, Ks*6, J*3]   its (1, 2) transpose

    the per-pose observation Grams split by partition (G_banded, G_left;
    the Hcc-obs leg and the preconditioner), and the dense leftover W-block
    Wd [F*6, L*3] with y-major columns (col = y*L + l)."""
    F, J, Ks, L = bl.F, bl.J, bl.Ks, bl.L
    Jp, Jt = lin.J_obs_pose, lin.J_obs_point          # [O,2,6], [O,2,3]
    A_o = torch.einsum("ocx,ocy->oxy", Jp, Jt)        # [O, 6, 3]
    A_flat = torch.cat([A_o.reshape(-1, 18), A_o.new_zeros((1, 18))])
    G1 = A_flat[bl.slot_obs].reshape(F, J, Ks, 6, 3)
    Awt = G1.permute(0, 4, 1, 2, 3).reshape(F, 3 * J, Ks * 6)
    Aw2 = Awt.transpose(1, 2)
    JTJ = torch.einsum("ocx,ocy->oxy", Jp, Jp)
    G_banded = _seg_drop(JTJ, bl.op_ids_banded, F)
    if L:
        G_left = _seg_drop(JTJ, bl.op_ids_left, F)
        # dense leftover W: one scatter-add of the leftover rows per
        # linearization (the iteration itself never scatters)
        flat = bl.left_obs_f.long() * (L + 1) + bl.left_obs_col.long()
        Zl = _seg_drop(A_o, flat, (F + 1) * (L + 1))
        Wd = Zl.reshape(F + 1, L + 1, 6, 3)[:F, :L].permute(
            0, 2, 3, 1).reshape(F * 6, 3 * L)
    else:
        G_left = torch.zeros_like(G_banded)
        Wd = A_o.new_zeros((F * 6, 0))
    return Awt, Aw2, G_banded, G_left, Wd


class _Hooks(NamedTuple):
    hcc: Callable
    corr: Callable
    w_full: Callable
    wt_full: Callable
    pre: Callable


def banded_hooks(problem, lin, bl: BandedLayout, packedB, Hpp_inv):
    """Closures for the hybrid Schur-CG.  ``Hpp_inv`` is the DAMPED
    per-landmark inverse [P, 3, 3] (masked).  Built once per solve attempt:
    the grid copy of M (one [F*J]-row gather) is folded into the w-leg
    table At2 = Aw2 . M, so each CG iteration is two batched products over
    Awt and At2, with no gather and no scatter.  Call inside
    ``solver._exact_f32`` (TF32 off)."""
    Awt, Aw2, G_banded, G_left, Wd = (packedB if packedB is not None
                                      else pack_banded(lin, bl))
    F, J, Ks, P, L = bl.F, bl.J, bl.Ks, bl.P, bl.L
    G_obs = G_banded + G_left

    # M on the grid as nine [F, J] planes, folded into the w-leg table:
    # At2[b, kx, y*J+j] = sum_z Aw2[b, kx, z*J+j] * M[b, j, z, y].  These
    # 3-term sums (and Dd's below) are written out as the JAX package
    # writes them: M is ill-conditioned for weakly constrained landmarks,
    # the terms cancel, and this order keeps the preconditioner blocks
    # within the COO form's float32 roundoff
    M9 = torch.cat([Hpp_inv.reshape(P, 9),
                    Hpp_inv.new_zeros((1, 9))])[bl.slot_point]   # [F, J, 9]
    Mt = M9.permute(2, 0, 1).reshape(3, 3, F, J)                 # [z, y]
    At2 = torch.cat(
        [sum(Aw2[:, :, z * J:(z + 1) * J] * Mt[z, y][:, None, :]
             for z in range(3)) for y in range(3)], dim=2)       # [F,KX,JY]

    if L:
        # leftover: the damped M folded into the dense block once per
        # attempt (Dd = Wd . blockdiag(M_l)), so its corr is two products
        M_l = Hpp_inv[bl.left_pids]                              # [L, 3, 3]
        Dd = torch.cat(
            [sum(Wd[:, z * L:(z + 1) * L] * M_l[None, :, z, y]
                 for z in range(3)) for y in range(3)], dim=1)

        def l_wt(v):                   # [F, 6] -> [L*3] (y-major)
            return v.reshape(1, F * 6) @ Wd

        def l_apply(table, u3):        # [F6, L3] x [L3] -> [F, 6]
            return (table @ u3.reshape(3 * L, 1)).reshape(F, 6)

    def wt72(v):                       # [F, 6] -> r [F, J*3] (y-major)
        vp = torch.cat([v, v.new_zeros((Ks, 6))])
        V = torch.cat([vp[k:k + F] for k in range(Ks)], dim=1)
        return torch.bmm(Awt, V[:, :, None])[:, :, 0]

    def w72(table, r):                 # [F,KX,JY] x [F,JY] -> [F, 6]
        q = torch.bmm(table, r[:, :, None])[:, :, 0]
        return _skew_sum(q.reshape(F, Ks, 6))

    def hcc(v):
        return torch.bmm(G_obs, v[:, :, None])[:, :, 0]

    def corr(v):                       # W M W^T v: two table passes
        c = w72(At2, wt72(v))
        if L:
            c = c + l_apply(Dd, l_wt(v))
        return c

    def w_full(t):                     # t [P, 3] -> [F, 6] (per solve)
        tb = torch.cat([t, t.new_zeros((1, 3))])[bl.slot_point]  # [F,J,3]
        out = w72(Aw2, tb.transpose(1, 2).reshape(F, 3 * J))
        if L:
            out = out + l_apply(Wd, t[bl.left_pids].T.reshape(3 * L))
        return out

    def wt_full(v):                    # [F, 6] -> [P, 3] (per solve)
        r = wt72(v).reshape(F, 3, J).transpose(1, 2).reshape(F * J, 3)
        out = torch.cat([r, r.new_zeros((1, 3))])[bl.point_slot]
        if L:
            # exclusive partition: leftover landmarks have no banded slot
            out = out.index_add(0, bl.left_pids,
                                l_wt(v).reshape(3, L).T)
        return out

    def pre():                         # exact 6x6 diagonal blocks of S
        # AHA[b,k,x,w] = sum_{y,j} At2[b,kx,yj] Aw2[b,kw,yj], keeping the
        # k-diagonal 6x6 blocks (one obs per (pose, point) => k == k')
        full = torch.bmm(At2, Aw2.transpose(1, 2)).reshape(F, Ks, 6, Ks, 6)
        Sk = torch.diagonal(full, dim1=1, dim2=3).permute(0, 3, 1, 2)
        blk = G_banded - _skew_sum(Sk)
        if L:
            # leftover AHA per pose: the M-folded dense block against W
            # over the landmark axis
            blk = blk + G_left - torch.bmm(
                Dd.reshape(F, 6, 3 * L),
                Wd.reshape(F, 6, 3 * L).transpose(1, 2))
        return blk

    return _Hooks(hcc=hcc, corr=corr, w_full=w_full, wt_full=wt_full,
                  pre=pre)


# ---------------------------------------------------------------------------
# Sharded banded grid: the same gather-free hot loop, pose blocks per rank
# ---------------------------------------------------------------------------

class ShardedBandedLayout(NamedTuple):
    """Per-rank banded grid blocks, stacked on a leading shard axis.

    The grid shards by BASE POSE block: rank d owns base rows
    [d*Fb, (d+1)*Fb) and, with it, every observation of every landmark
    based there (the observation arrays must be permuted accordingly,
    ``permute_obs``, so each rank's obs slice is exactly its grid block's
    observations plus its pose block's leftover obs).  The CG legs then run
    on LOCAL tables; v is replicated, the w-leg rows [d*Fb, d*Fb + Fb + Ks)
    assemble by ONE all-reduce a matvec, and the leftover partition's [3L]
    / [F, 6] pieces ride the same collectives.  ``packed.layout_shard``
    takes one rank's block (its ``gstart`` then a Python int)."""
    slot_obs: torch.Tensor       # [D, Fb, J, Ks] LOCAL obs ids (sentinel
                                 #   O_per)
    slot_point: torch.Tensor     # [D, Fb, J] global pid (sentinel P)
    point_slot: torch.Tensor     # [D, P] local b*J+j (sentinel Fb*J)
    op_ids_banded: torch.Tensor  # [D, O_per] global pose (sentinel F)
    op_ids_left: torch.Tensor    # [D, O_per] global pose (sentinel F)
    left_pids: torch.Tensor      # [D, L] global pid (the same every rank)
    left_obs_row: torch.Tensor   # [D, O_per] local pose row (sentinel Fb)
    left_obs_col: torch.Tensor   # [D, O_per] leftover col (sentinel L)
    gstart: torch.Tensor         # [D] global base offset d*Fb
    F: int
    P: int
    Fb: int
    J: int
    Ks: int
    L: int
    O_per: int
    n_banded: int
    n_left: int


def build_sharded_banded_layout(obs_pose, obs_point, obs_valid,
                                n_poses: int, n_points: int, n_shards: int,
                                device=None):
    """Host-side build of the per-rank grid blocks + the observation
    permutation that realizes them.

    Returns (layout, perm, valid) — ``perm`` [D * O_per] gathers the
    ORIGINAL observation arrays into the device-major order the layout
    indexes and ``valid`` [D * O_per] marks the real (non-pad) slots;
    apply with ``permute_obs`` — or None when the single-device builder
    refuses the grid (duplicated observations included) or F doesn't split
    evenly.  Tensors land on ``device`` (None: the device of ``obs_pose``
    if a tensor, else the CUDA device)."""
    device = _table_device(obs_pose, device)
    F, P, D = int(n_poses), int(n_points), int(n_shards)
    if F % D:
        return None
    bl = build_banded_layout(obs_pose, obs_point, obs_valid, F, P,
                             device="cpu")
    if bl is None:
        return None
    Fb = F // D
    J, Ks, L = bl.J, bl.Ks, bl.L
    op = _as_numpy(obs_pose, np.int64)
    ov = _as_numpy(obs_valid, bool)
    O = op.shape[0]
    npy = lambda t: t.numpy().astype(np.int64)
    slot_obs_g = npy(bl.slot_obs)                           # [F, J, Ks]
    opb = npy(bl.op_ids_banded)                             # sentinel F
    opl = npy(bl.op_ids_left)
    lrow = npy(bl.left_obs_f)
    lcol = npy(bl.left_obs_col)

    # rank of each obs: banded -> its grid row's base block; leftover ->
    # its pose's block; invalid -> parked on rank 0 as padding
    base_of_obs = np.full(O, -1, np.int64)
    so = slot_obs_g.reshape(-1)
    valid_slots = so < O
    base_idx = np.repeat(np.arange(F), J * Ks)
    base_of_obs[so[valid_slots]] = base_idx[valid_slots]
    is_left = lcol < L
    base_of_obs[is_left] = lrow[is_left]
    dev = np.where(base_of_obs >= 0, base_of_obs // Fb, 0)
    dev = np.where(ov, dev, 0)

    counts = np.bincount(dev[ov], minlength=D)
    O_per = int(counts.max()) if counts.size else 1
    O_per = max(O_per, 1)
    perm = np.zeros(D * O_per, np.int64)
    local_of = np.full(O, O_per, np.int64)   # local id per original obs
    for d in range(D):
        ids = np.flatnonzero(ov & (dev == d))
        perm[d * O_per:d * O_per + len(ids)] = ids
        perm[d * O_per + len(ids):(d + 1) * O_per] = ids[0] if len(ids) \
            else 0
        local_of[ids] = np.arange(len(ids))

    # per-rank tables with LOCAL obs ids
    remap_slot = np.full(O + 1, O_per, np.int64)
    remap_slot[:O] = local_of
    slot_obs_l = remap_slot[slot_obs_g].reshape(D, Fb, J, Ks)
    slot_point_l = npy(bl.slot_point).reshape(D, Fb, J)

    point_slot_l = np.full((D, P), Fb * J, np.int64)
    ps_g = npy(bl.point_slot)                               # b*J + j / F*J
    pb = np.flatnonzero(ps_g < F * J)
    d_of_p = (ps_g[pb] // J) // Fb
    point_slot_l[d_of_p, pb] = ps_g[pb] - d_of_p * Fb * J

    def _gather_obs_field(src, sentinel):
        out = np.full((D, O_per), sentinel, np.int64)
        flat = src[perm].reshape(D, O_per)
        # padding slots repeat a real obs: force their sentinel
        for d in range(D):
            n = counts[d] if d < len(counts) else 0
            out[d, :n] = flat[d, :n]
        return out

    opb_l = _gather_obs_field(opb, F)
    opl_l = _gather_obs_field(opl, F)
    lrow_l = _gather_obs_field(np.where(is_left, lrow, 0), 0)
    # leftover row becomes LOCAL (pose - gstart); non-left -> sentinel Fb
    gstart = (np.arange(D) * Fb)[:, None]
    lcol_l = _gather_obs_field(lcol, L)
    lrow_l = np.where(lcol_l < L, lrow_l - gstart, Fb)

    layout = ShardedBandedLayout(
        slot_obs=_i32(slot_obs_l, device),
        slot_point=_i32(slot_point_l, device),
        point_slot=_i32(point_slot_l, device),
        op_ids_banded=_i32(opb_l, device), op_ids_left=_i32(opl_l, device),
        left_pids=_i32(np.tile(npy(bl.left_pids)[None], (D, 1)), device),
        left_obs_row=_i32(lrow_l, device), left_obs_col=_i32(lcol_l, device),
        gstart=_i32(np.arange(D) * Fb, device),
        F=F, P=P, Fb=Fb, J=J, Ks=Ks, L=L, O_per=O_per,
        n_banded=bl.n_banded, n_left=bl.n_left)
    valid = (np.arange(D * O_per) % O_per
             < counts[(np.arange(D * O_per) // O_per)])
    return (layout, _i32(perm, device),
            torch.as_tensor(valid, device=device))


def permute_obs(problem, perm, valid):
    """Apply the builder's observation permutation to a BAProblem: the
    returned problem's obs arrays are device-major blocks of O_per rows
    each (pad slots repeat a real obs with validity OFF)."""
    perm = perm.to(problem.device).long()
    g = lambda a: a[perm]
    return problem._replace(
        obs_uv=g(problem.obs_uv), obs_pose=g(problem.obs_pose),
        obs_cam=g(problem.obs_cam), obs_point=g(problem.obs_point),
        obs_sigma=g(problem.obs_sigma),
        obs_valid=g(problem.obs_valid) & valid.to(problem.device))


def pack_banded_sharded(lin, sbl: ShardedBandedLayout, group):
    """Per-linearization tables for ONE rank's grid block (``sbl`` a block
    from ``packed.layout_shard``, ``lin`` the linearization of this rank's
    obs rows).  The per-pose Grams are [F, 6, 6] and are summed over
    ``group`` (the JAX package's ``axis``) to replicated; everything else
    stays local."""
    from mqslam_tpu_torch.ba.solver import _psum
    Fb, J, Ks, L, F = sbl.Fb, sbl.J, sbl.Ks, sbl.L, sbl.F
    Jp, Jt = lin.J_obs_pose, lin.J_obs_point          # [O_per, 2, 6 / 3]
    A_o = torch.einsum("ocx,ocy->oxy", Jp, Jt)        # [O_per, 6, 3]
    A_flat = torch.cat([A_o.reshape(-1, 18), A_o.new_zeros((1, 18))])
    G1 = A_flat[sbl.slot_obs].reshape(Fb, J, Ks, 6, 3)
    Awt = G1.permute(0, 4, 1, 2, 3).reshape(Fb, 3 * J, Ks * 6)
    Aw2 = Awt.transpose(1, 2)
    JTJ = torch.einsum("ocx,ocy->oxy", Jp, Jp)
    G = _psum(torch.stack([_seg_drop(JTJ, sbl.op_ids_banded, F),
                           _seg_drop(JTJ, sbl.op_ids_left, F)]), group)
    if L:
        flat = sbl.left_obs_row.long() * (L + 1) + sbl.left_obs_col.long()
        Zl = _seg_drop(A_o, flat, (Fb + 1) * (L + 1))
        Wd = Zl.reshape(Fb + 1, L + 1, 6, 3)[:Fb, :L].permute(
            0, 2, 3, 1).reshape(Fb * 6, 3 * L)
    else:
        Wd = A_o.new_zeros((Fb * 6, 0))
    return Awt, Aw2, G[0], G[1], Wd


def banded_hooks_sharded(problem, lin, sbl: ShardedBandedLayout, packedB,
                         Hpp_inv, group):
    """Closures for the sharded banded Schur-CG: ``banded_hooks``' math with
    the grid split into pose blocks.  Every [F, 6]- or [P, 3]-shaped result
    carries its own all-reduce over ``group``, so the caller composes them
    without further collectives, and every rank must call each closure the
    same number of times.  Call inside ``solver._exact_f32``."""
    from mqslam_tpu_torch.ba.solver import _psum
    Awt, Aw2, G_banded, G_left, Wd = (
        packedB if packedB is not None
        else pack_banded_sharded(lin, sbl, group))
    Fb, J, Ks, L, F, P = sbl.Fb, sbl.J, sbl.Ks, sbl.L, sbl.F, sbl.P
    gs = int(sbl.gstart)
    G_obs = G_banded + G_left

    M9 = torch.cat([Hpp_inv.reshape(P, 9),
                    Hpp_inv.new_zeros((1, 9))])[sbl.slot_point]  # [Fb,J,9]
    Mt = M9.permute(2, 0, 1).reshape(3, 3, Fb, J)
    At2 = torch.cat(
        [sum(Aw2[:, :, z * J:(z + 1) * J] * Mt[z, y][:, None, :]
             for z in range(3)) for y in range(3)], dim=2)

    if L:
        M_lc = Hpp_inv[sbl.left_pids]
        Dd = torch.cat(
            [sum(Wd[:, z * L:(z + 1) * L] * M_lc[None, :, z, y]
                 for z in range(3)) for y in range(3)], dim=1)

    def wt72(v):                       # replicated [F, 6] -> r [Fb, 3J]
        vb = torch.cat([v, v.new_zeros((Ks, 6))])[gs:gs + Fb + Ks]
        V = torch.cat([vb[k:k + Fb] for k in range(Ks)], dim=1)
        return torch.bmm(Awt, V[:, :, None])[:, :, 0]

    def _assemble(q, c_left):          # q [Fb, Ks*6] -> summed [F, 6]
        buf = q.new_zeros((F + Ks, 6))
        buf[gs:gs + Fb + Ks] = _skew_full(q.reshape(Fb, Ks, 6))
        if c_left is not None:
            buf[gs:gs + Fb] += c_left
        return _psum(buf[:F], group)

    def _u_left(v):                    # summed [3L] leftover state
        return _psum((v[gs:gs + Fb].reshape(1, Fb * 6) @ Wd)[0], group)

    def hcc(v):
        return torch.bmm(G_obs, v[:, :, None])[:, :, 0]

    def corr(v):
        q = torch.bmm(At2, wt72(v)[:, :, None])[:, :, 0]   # [Fb, Ks*6]
        c_left = None
        if L:
            c_left = (Dd @ _u_left(v).reshape(3 * L, 1)).reshape(Fb, 6)
        return _assemble(q, c_left)

    def w_full(t):                     # replicated t [P, 3] -> [F, 6]
        tb = torch.cat([t, t.new_zeros((1, 3))])[sbl.slot_point]
        t72 = tb.transpose(1, 2).reshape(Fb, 3 * J)
        q = torch.bmm(Aw2, t72[:, :, None])[:, :, 0]
        c_left = None
        if L:
            c_left = (Wd @ t[sbl.left_pids].T.reshape(3 * L, 1)).reshape(
                Fb, 6)
        return _assemble(q, c_left)

    def wt_full(v):                    # -> summed [P, 3]
        r = wt72(v).reshape(Fb, 3, J).transpose(1, 2).reshape(Fb * J, 3)
        out = torch.cat([r, r.new_zeros((1, 3))])[sbl.point_slot]
        if L:
            # u_left is already summed (identical on every rank): every
            # rank reduces it, block 0 adds it, so the outer sum counts it
            # once
            u3 = _u_left(v).reshape(3, L).T
            if gs == 0:
                out = out.index_add(0, sbl.left_pids, u3)
        return _psum(out, group)

    def pre():
        full = torch.bmm(At2, Aw2.transpose(1, 2)).reshape(Fb, Ks, 6, Ks, 6)
        Sk = torch.diagonal(full, dim1=1, dim2=3).permute(0, 3, 1, 2)
        buf = full.new_zeros((F + Ks, 6, 6))
        buf[gs:gs + Fb + Ks] = _skew_full(Sk)
        if L:
            buf[gs:gs + Fb] += torch.bmm(
                Dd.reshape(Fb, 6, 3 * L),
                Wd.reshape(Fb, 6, 3 * L).transpose(1, 2))
        return G_obs - _psum(buf[:F], group)

    return _Hooks(hcc=hcc, corr=corr, w_full=w_full, wt_full=wt_full,
                  pre=pre)
