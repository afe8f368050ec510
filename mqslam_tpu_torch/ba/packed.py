"""Packed dual-layout observation structure for the large-scale CG path.

The matrix-free Schur PCG applies of ``ba/solver.py`` address observations
through ``v[obs_pose]`` gathers and ``index_add_`` segment sums (the COO
form).  This module converts the COO observation lists into two dense
padded layouts, built once per problem on the host (NumPy, static shapes):

  pose-major:  slot [F, Kf] — every pose's observations in its own row
  point-major: slot [P, Kp] — every landmark's observations in its row

plus per-slot ids of the OTHER variable (``pid_f`` / ``fid_p``).  The solver
packs the per-observation Jacobians into [F, Kf, ...] / [P, Kp, ...] tensors
once per linearization (both Jacobians in both layouts, ``solver.
pack_jacobians``); each CG matvec is then dense block products plus gathers
of the small [F, 6] / [P, 3] state vectors — no scatter and no
per-observation permutation.  Padding slots point at an appended zero row,
so they contribute nothing.

``ChunkedGather`` is the JAX package's pack-row form of a gather whose id
table is mostly runs of consecutive ids (a landmark is seen by consecutive
poses): a run of G slots is one row of the sliding pack ``B[i] = v[i:i+G]``.
It returns exactly the plain gather's values; the solver takes it wherever
the builder made one, as the JAX package does.

``ShardedPackedLayout`` is the per-device form for the sharded solve: each
of D ranks holds one contiguous slice of the (padded) observation rows, and
its tables cover only the poses / landmarks that slice touches, through row
maps (``solver._packed_ops_rows``).

The builders are copies of the JAX package's (``mqslam_tpu/ba/packed.py``),
so the tables are equal to its tables as integers.
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

from mqslam_tpu_torch import resolve_device

__all__ = ["PackedLayout", "build_packed_layout", "ChunkedGather",
           "build_chunked_gather", "apply_chunked", "ShardedPackedLayout",
           "build_sharded_packed_layout", "layout_shard"]


class ChunkedGather(NamedTuple):
    """Sliding-pack formulation of a near-run id-table gather.

    When a G-slot chunk's ids are ``base, base+1, ...`` the whole chunk is
    ONE row of the pack ``B[i] = v[i:i+G]`` (flattened to G*d values).
    Broken (non-run) chunks get prebuilt extension rows appended to the pack
    table, gathered slot by slot; the chunk gather then reads run and broken
    chunks alike, with no scatter."""
    chunk_src: torch.Tensor  # [R, Kpad/G] int32: run base, or n_src+1+j for
                             #   broken chunk j, or n_src (all-sentinel:
                             #   the zero row)
    chunk_len: torch.Tensor  # [R, Kpad/G] int32 valid run length
    ext_ids: torch.Tensor    # [NB, G] int32 per-slot ids of the broken
                             #   chunks (sentinel n_src)
    n_src: int               # source vector length
    G: int                   # chunk width
    rows: int                # table rows
    K: int                   # table columns


def _as_numpy(x, dtype):
    if torch.is_tensor(x):
        x = x.cpu().numpy()
    return np.asarray(x, dtype=dtype)


def _table_device(obs_pose, device):
    """Where a builder's tables go: ``device`` if given, else the device of
    the observation tensors, else (NumPy inputs) the CUDA device."""
    if device is not None:
        return torch.device(device)
    if torch.is_tensor(obs_pose):
        return obs_pose.device
    return resolve_device(None)


def _i32(a, device):
    return torch.as_tensor(np.asarray(a, np.int64).astype(np.int32),
                           device=device)


def build_chunked_gather(ids, n_src: int, G: int = 8,
                         max_broken_frac: float = 0.05, device=None):
    """ChunkedGather for an id table [rows, K] (sentinel >= n_src), or None
    when more than ``max_broken_frac`` of the chunks are broken (non-run)
    for the extension rows to pay.  Tables land on ``device`` (None: the
    device of ``ids`` if a tensor, else the CUDA device)."""
    device = _table_device(ids, device)
    ids = _as_numpy(ids, np.int64)
    rows, K = ids.shape
    Kpad = -(-K // G) * G
    t = np.full((rows, Kpad), n_src, np.int64)
    t[:, :K] = ids
    ch = t.reshape(-1, G)
    valid = ch < n_src
    base = ch[:, 0]
    expect = base[:, None] + np.arange(G)[None, :]
    run = np.cumprod((ch == expect) & valid, axis=1).astype(bool)
    length = run.sum(axis=1)
    # a chunk is a run iff every valid slot is in the prefix run
    ok = (base < n_src) & ~(valid & ~run).any(axis=1)
    broken = valid.any(axis=1) & ~ok
    nb = int(broken.sum())
    if nb > max_broken_frac * max(len(ch), 1):
        return None
    bidx = np.flatnonzero(broken)
    chunk_src = np.where(ok, base, n_src)
    chunk_src[bidx] = n_src + 1 + np.arange(nb)
    # broken chunks pass the length mask whole: their extension rows
    # already carry zeros at sentinel slots
    chunk_len = np.where(ok, length, 0)
    chunk_len[bidx] = G
    return ChunkedGather(
        chunk_src=_i32(chunk_src.reshape(rows, Kpad // G), device),
        chunk_len=_i32(chunk_len.reshape(rows, Kpad // G), device),
        ext_ids=_i32(ch[bidx].reshape(-1, G), device),
        n_src=int(n_src), G=G, rows=rows, K=K)


def apply_chunked(cg: ChunkedGather, v):
    """v [n_src, d] -> gathered [rows, K, d], equal to the zero-padded
    ``v[ids]`` (zeros at sentinel slots).  Run chunks read one flat
    pack-table row; broken chunks read their prebuilt extension row."""
    d = v.shape[1]
    G = cg.G
    vp = torch.cat([v, v.new_zeros((2 * G, d))])
    # B[i] = v_pad[i : i + G] flattened; row n_src is all zeros
    B = torch.stack([vp[g:g + cg.n_src + 1] for g in range(G)],
                    dim=1).reshape(-1, G * d)
    if cg.ext_ids.shape[0]:
        ext = vp[cg.ext_ids.reshape(-1)].reshape(-1, G * d)
        B = torch.cat([B, ext])
    out = B[cg.chunk_src]                          # [R, Kpad/G, G*d]
    out = out.reshape(cg.chunk_src.shape + (G, d))
    mask = (torch.arange(G, device=v.device)[None, None, :]
            < cg.chunk_len[:, :, None]).to(v.dtype)
    out = (out * mask[..., None]).reshape(cg.rows, -1, d)
    return out[:, :cg.K]


class PackedLayout(NamedTuple):
    """Index structure; all entries int32, sentinels point past the end.

    ``pid_f`` / ``fid_p`` carry the OTHER variable's id per slot: the
    cross-layout products gather the small [F, 6] / [P, 3] vectors through
    them instead of permuting per-observation tensors between the
    layouts."""
    fslot: torch.Tensor     # [F, Kf] flat obs index (sentinel = O)
    pslot: torch.Tensor     # [P, Kp] flat obs index (sentinel = O)
    pid_f: torch.Tensor     # [F, Kf] landmark id per pose-major slot
                            #         (sentinel = P: a zero row)
    fid_p: torch.Tensor     # [P, Kp] pose id per point-major slot
                            #         (sentinel = F)
    wg_fid: Optional[ChunkedGather] = None  # pack-row form of v[fid_p]
    wg_pid: Optional[ChunkedGather] = None  # pack-row form of u[pid_f]

    @property
    def Kf(self):
        return self.fslot.shape[1]

    @property
    def Kp(self):
        return self.pslot.shape[1]


def _slot_table(ids, sel, n_rows, O):
    """[n_rows, K] table of flat obs indices grouped by ids[sel]; also the
    inverse map obs -> flat slot (sentinel n_rows * K for absent obs)."""
    order = np.argsort(ids[sel], kind="stable")
    flat = sel[order]
    grp = ids[flat]
    counts = np.bincount(grp, minlength=n_rows)
    K = max(int(counts.max()) if len(flat) else 0, 1)
    # position within the group: running index minus group start
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(len(flat)) - starts[grp]
    table = np.full((n_rows, K), O, dtype=np.int64)
    table[grp, pos] = flat
    inv = np.full(O + 1, n_rows * K, dtype=np.int64)
    inv[flat] = grp * K + pos
    return table, inv, K


def build_packed_layout(obs_pose, obs_point, obs_valid, n_poses: int,
                        n_points: int, max_ratio: float = 6.0, device=None):
    """Build the dual layout, or return None when there is no valid
    observation or padding would blow up: the packed tables must stay
    within ``max_ratio`` times the valid observation count (one pose
    holding most observations would make [F, Kf] quadratic).  Tables land
    on ``device`` (None: the device of ``obs_pose`` if a tensor, else the
    CUDA device)."""
    device = _table_device(obs_pose, device)
    op = _as_numpy(obs_pose, np.int64)
    opt = _as_numpy(obs_point, np.int64)
    ov = _as_numpy(obs_valid, bool)
    O = len(op)
    sel = np.nonzero(ov)[0]
    if len(sel) == 0:
        return None
    fslot, _, Kf = _slot_table(op, sel, n_poses, O)
    pslot, _, Kp = _slot_table(opt, sel, n_points, O)
    n_obs = len(sel)
    if n_poses * Kf > max_ratio * n_obs or n_points * Kp > max_ratio * n_obs:
        return None
    pid_f = np.where(fslot < O, opt[np.minimum(fslot, O - 1)], n_points)
    fid_p = np.where(pslot < O, op[np.minimum(pslot, O - 1)], n_poses)
    return PackedLayout(
        fslot=_i32(fslot, device), pslot=_i32(pslot, device),
        pid_f=_i32(pid_f, device), fid_p=_i32(fid_p, device),
        wg_fid=build_chunked_gather(fid_p, n_poses, device=device),
        wg_pid=build_chunked_gather(pid_f, n_points, device=device))


class ShardedPackedLayout(NamedTuple):
    """Per-device compact packed layout, stacked on a leading shard axis.

    Rank d holds the observation slice ``[d*per, (d+1)*per)`` of the
    (padded) COO arrays; its tables cover only the poses / landmarks that
    slice touches, addressed through row maps, so per-device dense matvec
    work scales 1/D instead of re-reading F / P mostly-empty rows.  A rank
    takes its own block (``layout_shard``, the leading axis dropped): its
    slot indices are LOCAL to its obs slice (sentinel = the slice length),
    and partial [Fd, 6] / [Pd, 3] results scatter through ``rows_f`` /
    ``rows_p`` into global vectors that are summed over the ranks (see
    ``solver._packed_ops_rows``)."""
    fslot: torch.Tensor     # [D, Fd, Kf] local obs index (sentinel = per)
    pslot: torch.Tensor     # [D, Pd, Kp] local obs index (sentinel = per)
    pid_f: torch.Tensor     # [D, Fd, Kf] GLOBAL landmark id (sentinel = P)
    fid_p: torch.Tensor     # [D, Pd, Kp] GLOBAL pose id (sentinel = F)
    rows_f: torch.Tensor    # [D, Fd] global pose id per row (sentinel = F)
    rows_p: torch.Tensor    # [D, Pd] global landmark id (sentinel = P)


def _shard_tables(op, opt, ov, n_poses, n_points, lo, hi):
    """One shard's compact dual layout over its [lo, hi) obs slice.

    All slot indices local to the slice; rows_* map local rows to global
    pose / landmark ids."""
    per = hi - lo
    sel = np.nonzero(ov[lo:hi])[0]           # local indices
    op_l = op[lo:hi]
    opt_l = opt[lo:hi]
    rows_f, op_row = np.unique(op_l[sel], return_inverse=True) \
        if len(sel) else (np.zeros(0, np.int64), np.zeros(0, np.int64))
    rows_p, opt_row = np.unique(opt_l[sel], return_inverse=True) \
        if len(sel) else (np.zeros(0, np.int64), np.zeros(0, np.int64))
    # slot tables over local rows
    op_rows = np.zeros(per, np.int64)
    op_rows[sel] = op_row
    opt_rows = np.zeros(per, np.int64)
    opt_rows[sel] = opt_row
    fslot, _, Kf = _slot_table(op_rows, sel, max(len(rows_f), 1), per)
    pslot, _, Kp = _slot_table(opt_rows, sel, max(len(rows_p), 1), per)
    pid_f = np.where(fslot < per,
                     opt_l[np.minimum(fslot, max(per - 1, 0))], n_points)
    fid_p = np.where(pslot < per,
                     op_l[np.minimum(pslot, max(per - 1, 0))], n_poses)
    return dict(fslot=fslot, pslot=pslot, pid_f=pid_f, fid_p=fid_p,
                rows_f=rows_f, rows_p=rows_p, Kf=Kf, Kp=Kp, per=per)


def build_sharded_packed_layout(obs_pose, obs_point, obs_valid,
                                n_poses: int, n_points: int, n_shards: int,
                                max_ratio: float = 6.0, device=None):
    """Build per-shard compact layouts for obs arrays pre-padded to a
    multiple of ``n_shards`` (``parallel.pad_problem_for_shards``'s
    split).

    Returns a ShardedPackedLayout with uniform per-shard table sizes
    (padded to the max across shards), or None when the rows do not split
    evenly, there are no valid observations or the padded tables would
    exceed ``max_ratio`` x the raw observation count (degenerate
    distributions: COO applies then).  Tables land on ``device`` (None: the
    device of ``obs_pose`` if a tensor, else the CUDA device)."""
    device = _table_device(obs_pose, device)
    op = _as_numpy(obs_pose, np.int64)
    opt = _as_numpy(obs_point, np.int64)
    ov = _as_numpy(obs_valid, bool)
    O = len(op)
    if O % n_shards != 0:
        return None
    n_valid = int(ov.sum())
    if n_valid == 0:
        return None
    per = O // n_shards
    shards = [_shard_tables(op, opt, ov, n_poses, n_points,
                            d * per, (d + 1) * per)
              for d in range(n_shards)]
    Fd = max(max(len(s["rows_f"]) for s in shards), 1)
    Pd = max(max(len(s["rows_p"]) for s in shards), 1)
    Kf = max(s["Kf"] for s in shards)
    Kp = max(s["Kp"] for s in shards)
    if n_shards * (Fd * Kf + Pd * Kp) > max_ratio * n_valid:
        return None

    def stack(key, rows, K, sent):
        out = np.full((n_shards, rows, K), sent, dtype=np.int64)
        for d, s in enumerate(shards):
            t = s[key]
            out[d, :t.shape[0], :t.shape[1]] = t
        return out

    def stack_rows(key, rows, sent):
        out = np.full((n_shards, rows), sent, dtype=np.int64)
        for d, s in enumerate(shards):
            out[d, :len(s[key])] = s[key]
        return out

    return ShardedPackedLayout(
        fslot=_i32(stack("fslot", Fd, Kf, per), device),
        pslot=_i32(stack("pslot", Pd, Kp, per), device),
        pid_f=_i32(stack("pid_f", Fd, Kf, n_points), device),
        fid_p=_i32(stack("fid_p", Pd, Kp, n_poses), device),
        rows_f=_i32(stack_rows("rows_f", Fd, n_poses), device),
        rows_p=_i32(stack_rows("rows_p", Pd, n_points), device))


def layout_shard(layout, rank: int, device=None):
    """Rank ``rank``'s block of a stacked sharded layout (a
    ``ShardedPackedLayout`` or ``banded.ShardedBandedLayout``): every
    tensor field indexed ``[rank]`` and moved to ``device`` (None: where it
    is), integer fields kept; a sharded banded layout's ``gstart`` becomes
    this rank's base pose as a Python int.  The JAX package squeezes the
    same block inside ``shard_map``."""
    def take(name, x):
        if not torch.is_tensor(x):
            return x
        x = x[rank]
        if name == "gstart":
            return int(x)
        return x if device is None else x.to(device)

    return type(layout)(*(take(n, x) for n, x in zip(layout._fields,
                                                       layout)))
