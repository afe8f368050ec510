"""Brute-force descriptor/point matching: L2 + Hamming, radius & ratio tests.

Replaces the reference's pure-Python BFMatcher.radiusMatch workaround
(reference: Work/python_libs/cv2_helpers.py:263-345 — k=2 kNN via
cv2.batchDistance, keeping up to two matches within maxDistance per query,
working around two OpenCV bugs) and the Lowe-ratio association logic of the
v1 front-end (Work/SLAM/application/own/slam.py:80-127 match_OF_based).

The JAX package's Hamming distance is XOR + popcount; torch has no popcount,
so here the descriptors are unpacked to 0/1 bits and the distance is one
matmul, ``|a| + |b| - 2 a.b``.  It is exact: every product and partial sum
is an integer no larger than the bit count, which float16 (on the card) and
float32 (on the CPU) represent exactly up to 2048.  The distance matrix's
top-2 selection is two masked min reductions, no sort.
"""

import torch

from mqslam_tpu_torch.ops.lk import _exact_f32

__all__ = ["pairwise_l2_sq", "pairwise_hamming", "unpack_bits", "knn2",
           "radius_match", "ratio_test", "mutual_best"]


def pairwise_l2_sq(a, b):
    """Squared L2 distances [N, M] between rows of a [N, D] and b [M, D].

    |a|^2 + |b|^2 - 2 a b^T: the cross term is one matmul, in full float32.
    """
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    aa = torch.sum(a * a, dim=1)[:, None]
    bb = torch.sum(b * b, dim=1)[None, :]
    with _exact_f32():
        cross = a @ b.T
    return torch.clamp(aa + bb - 2.0 * cross, min=0.0)


def unpack_bits(desc, dtype=torch.float32):
    """[..., D] uint8 descriptors -> [..., 8 D] bits as 0/1 of ``dtype``
    (bit k of byte j at 8 j + k)."""
    shifts = torch.arange(8, dtype=torch.int32, device=desc.device)
    bits = (desc.to(torch.int32)[..., None] >> shifts) & 1
    return bits.reshape(desc.shape[:-1] + (desc.shape[-1] * 8,)).to(dtype)


def pairwise_hamming(a, b):
    """Hamming distances [..., N, M] int32 between binary descriptors.

    a [..., N, D] / b [..., M, D] uint8 (e.g. ORB's 32-byte descriptors),
    leading dims broadcast (``_hamming_all`` scores one query against a
    whole keyframe DB [Nd, M, D] in one batched matmul).
    """
    n_bits = a.shape[-1] * 8
    dt = torch.float16 if a.is_cuda and n_bits <= 2048 else torch.float32
    ab = unpack_bits(a, dt)
    bb = unpack_bits(b, dt)
    cross = torch.matmul(ab, bb.transpose(-1, -2)).to(torch.int32)
    na = ab.sum(dim=-1, dtype=torch.int32)[..., :, None]
    nb = bb.sum(dim=-1, dtype=torch.int32)[..., None, :]
    return na + nb - 2 * cross


def _fill_value(x):
    """What the JAX package's ``.set(jnp.inf)`` leaves: inf for floats,
    the largest value for integers (XLA saturates the conversion)."""
    if x.dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(x.dtype).max


def knn2(dists):
    """Best and second-best neighbours per row of a distance matrix.

    Returns (i1, d1, i2, d2) — two masked argmin passes, no sort.  Ties go
    to the first index, as in the JAX package.
    """
    i1 = torch.argmin(dists, dim=1)
    d1 = torch.gather(dists, 1, i1[:, None])[:, 0]
    masked = dists.scatter(1, i1[:, None], _fill_value(dists))
    i2 = torch.argmin(masked, dim=1)
    d2 = torch.gather(masked, 1, i2[:, None])[:, 0]
    return i1, d1, i2, d2


def radius_match(dists, max_distance):
    """cv2_helpers-style radiusMatch: up to 2 nearest matches per query
    within ``max_distance`` (cv2_helpers.py:296-339 semantics).

    Returns (idx [N, 2] int32, dist [N, 2], valid [N, 2] bool), sorted by
    distance per query; invalid entries have idx -1.
    """
    i1, d1, i2, d2 = knn2(dists)
    v1 = d1 <= max_distance
    v2 = d2 <= max_distance
    none = torch.full_like(i1, -1)
    idx = torch.stack([torch.where(v1, i1, none), torch.where(v2, i2, none)],
                      dim=1)
    return (idx.to(torch.int32), torch.stack([d1, d2], dim=1),
            torch.stack([v1, v2], dim=1))


def ratio_test(d1, d2, ratio=0.7):
    """Lowe ratio acceptance (slam.py:118: d1 < ratio * d2; single-match
    queries auto-accept)."""
    return torch.where(torch.isfinite(d2), d1 < ratio * d2,
                       torch.isfinite(d1))


def mutual_best(dists):
    """Cross-check matching: (query, train) pairs that are mutual nearest.

    Returns (train_idx [N] int32, valid [N] bool).
    """
    fwd = torch.argmin(dists, dim=1)
    bwd = torch.argmin(dists, dim=0)
    mutual = bwd[fwd] == torch.arange(dists.shape[0], device=dists.device)
    return fwd.to(torch.int32), mutual
