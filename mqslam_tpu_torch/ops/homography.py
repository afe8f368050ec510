"""Homography fitting + the degeneracy-based keyframe test.

Replaces ``cv2.findHomography`` (least-squares method) + the SVD condition
check used for keyframe selection: fit H on undistorted matches, declare a
keyframe when sigma_max / sigma_min > 1.04.

Normalized DLT over masked fixed-capacity point sets; the 9x9 null space
comes from shifted inverse iteration; singular values of H from svdvals3x3.
"""

import math

import torch

from mqslam_tpu_torch.ops import linalg

__all__ = ["fit_homography", "homography_condition", "keyframe_test"]


def _normalize(pts, w):
    """Hartley normalization: zero mean, mean distance sqrt(2) (weighted)."""
    n = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1.0)
    mean = torch.sum(pts * w[..., None], dim=-2, keepdim=True) / n[..., None]
    centered = pts - mean
    dist = torch.sqrt(torch.sum(centered ** 2, dim=-1))
    mean_dist = torch.sum(dist * w, dim=-1, keepdim=True) / n
    s = math.sqrt(2.0) / torch.clamp(mean_dist, min=1e-12)
    return centered * s[..., None], mean[..., 0, :], s[..., 0]


def _denormalize_H(Hn, mean1, s1, mean2, s2):
    """H = T2^-1 Hn T1 for similarity normalizations T."""
    # T1: x -> s1 (x - mean1);  T2^-1: x -> x / s2 + mean2
    zero = torch.zeros_like(s1)
    one = torch.ones_like(s1)
    T1 = torch.stack([
        torch.stack([s1, zero, -s1 * mean1[..., 0]], dim=-1),
        torch.stack([zero, s1, -s1 * mean1[..., 1]], dim=-1),
        torch.stack([zero, zero, one], dim=-1)], dim=-2)
    T2inv = torch.stack([
        torch.stack([1.0 / s2, zero, mean2[..., 0]], dim=-1),
        torch.stack([zero, 1.0 / s2, mean2[..., 1]], dim=-1),
        torch.stack([zero, zero, one], dim=-1)], dim=-2)
    return linalg.matmul_small(linalg.matmul_small(T2inv, Hn), T1)


def fit_homography(pts1, pts2, valid=None):
    """Least-squares DLT homography pts1 -> pts2 over valid matches.

    pts1/pts2 [..., K, 2]; returns H [..., 3, 3] at unit Frobenius scale
    (the overall scale is irrelevant to its condition number)."""
    if valid is None:
        valid = torch.ones(pts1.shape[:-1], dtype=torch.bool,
                           device=pts1.device)
    w = valid.to(pts1.dtype)
    p1, mean1, s1 = _normalize(pts1, w)
    p2, mean2, s2 = _normalize(pts2, w)
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    zero = torch.zeros_like(x1)
    one = torch.ones_like(x1)
    row_a = torch.stack([x1, y1, one, zero, zero, zero,
                         -x2 * x1, -x2 * y1, -x2], dim=-1)
    row_b = torch.stack([zero, zero, zero, x1, y1, one,
                         -y2 * x1, -y2 * y1, -y2], dim=-1)
    rows = torch.cat([row_a * w[..., None], row_b * w[..., None]],
                     dim=-2)  # [..., 2K, 9]
    S = linalg.gram(rows)
    # 9x9 null space by shifted inverse iteration; 4 iterations: homography
    # fits are noisier / less separated than DLT minimal sets
    h = linalg.smallest_eigvec_spd(S, iters=4)
    Hn = h.reshape(h.shape[:-1] + (3, 3))
    H = _denormalize_H(Hn, mean1, s1, mean2, s2)
    norm = torch.sqrt(torch.sum(H * H, dim=(-2, -1), keepdim=True))
    return H / torch.clamp(norm, min=1e-30)


def homography_condition(H):
    """sigma_max / sigma_min of H."""
    sv = linalg.svdvals3x3(H)
    return sv[..., 0] / torch.clamp(sv[..., 2], min=1e-30)


def keyframe_test(pts1_norm, pts2_norm, valid=None, threshold=1.04):
    """True when the two views are sufficiently non-degenerate to serve as a
    triangulation pair. Points must be undistorted normalized coordinates."""
    H = fit_homography(pts1_norm, pts2_norm, valid)
    return homography_condition(H) > threshold
