"""ORB-style oriented binary descriptors (FAST + intensity-centroid
orientation + steered BRIEF), batched.

Descriptor-based association serves the appearance tasks the reference has
no kernel for: loop-closure candidate retrieval (frontend/loopclosure.py).

Not byte-compatible with cv2.ORB (whose bit-pattern is a learned lookup
table); the pair pattern here is a fixed seeded Gaussian pattern bounded to
the rotation-safe radius, which preserves ORB's invariances (in-plane
rotation via steering, monotonic-illumination via pairwise comparisons).
The pattern, the patch and the arithmetic are the JAX package's: one
advanced-indexing patch per keypoint (``ops/lk.py::_extract_patches``),
orientation moments as masked reductions, and all 512 rotated sample points
per keypoint evaluated with one banded-interpolation matmul pair in full
float32.  Bits pack to uint8 for ``ops/matching.pairwise_hamming``.
"""

import numpy as np
import torch

from mqslam_tpu_torch.ops import fast as fast_mod
from mqslam_tpu_torch.ops.lk import _exact_f32, _extract_patches

__all__ = ["orb_pattern", "orientation", "brief_describe", "orb_features",
           "PATCH_RADIUS", "N_BITS"]

PATCH_RADIUS = 15          # ORB half-patch: orientation + pattern bound
N_BITS = 256               # descriptor length (32 bytes)
_P = 2 * PATCH_RADIUS + 3  # patch side: +1 margin each side + interp tap


def orb_pattern(n_bits: int = N_BITS, seed: int = 8):
    """[n_bits, 4] static float32 pattern (xa, ya, xb, yb), Gaussian pairs
    clipped into the radius-(PATCH_RADIUS-2) disc so any in-plane rotation
    stays inside the patch (cv2's table is learned; ours is seeded)."""
    rng = np.random.RandomState(seed)
    sigma_a = PATCH_RADIUS / 2.5
    sigma_b = PATCH_RADIUS / 5.0
    out = np.zeros((n_bits, 4), np.float32)
    rmax = PATCH_RADIUS - 2.0
    n = 0
    while n < n_bits:
        a = rng.normal(0.0, sigma_a, 2)
        b = a + rng.normal(0.0, sigma_b, 2)
        if np.linalg.norm(a) <= rmax and np.linalg.norm(b) <= rmax:
            out[n] = [a[0], a[1], b[0], b[1]]
            n += 1
    return out


_PATTERN = orb_pattern()

# circular mask + coordinate grids for the intensity centroid (static)
_gy, _gx = np.mgrid[-PATCH_RADIUS - 1:PATCH_RADIUS + 2,
                    -PATCH_RADIUS - 1:PATCH_RADIUS + 2]
_CIRC = ((_gx ** 2 + _gy ** 2) <= PATCH_RADIUS ** 2).astype(np.float32)
_GX = _gx.astype(np.float32) * _CIRC
_GY = _gy.astype(np.float32) * _CIRC


def _patches(img, uv):
    """[K, _P, _P] patches centered on rounded uv; returns (patch, frac)
    where frac is the sub-pixel offset of the true center in the patch.
    ``uv`` must be finite (``brief_describe`` zeroes the rest)."""
    c = torch.floor(uv)
    corner = torch.stack([c[:, 1].to(torch.int64) - PATCH_RADIUS - 1,
                          c[:, 0].to(torch.int64) - PATCH_RADIUS - 1], dim=1)
    patch, cy, cx = _extract_patches(img, corner, _P)
    frac = uv - torch.stack([cx.to(uv.dtype) + PATCH_RADIUS + 1,
                             cy.to(uv.dtype) + PATCH_RADIUS + 1], dim=1)
    return patch, frac


def orientation(patch):
    """Intensity-centroid angle per patch [K]: atan2(m01, m10) over the
    radius-15 disc (Rosin moments, as in ORB)."""
    gx = torch.as_tensor(_GX, device=patch.device)
    gy = torch.as_tensor(_GY, device=patch.device)
    m10 = torch.sum(patch * gx, dim=(-2, -1))
    m01 = torch.sum(patch * gy, dim=(-2, -1))
    return torch.atan2(m01, m10)


def _interp_weights_pointwise(pos):
    """[..., S] fractional positions -> [..., S, _P] hat-function rows."""
    j = torch.arange(_P, dtype=pos.dtype, device=pos.device)
    return torch.clamp(1.0 - torch.abs(pos[..., None] - j), min=0.0)


def _sample_rotated(patch, frac, theta, pattern):
    """Bilinear values of the 2*n_bits rotated pattern points.

    patch [K, _P, _P], frac [K, 2], theta [K] -> [K, n_bits, 2] (a, b).
    One matmul pair over banded interpolation weights (see ops/lk.py).
    """
    K = patch.shape[0]
    n = pattern.shape[0]
    pts = pattern.reshape(n * 2, 2)
    ca, sa = torch.cos(theta), torch.sin(theta)
    x = pts[None, :, 0] * ca[:, None] - pts[None, :, 1] * sa[:, None]
    y = pts[None, :, 0] * sa[:, None] + pts[None, :, 1] * ca[:, None]
    # patch coordinates of each sample (center + sub-pixel offset)
    cx = x + PATCH_RADIUS + 1 + frac[:, None, 0]
    cy = y + PATCH_RADIUS + 1 + frac[:, None, 1]
    Wy = _interp_weights_pointwise(cy)   # [K, 2n, _P]
    Wx = _interp_weights_pointwise(cx)
    with _exact_f32():
        tmp = torch.matmul(Wy, patch)
    vals = torch.sum(tmp * Wx, dim=-1)   # [K, 2n]
    return vals.reshape(K, n, 2)


def brief_describe(img, uv, valid=None):
    """Steered-BRIEF descriptors at keypoints.

    img [H, W], uv [K, 2] pixel coords (float32, as the JAX package's
    arrays always are). Returns (desc [K, 32] uint8,
    theta [K], ok [K] bool — False where the patch would leave the image or
    the slot is invalid).  A slot whose coordinates are not finite (dead
    tracks may carry NaN) is described at (0, 0) — ``floor(NaN)`` is no
    index — and ``ok`` flags it.
    """
    img, uv = img.to(torch.float32), uv.to(torch.float32)
    if valid is None:
        valid = torch.ones(uv.shape[0], dtype=torch.bool, device=uv.device)
    H, W = img.shape
    b = PATCH_RADIUS + 2
    ok = valid & (uv[:, 0] >= b) & (uv[:, 0] < W - b) & \
        (uv[:, 1] >= b) & (uv[:, 1] < H - b)
    uv = torch.where(torch.isfinite(uv).all(dim=1, keepdim=True), uv,
                     torch.zeros_like(uv))
    patch, frac = _patches(img, uv)
    theta = orientation(patch)
    pattern = torch.as_tensor(_PATTERN, device=uv.device)
    vals = _sample_rotated(patch, frac, theta, pattern)
    bits = (vals[..., 0] < vals[..., 1]).to(torch.int32)   # [K, 256]
    byte_w = 1 << torch.arange(8, dtype=torch.int32, device=uv.device)
    bytes_ = torch.sum(bits.reshape(-1, 32, 8) * byte_w, dim=-1)
    return bytes_.to(torch.uint8), theta, ok


def orb_features(img, max_corners: int = 512, threshold: float = 20.0):
    """FAST-9/16 detection + steered-BRIEF description in one call.

    Returns (uv [max_corners, 2], desc [max_corners, 32] uint8,
    score, theta, valid)."""
    uv, score, v = fast_mod.fast_detect(img, threshold, max_corners)
    desc, theta, ok = brief_describe(img, uv, v)
    return uv, desc, score, theta, v & ok
