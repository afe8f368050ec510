"""FAST-9/16 corner detection (segment test), fully vectorized.

Replaces the v1 front-end's cv2.FastFeatureDetector
(reference: Work/SLAM/application/own/slam.py:34, used for detection before
optical-flow association). The 16-pixel Bresenham circle becomes 16 shifted
copies of the image (``torch.roll``, no gathers); the 9-contiguous test
evaluates all 16 arc rotations with a rolled cumulative AND; score is the
cv2-style sum-of-absolute-differences over the passing arc's complement
threshold; 3x3 NMS matches cv2's nonmaxSuppression=True.
"""

import torch
import torch.nn.functional as F

__all__ = ["fast_response", "fast_detect", "CIRCLE_OFFSETS"]

# Bresenham circle of radius 3, clockwise from 12 o'clock (cv2 ordering).
CIRCLE_OFFSETS = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)


def _circle_stack(img):
    """[16, H, W] of the circle pixels for every center (rolled copies)."""
    return torch.stack([torch.roll(img, shifts=(-dy, -dx), dims=(0, 1))
                        for (dx, dy) in CIRCLE_OFFSETS], dim=0)


def fast_response(img, threshold: float = 20.0, arc: int = 9):
    """FAST segment-test response map [H, W] (0 where not a corner).

    Score: sum over circle pixels of |p_i - center| - threshold for the
    brighter/darker set, cv2's FAST score semantics (max over the two
    polarities).
    """
    c = _circle_stack(img)              # [16, H, W]
    center = img[None]
    brighter = c > center + threshold
    darker = c < center - threshold

    def has_arc(mask):
        # contiguous run >= arc among the 16 circular positions: AND of
        # `arc` circularly shifted copies, any start position
        prod = torch.ones_like(mask)
        ext = torch.cat([mask, mask], dim=0)
        for k in range(arc):
            prod = prod & ext[k:k + 16]
        return torch.any(prod, dim=0)

    zero = torch.zeros((), dtype=img.dtype, device=img.device)
    is_b = has_arc(brighter)
    is_d = has_arc(darker)
    score_b = torch.sum(torch.where(brighter, c - center - threshold, zero),
                        dim=0)
    score_d = torch.sum(torch.where(darker, center - c - threshold, zero),
                        dim=0)
    resp = torch.maximum(torch.where(is_b, score_b, zero),
                         torch.where(is_d, score_d, zero))
    # kill the 3-pixel border (rolled copies wrap around)
    H, W = img.shape
    ys = torch.arange(H, device=img.device)[:, None]
    xs = torch.arange(W, device=img.device)[None, :]
    interior = (ys >= 3) & (ys < H - 3) & (xs >= 3) & (xs < W - 3)
    return torch.where(interior, resp, zero)


def fast_detect(img, threshold: float = 20.0, max_corners: int = 512,
                arc: int = 9, nonmax: bool = True):
    """FAST corners sorted by response, ties in raster order (the order
    ``lax.top_k`` gives; ``torch.topk`` promises none, so this is a stable
    descending sort).

    Returns (uv [max_corners, 2] f32, score [max_corners], valid bool).
    """
    resp = fast_response(img, threshold, arc)
    if nonmax:
        # max_pool2d pads with -inf, as reduce_window(max, SAME) does
        nms = F.max_pool2d(resp[None, None], 3, stride=1, padding=1)[0, 0]
        resp = torch.where(resp >= nms, resp, torch.zeros_like(resp))
    flat = resp.reshape(-1)
    score, idx = torch.sort(flat, descending=True, stable=True)
    score, idx = score[:max_corners], idx[:max_corners]
    W = img.shape[1]
    uv = torch.stack([(idx % W).to(torch.float32),
                      (idx // W).to(torch.float32)], dim=1)
    return uv, score, score > 0
