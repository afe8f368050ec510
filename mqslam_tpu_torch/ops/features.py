"""Shi-Tomasi (GFTT) corner detection — response maps + grid NMS.

Replaces ``cv2.goodFeaturesToTrack`` + the keypoint mask of the front-end's
refill (quality_level = 0.01, min_dist = 12).

Sobel gradients and the box-filtered structure tensor are separable
shifted-add chains; min-eigenvalue response and 3x3 NMS are elementwise /
pooling ops; the min-distance constraint is enforced by a static cell grid
(one winner per min_dist-sized cell) instead of OpenCV's sequential greedy
suppression — same spacing guarantee up to a factor 2, fully parallel, fixed
output shape [max_corners] with a validity mask.  Every function takes
images [..., H, W] with leading batch dims.
"""

import torch
import torch.nn.functional as F

__all__ = ["shi_tomasi_response", "detect_corners", "min_distance_mask"]


def _shift(img, dy, dx):
    """Edge-replicated shift of [..., H, W]: out[y, x] = img[clamp(y + dy),
    clamp(x + dx)] (the JAX package's pad + static slice)."""
    H, W = img.shape[-2:]
    ys = torch.clamp(torch.arange(H, device=img.device) + dy, 0, H - 1)
    xs = torch.clamp(torch.arange(W, device=img.device) + dx, 0, W - 1)
    return img.index_select(-2, ys).index_select(-1, xs)


def _sep3(img, kx, ky):
    """Separable 3-tap filter via edge-replicated shifted adds."""
    H, W = img.shape[-2:]
    lead = img.shape[:-2]
    x = img.reshape((-1, 1, H, W))
    p = F.pad(x, (1, 1, 0, 0), mode="replicate")
    t = kx[0] * p[..., :, 0:W] + kx[1] * x + kx[2] * p[..., :, 2:W + 2]
    p = F.pad(t, (0, 0, 1, 1), mode="replicate")
    out = ky[0] * p[..., 0:H, :] + ky[1] * t + ky[2] * p[..., 2:H + 2, :]
    return out.reshape(lead + (H, W))


def shi_tomasi_response(img, block_size: int = 3):
    """Min-eigenvalue corner response of grayscale image(s) [..., H, W].

    cv2.goodFeaturesToTrack semantics: Sobel(3) gradients, box-summed
    structure tensor over a 3x3 block, lambda_min response."""
    if block_size != 3:
        raise NotImplementedError("only block_size=3 is supported")
    ix = _sep3(img, (-0.125, 0.0, 0.125), (1.0, 2.0, 1.0))
    iy = _sep3(img, (1.0, 2.0, 1.0), (-0.125, 0.0, 0.125))
    box = (1.0, 1.0, 1.0)
    ixx = _sep3(ix * ix, box, box)
    iyy = _sep3(iy * iy, box, box)
    ixy = _sep3(ix * iy, box, box)
    tr = 0.5 * (ixx + iyy)
    det_part = torch.sqrt(torch.clamp(
        0.25 * (ixx - iyy) ** 2 + ixy * ixy, min=0.0))
    return tr - det_part  # lambda_min


def min_distance_mask(candidates, existing, existing_valid, radius):
    """False where a candidate lies within ``radius`` of any valid existing
    point.  candidates [..., C, 2], existing [..., K, 2], existing_valid
    [..., K] bool."""
    d2 = torch.sum((candidates[..., :, None, :]
                    - existing[..., None, :, :]) ** 2, dim=-1)
    near = (d2 < radius * radius) & existing_valid[..., None, :]
    return ~torch.any(near, dim=-1)


def detect_corners(img, max_corners: int, quality_level=0.01,
                   cell: int = 12, existing=None, existing_valid=None,
                   block_size: int = 3):
    """Detect up to ``max_corners`` Shi-Tomasi corners with grid-enforced
    min distance ~``cell`` px, avoiding ``existing`` points by ``cell`` px.

    img [..., H, W].  Returns (uv [..., max_corners, 2] f32, valid
    [..., max_corners] bool) sorted by decreasing response.  Static output
    shape; pad entries have valid=False (their uv is unspecified: top-k
    orders the -inf ties arbitrarily)."""
    H, W = img.shape[-2:]
    lead = img.shape[:-2]
    neg_inf = float("-inf")
    resp = shi_tomasi_response(img, block_size)
    # 3x3 non-max suppression; max_pool2d pads with -inf implicitly
    nms = F.max_pool2d(resp.reshape((-1, 1, H, W)), 3, stride=1,
                       padding=1).reshape(resp.shape)
    is_peak = resp >= nms
    thresh = quality_level * resp.amax(dim=(-2, -1), keepdim=True)
    ok = is_peak & (resp > thresh)
    resp_ok = torch.where(ok, resp, torch.full_like(resp, neg_inf))

    # one winner per cell x cell block
    ch = -(-H // cell)
    cw = -(-W // cell)
    padded = F.pad(resp_ok, (0, cw * cell - W, 0, ch * cell - H),
                   value=neg_inf)
    blocks = padded.reshape(lead + (ch, cell, cw, cell))
    nd = len(lead)
    blocks = blocks.permute(tuple(range(nd)) + (nd, nd + 2, nd + 1, nd + 3))
    blocks = blocks.reshape(lead + (ch * cw, cell * cell))
    best_resp, best_in_cell = torch.max(blocks, dim=-1)
    cy = best_in_cell // cell
    cx = best_in_cell % cell
    cell_ids = torch.arange(ch * cw, device=img.device)
    ys = (cell_ids // cw) * cell + cy
    xs = (cell_ids % cw) * cell + cx
    cand = torch.stack([xs, ys], dim=-1).to(img.dtype)
    valid = best_resp > neg_inf

    if existing is not None:
        far = min_distance_mask(cand, existing, existing_valid, radius=cell)
        valid = valid & far

    score = torch.where(valid, best_resp, torch.full_like(best_resp, neg_inf))
    top_score, order = torch.topk(score, max_corners, dim=-1)
    uv = torch.gather(cand, -2, order[..., None].expand(order.shape + (2,)))
    return uv, top_score > neg_inf
