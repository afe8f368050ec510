"""Chessboard inner-corner detection, grid ordering, subpixel refinement.

Fills the role of ``cv2.findChessboardCorners`` + ``cv2.cornerSubPix``
(reference: Work/python_libs/cv2_helpers.py:243-260 extractChessboardFeatures,
used by the slam2 chessboard bootstrap slam2.py:1121-1129 and the whole
calibration suite calibrate.py:38):

- **Response map** (device): a chessboard inner corner is a saddle point, so
  on a ring of 16 samples the 2nd circular harmonic dominates while edges
  and single-square corners carry 1st-harmonic energy.  Response =
  |2nd harmonic|^2 - |1st harmonic|^2 of the ring, for every pixel at once
  from 16 edge-replicated shifted copies of the image (the ChESS detector's
  idea, Bennett & Lasenby 2014).
- **Grid ordering** (host NumPy, O(N^2) on ~50 points once per image):
  extreme corners -> exact homography of the unit grid -> greedy unique
  nearest-candidate assignment -> homography refit, iterated; both grid
  orientations are tried and the lower-residual bijection wins.  Corners
  come back row-major (row r, col c -> index r*cols + c).
- **Subpixel refinement** (device): cv2.cornerSubPix's fixed point, the
  gradient-weighted centroid q with sum_i w_i (g_i g_i^T)(p_i - q) = 0 over
  the window, iterated on per-corner patches through the LK tracker's banded
  window products, a 2x2 solve per corner per iteration.
"""

import numpy as np
import torch
import torch.nn.functional as F

from mqslam_tpu_torch import resolve_device
from mqslam_tpu_torch.ops import features, linalg, lk

__all__ = ["chess_response", "detect_corner_candidates", "corner_subpix",
           "order_chessboard_corners", "find_chessboard_corners",
           "extract_chessboard_features"]


def _ring_offsets(radius: int = 5, n: int = 16):
    """Integer ring offsets (dy, dx) and their exact angles."""
    th = 2.0 * np.pi * np.arange(n) / n
    dx = np.rint(radius * np.cos(th)).astype(int)
    dy = np.rint(radius * np.sin(th)).astype(int)
    ang = np.arctan2(dy, dx)  # angle of the *rounded* offset (less bias)
    return list(zip(dy.tolist(), dx.tolist())), ang


def chess_response(img, radius: int = 5):
    """Saddle-point response map [H, W] of a grayscale float32 image.

    R = |H2|^2 - |H1|^2 with Hk = sum_n a_n e^{i k theta_n} over a 16-sample
    ring of radius ``radius``; a light 3x3 binomial blur suppresses pixel
    noise first.  Positive only near chessboard inner corners.  The ring
    terms are summed in float32 in the JAX package's order, each
    coefficient rounded to float32 as there."""
    img = features._sep3(img, (0.25, 0.5, 0.25), (0.25, 0.5, 0.25))
    offs, ang = _ring_offsets(radius)
    c1 = torch.zeros_like(img)
    s1 = torch.zeros_like(img)
    c2 = torch.zeros_like(img)
    s2 = torch.zeros_like(img)
    f32 = lambda x: float(np.float32(x))
    for (dy, dx), a in zip(offs, ang):
        v = features._shift(img, dy, dx)
        c1 = c1 + f32(np.cos(a)) * v
        s1 = s1 + f32(np.sin(a)) * v
        c2 = c2 + f32(np.cos(2 * a)) * v
        s2 = s2 + f32(np.sin(2 * a)) * v
    return (c2 * c2 + s2 * s2) - (c1 * c1 + s1 * s1)


def _max_window(resp, nms: int):
    """reduce_window(max, (nms, nms), SAME) with -inf padding: SAME pads
    (nms - 1) // 2 before and nms // 2 after."""
    lo, hi = (nms - 1) // 2, nms // 2
    x = F.pad(resp[None, None], (lo, hi, lo, hi), value=float("-inf"))
    return F.max_pool2d(x, nms, stride=1)[0, 0]


def detect_corner_candidates(img, max_corners: int = 128, radius: int = 5,
                             quality: float = 0.2, nms: int = 5):
    """Top-``max_corners`` saddle-point candidates by response.

    img [H, W].  Returns (uv [max_corners, 2] f32, response [max_corners]
    f32, valid [max_corners] bool), sorted by decreasing response, ties
    (the -inf pad entries among them) in raster order as ``lax.top_k``
    gives them: a stable descending sort.  ``quality`` thresholds relative
    to the maximum response."""
    H, W = img.shape
    resp = chess_response(img.to(torch.float32), radius)
    # tiny deterministic positional bias breaks plateau ties so each corner
    # yields exactly one NMS peak (symmetric saddles have flat-topped
    # responses at half-integer centers)
    ys = torch.arange(H, dtype=resp.dtype, device=resp.device)[:, None]
    xs = torch.arange(W, dtype=resp.dtype, device=resp.device)[None, :]
    resp = resp * (1.0 + 1e-6 * ((ys % 3) + (xs % 3)))
    mx = _max_window(resp, nms)
    ok = (resp >= mx) & (resp > quality * torch.amax(resp)) & (resp > 0)
    score = torch.where(ok, resp, torch.full_like(resp, float("-inf")))
    top, idx = torch.sort(score.reshape(-1), descending=True, stable=True)
    top, idx = top[:max_corners], idx[:max_corners]
    uv = torch.stack([(idx % W).to(torch.float32),
                      (idx // W).to(torch.float32)], dim=1)
    return uv, top, top > float("-inf")


def corner_subpix(img, uv, valid=None, win: int = 11, iters: int = 30,
                  eps: float = 0.001, margin: int = 3):
    """Refine corners to subpixel accuracy (cv2.cornerSubPix semantics:
    (11,11) window, 30 iterations, eps 0.001 — cv2_helpers.py:253-256).

    img [H, W] f32, uv [N, 2].  Returns (uv_refined [N, 2], ok [N] bool);
    ok=False where the corner left the window margin (diverged).

    Always ``iters`` iterations, with no read of the device: a converged
    corner steps 0 and the clip is idempotent, so the JAX package's early
    exit once every corner has converged gives the same numbers."""
    if valid is None:
        valid = torch.ones(uv.shape[0], dtype=torch.bool, device=uv.device)
    r = win // 2
    side = 2 * r + 1
    P = side + 2 * margin + 2  # +2: interpolation tap + gradient border
    pad = r + margin + 2
    dt = uv.dtype
    dev = uv.device
    imgp = lk._pad2d(img.to(torch.float32), (pad, pad, pad, pad),
                     "replicate")
    p0 = uv + pad  # padded coords

    corner = torch.stack([
        torch.floor(p0[:, 1]).to(torch.int32) - r - margin - 1,
        torch.floor(p0[:, 0]).to(torch.int32) - r - margin - 1], dim=1)
    patch, cy, cx = lk._extract_patches(imgp, corner, P)
    base = torch.stack([cx.to(dt), cy.to(dt)], dim=1)  # (x, y)

    gx = F.pad(0.5 * (patch[:, :, 2:] - patch[:, :, :-2]), (1, 1, 0, 0))
    gy = F.pad(0.5 * (patch[:, 2:, :] - patch[:, :-2, :]), (0, 0, 1, 1))
    grads = torch.stack([gx * gx, gx * gy, gy * gy], dim=1)  # [N, 3, P, P]

    # cv2-style separable window weights exp(-(d/r)^2)
    d = torch.arange(side, dtype=torch.float32, device=dev) - r
    w1 = torch.exp(-(d / max(r, 1)) ** 2)
    wmask = w1[:, None] * w1[None, :]
    dy_grid = d[:, None] * torch.ones((1, side), device=dev)
    dx_grid = torch.ones((side, 1), device=dev) * d[None, :]

    lo = base + r  # window center must stay >= r inside the patch
    hi = base + P - 2 - r

    q = torch.clamp(p0, lo, hi)
    done = ~valid
    with lk._exact_f32():
        for _ in range(iters):
            a = q - r - base  # window start (x, y) in patch coords
            wins = lk._window_multi(grads, a[:, 1], a[:, 0], side)
            wxx = wins[:, 0] * wmask
            wxy = wins[:, 1] * wmask
            wyy = wins[:, 2] * wmask
            A00 = torch.sum(wxx, dim=(1, 2))
            A01 = torch.sum(wxy, dim=(1, 2))
            A11 = torch.sum(wyy, dim=(1, 2))
            bx = torch.sum(wxx * dx_grid + wxy * dy_grid, dim=(1, 2))
            by = torch.sum(wxy * dx_grid + wyy * dy_grid, dim=(1, 2))
            sx, sy = linalg.solve2x2_sym(A00, A01, A11, bx, by)
            step = torch.stack([sx, sy], dim=-1)
            step = torch.where(done[:, None], torch.zeros_like(step), step)
            q = torch.clamp(q + step, lo, hi)
            done = done | (torch.sum(step * step, dim=-1) < eps * eps)
    moved = torch.sqrt(torch.sum((q - p0) ** 2, dim=-1))
    ok = valid & (moved < r)  # diverged corners drift to the clamp
    return q - pad, ok


def _fit_h_exact(src4, dst4):
    """Homography from 4 point pairs (exact DLT, host numpy)."""
    return _fit_h_ls(src4, dst4)


def _fit_h_ls(src, dst):
    """Least-squares homography src -> dst (normalized DLT, host numpy)."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    ms, ss = src.mean(0), src.std() + 1e-12
    md, sd = dst.mean(0), dst.std() + 1e-12
    s = (src - ms) / ss
    t = (dst - md) / sd
    n = len(src)
    A = np.zeros((2 * n, 9))
    A[0::2, 0:2] = s
    A[0::2, 2] = 1
    A[0::2, 6:8] = -t[:, 0:1] * s
    A[0::2, 8] = -t[:, 0]
    A[1::2, 3:5] = s
    A[1::2, 5] = 1
    A[1::2, 6:8] = -t[:, 1:2] * s
    A[1::2, 8] = -t[:, 1]
    _, _, vt = np.linalg.svd(A)
    Hn = vt[-1].reshape(3, 3)
    Ts = np.array([[1 / ss, 0, -ms[0] / ss], [0, 1 / ss, -ms[1] / ss],
                   [0, 0, 1]])
    Td = np.array([[sd, 0, md[0]], [0, sd, md[1]], [0, 0, 1]])
    return Td @ Hn @ Ts


def _apply_h(H, pts):
    p = np.concatenate([pts, np.ones((len(pts), 1))], axis=1) @ H.T
    return p[:, :2] / p[:, 2:3]


def _greedy_unique_assign(proj, cand):
    """For each projected grid node, the nearest unclaimed candidate.

    Returns (idx [G] into cand or -1, dists [G]).  Greedy over globally
    increasing pair distance."""
    G, C = len(proj), len(cand)
    d = np.linalg.norm(proj[:, None, :] - cand[None, :, :], axis=-1)
    idx = -np.ones(G, int)
    dist = np.full(G, np.inf)
    order = np.argsort(d, axis=None)
    used_g = np.zeros(G, bool)
    used_c = np.zeros(C, bool)
    n_done = 0
    for k in order:
        g, c = divmod(k, C)
        if used_g[g] or used_c[c]:
            continue
        idx[g] = c
        dist[g] = d[g, c]
        used_g[g] = used_c[c] = True
        n_done += 1
        if n_done == G:
            break
    return idx, dist


def order_chessboard_corners(cand_uv, board_size, tol_frac: float = 0.35):
    """Order corner candidates into a (cols, rows) grid, row-major.

    cand_uv [C, 2] host array (C >= cols*rows; spurious candidates stay
    unassigned).  board_size = (cols, rows), the cv2 patternSize
    convention.  Returns (ok, corners [rows*cols, 2] float32) with index
    r*cols + c.  A solution is valid when every node's match lies within
    ``tol_frac`` of the median grid spacing."""
    cols, rows = int(board_size[0]), int(board_size[1])
    N = cols * rows
    cand = np.asarray(cand_uv, np.float64)
    if len(cand) < N:
        return False, np.zeros((N, 2), np.float32)

    s = cand[:, 0] + cand[:, 1]
    dif = cand[:, 0] - cand[:, 1]
    ex = [cand[np.argmin(s)], cand[np.argmax(dif)],
          cand[np.argmax(s)], cand[np.argmin(dif)]]  # TL, TR, BR, BL

    grid = np.stack(np.meshgrid(np.arange(cols), np.arange(rows)),
                    -1).reshape(-1, 2).astype(np.float64)  # (c, r) pairs

    best = None
    for corners4 in (
            # TL->TR along the c axis
            np.array([[0, 0], [cols - 1, 0], [cols - 1, rows - 1],
                      [0, rows - 1]], np.float64),
            # TL->TR along the r axis (board rotated ~90 deg)
            np.array([[0, 0], [0, rows - 1], [cols - 1, rows - 1],
                      [cols - 1, 0]], np.float64)):
        H = _fit_h_exact(corners4, np.asarray(ex))
        idx = None
        for _ in range(3):
            proj = _apply_h(H, grid)
            idx, dist = _greedy_unique_assign(proj, cand)
            if (idx < 0).any():
                break
            H = _fit_h_ls(grid[idx >= 0], cand[idx[idx >= 0]])
        if idx is None or (idx < 0).any():
            continue
        proj = _apply_h(H, grid)
        dist = np.linalg.norm(proj - cand[idx], axis=-1)
        # grid spacing from adjacent projected nodes in the first row
        spacing = np.median(np.linalg.norm(
            proj.reshape(rows, cols, 2)[:, 1:] -
            proj.reshape(rows, cols, 2)[:, :-1], axis=-1))
        score = dist.max() / max(spacing, 1e-9)
        if score < tol_frac and (best is None or score < best[0]):
            best = (score, cand[idx])
    if best is None:
        return False, np.zeros((N, 2), np.float32)
    return True, best[1].astype(np.float32)


def find_chessboard_corners(img, board_size, max_candidates: int = 0,
                            quality: float = 0.2, refine: bool = True,
                            device=None):
    """Full pipeline: response -> candidates -> grid ordering -> subpixel.

    img [H, W] grayscale (NumPy array or tensor, 0..255), board_size
    (cols, rows).  Returns (ok, corners [rows*cols, 2] float32 NumPy)
    row-major — the cv2.findChessboardCorners + cornerSubPix contract of
    extractChessboardFeatures (cv2_helpers.py:243-260).  The response and
    the refinement run on ``device`` (None: the CUDA device); the
    candidates come to the host once for the ordering."""
    device = resolve_device(device)
    cols, rows = int(board_size[0]), int(board_size[1])
    N = cols * rows
    if not max_candidates:
        max_candidates = N + max(16, N // 2)
    if torch.is_tensor(img):
        img = img.to(device=device, dtype=torch.float32)
    else:
        img = torch.as_tensor(np.asarray(img, np.float32)).to(device)
    uv, _, valid = detect_corner_candidates(img, max_corners=max_candidates,
                                            quality=quality)
    got = torch.cat([uv, valid[:, None].to(uv.dtype)], dim=1).cpu().numpy()
    cand = got[got[:, 2] > 0, :2]
    ok, corners = order_chessboard_corners(cand, board_size)
    if not ok:
        return False, corners
    if refine:
        ref, okr = corner_subpix(img, torch.as_tensor(corners).to(device))
        got = torch.cat([ref, okr[:, None].to(ref.dtype)],
                        dim=1).cpu().numpy()
        corners = np.where(got[:, 2:] > 0, got[:, :2],
                           corners).astype(np.float32)
    return True, corners


def extract_chessboard_features(img, board_size, device=None):
    """Name-parity wrapper of cv2_helpers.py:243-260 (grayscale input)."""
    return find_chessboard_corners(img, board_size, device=device)
