"""Pyramidal Lucas-Kanade sparse optical flow.

Replaces ``cv2.calcOpticalFlowPyrLK`` with the defaults the front-end relies
on: 21x21 window, 3 pyramid levels, <= 30 Newton iterations with eps = 0.01,
min-eigenvalue rejection at 1e-4 (0..255 intensity scale), ``err`` = mean
absolute window intensity difference.

The port has ONE LK semantics, that of the JAX package's tiled level loop
(``ops/lk.py::_lk_tiled_levels`` there): per level, integer region corners
and fractional anchors are formed here in tensor ops, and the level itself
runs in ``ops/lk_tile.lk_level`` — the hand-written CUDA kernel on the card,
its plain version on the CPU.  The window start is capped at
``hiX = P - 2 - win`` on both axes.  Pyramid building and ``bilinear_sample``
are plain PyTorch.
"""

import torch
import torch.nn.functional as F

from mqslam_tpu_torch.ops import lk_tile

__all__ = ["build_pyramid", "lk_pad", "lk_track", "lk_track_pyr",
           "bilinear_sample"]


def lk_pad(win: int = 21, margin: int = 7) -> int:
    """Edge padding lk_track_pyr(prepad=True) expects on every level."""
    return win // 2 + margin + 1


def _pad2d(img, pad, mode):
    """F.pad over the last two dims of [..., H, W] (pad = (l, r, t, b));
    the non-constant modes need a 4-D input."""
    lead = img.shape[:-2]
    x = img.reshape((-1, 1) + img.shape[-2:])
    x = F.pad(x, pad, mode=mode)
    return x.reshape(lead + x.shape[-2:])


def _pyrdown(img):
    """5x5 binomial blur + 2x decimation (the cv2.pyrDown kernel), as
    decimate-then-filter over strided slices; [..., H, W]."""
    k = (1.0, 4.0, 6.0, 4.0, 1.0)
    H, W = img.shape[-2:]
    p = _pad2d(img, (0, 0, 2, 2), "reflect")
    v = sum(ki * p[..., i:i + H:2, :] for i, ki in enumerate(k)) / 16.0
    p = _pad2d(v, (2, 2, 0, 0), "reflect")
    return sum(ki * p[..., :, i:i + W:2] for i, ki in enumerate(k)) / 16.0


def build_pyramid(img, levels: int = 3, pad: int = 0):
    """List of ``levels`` images [..., H_l, W_l], level 0 = full resolution.

    pad > 0 edge-pads every level by that amount (for
    lk_track_pyr(prepad=True), use pad=lk_pad(win, margin)); downsampling
    always operates on the unpadded content."""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(_pyrdown(pyr[-1]))
    if pad:
        pyr = [_pad2d(l, (pad, pad, pad, pad), "replicate") for l in pyr]
    return pyr


def bilinear_sample(img, xy):
    """Bilinear sample img [..., H, W] at xy [..., N, 2] (x, y),
    edge-clamped; the leading dims of img and xy must be equal."""
    H, W = img.shape[-2:]
    x = torch.clamp(xy[..., 0], 0.0, W - 1.000001)
    y = torch.clamp(xy[..., 1], 0.0, H - 1.000001)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    fx = x - x0.to(x.dtype)
    fy = y - y0.to(y.dtype)
    flat = img.reshape(img.shape[:-2] + (H * W,))
    v00 = torch.gather(flat, -1, y0 * W + x0)
    v01 = torch.gather(flat, -1, y0 * W + x1)
    v10 = torch.gather(flat, -1, y1 * W + x0)
    v11 = torch.gather(flat, -1, y1 * W + x1)
    return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
            + fy * ((1 - fx) * v10 + fx * v11))


def lk_track(prev_img, next_img, pts, pts_valid=None, win: int = 21,
             levels: int = 3, iters: int = 30, eps: float = 0.01,
             min_eig_threshold: float = 1e-4, margin: int = 7):
    """Track pts [N, 2] from prev_img to next_img ([H, W] each).

    Returns (new_pts [N, 2], status [N] bool, err [N] f32). ``err`` is the
    mean absolute intensity difference over the window (cv2 flags=0)."""
    return lk_track_pyr(build_pyramid(prev_img, levels),
                        build_pyramid(next_img, levels),
                        pts, pts_valid, win=win, iters=iters, eps=eps,
                        min_eig_threshold=min_eig_threshold, margin=margin)


def lk_track_pyr(prev_pyr, next_pyr, pts, pts_valid=None, win: int = 21,
                 iters: int = 30, eps: float = 0.01,
                 min_eig_threshold: float = 1e-4, margin: int = 7,
                 prepad: bool = False, atlas_agents=None,
                 atlas_tiles: int = 1, atlas_contiguous: bool = False):
    """lk_track over prebuilt pyramids (sequences of [H, W] images, level 0 =
    full resolution), so sequential trackers build one pyramid per frame.

    ``prepad=True`` declares that every level is already edge-padded by
    ``lk_pad(win, margin)`` (see build_pyramid(pad=...)); coordinates are
    still unpadded-image coordinates.

    Atlas mode (multi-agent): per-level images vertically stacked from
    ``atlas_tiles`` equally-sized pre-padded tiles (one agent each); tracks
    keep their own tile coordinates and must be agent-contiguous — track t
    belongs to tile ``t // (T / atlas_tiles)``.  Say so with
    ``atlas_contiguous=True`` (no check, no host sync) or pass
    ``atlas_agents`` [T] to have it checked.  Scattered agent ids are the
    job of the strip kernel (``lk_level_fused`` in the JAX package), which
    is not ported yet: they raise ``NotImplementedError``."""
    levels = len(prev_pyr)
    T = pts.shape[0]
    dt = pts.dtype
    dev = pts.device
    if pts_valid is None:
        pts_valid = torch.ones(T, dtype=torch.bool, device=dev)
    r = win // 2
    pad = r + margin + 1  # corners never clamp for in-image points
    A = int(atlas_tiles)

    if A > 1 and not prepad:
        raise ValueError("atlas mode requires prepadded pyramids")
    if A > 1 and not atlas_contiguous:
        if atlas_agents is None or T % A or not torch.equal(
                atlas_agents.to(torch.int64),
                torch.arange(T, device=atlas_agents.device) // (T // A)):
            raise NotImplementedError(
                "lk_track_pyr: tracks that are not agent-contiguous need "
                "the per-track strip kernel (K2, lk_level_fused), which is "
                "not ported yet")
    if prepad:
        Js, Is = list(prev_pyr), list(next_pyr)
    else:
        Js = [_pad2d(l, (pad,) * 4, "replicate") for l in prev_pyr]
        Is = [_pad2d(l, (pad,) * 4, "replicate") for l in next_pyr]
    shapes = [(j.shape[0] // A - 2 * pad, j.shape[1] - 2 * pad) for j in Js]

    # tracks outside any level are invalid before a region is formed; NaN
    # coordinates (never-initialised slots) compare false and land here too
    inside_all = torch.ones(T, dtype=torch.bool, device=dev)
    for lvl in range(levels):
        H, W = shapes[lvl]
        p_l = pts / (2.0 ** lvl) + pad
        hi = torch.tensor([W - 1 + pad, H - 1 + pad], dtype=dt, device=dev)
        inside_all = inside_all & torch.all((p_l >= pad) & (p_l <= hi),
                                            dim=-1)
    status = pts_valid & inside_all
    # invalid tracks run on zeroed coordinates: nothing downstream forms an
    # address from a NaN; their outputs are gated by status below
    pts_s = torch.where(status[:, None], pts, torch.zeros_like(pts))

    P = win + 2 * margin + 1
    hiX = float(P - 2 - win)
    f32 = torch.float32
    g = torch.zeros_like(pts_s)
    err = None
    for lvl in range(levels - 1, -1, -1):
        imgJ = Js[lvl].to(f32).contiguous()
        imgI = Is[lvl].to(f32).contiguous()
        Hp, Wp = imgJ.shape[0] // A, imgJ.shape[1]
        p_l = pts_s / (2.0 ** lvl) + pad
        pya, pxa = p_l[:, 1], p_l[:, 0]
        cyJ = torch.clamp(torch.floor(pya).to(torch.int32) - r - 1, 0,
                          Hp - (win + 3))
        cxJ = torch.clamp(torch.floor(pxa).to(torch.int32) - r - 1, 0,
                          Wp - (win + 3))
        aJy = torch.clamp(pya.to(f32) - r - cyJ, min=1.0)
        aJx = torch.clamp(pxa.to(f32) - r - cxJ, min=1.0)
        q0 = p_l + g
        q0ya, q0xa = q0[:, 1], q0[:, 0]
        cyI = torch.clamp(torch.floor(q0ya).to(torch.int32) - r - margin, 0,
                          Hp - P)
        cxI = torch.clamp(torch.floor(q0xa).to(torch.int32) - r - margin, 0,
                          Wp - P)
        a0y = torch.clamp(q0ya.to(f32) - r - cyI, 0.0, hiX)
        a0x = torch.clamp(q0xa.to(f32) - r - cxI, 0.0, hiX)
        a_fin, eig, err_l = lk_tile.lk_level(
            imgJ, imgI,
            torch.stack([cyJ, cxJ], dim=1), torch.stack([cyI, cxI], dim=1),
            torch.stack([aJy, aJx], dim=1), torch.stack([a0y, a0x], dim=1),
            status, A, win, iters, eps, hiX, want_err=(lvl == 0))
        status = status & (eig >= min_eig_threshold)
        q = torch.stack([(cxI + r).to(dt) + a_fin[:, 1].to(dt),
                         (cyI + r).to(dt) + a_fin[:, 0].to(dt)], dim=1)
        g_new = q - p_l
        g = g_new * 2.0 if lvl > 0 else g_new
        if lvl == 0:
            err = err_l

    new_pts = pts + g
    H0, W0 = shapes[0]
    hi0 = torch.tensor([W0 - 1, H0 - 1], dtype=dt, device=dev)
    inside_final = torch.all((new_pts >= 0) & (new_pts <= hi0), dim=-1)
    status = status & inside_final
    return new_pts, status, torch.where(
        status, err, torch.full_like(err, float("inf")))
