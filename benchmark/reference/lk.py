"""Plain pyramidal Lucas-Kanade, the semantics of the port's LK kernels.

Frozen copy, in plain PyTorch, of the level loop of
``mqslam_tpu_torch/ops/lk.py:244-301`` (the kernel branch of
``lk_track_pyr``: per level, integer region corners and fractional anchors,
the window start capped at ``hiX = P - 2 - win``), its pyramid
(``lk.py:63-85``, ``_pyrdown`` / ``build_pyramid``), its ``_finish``
(``lk.py:530-539``) and one level of
``mqslam_tpu_torch/ops/lk_tile.py:140-231``
(``lk_level_plain``): the template window and its central-difference
gradients from one lerped (win+2)^2 grid, up to ``iters`` Newton steps
that stop below ``eps``, the minimum-eigenvalue test, the mean absolute
error at level 0.  Each image of the batch is its own tile, which is what
both kernels see (K1 clamps regions to an agent's tile of the atlas, K2 to
its one image).

``dtype`` is the type of the image data and of the window arithmetic
(templates, gradients, sums, the 2x2 solve); coordinates stay in float32.
The reference runs in float32; the lower-precision control in bfloat16.
Imports nothing of the program.
"""

import torch
import torch.nn.functional as F

__all__ = ["pyramid", "track"]


def _pad2d(img, pad, mode):
    lead = img.shape[:-2]
    x = img.reshape((-1, 1) + img.shape[-2:])
    x = F.pad(x, pad, mode=mode)
    return x.reshape(lead + x.shape[-2:])


def _pyrdown(img):
    k = (1.0, 4.0, 6.0, 4.0, 1.0)
    H, W = img.shape[-2:]
    p = _pad2d(img, (0, 0, 2, 2), "reflect")
    v = sum(ki * p[..., i:i + H:2, :] for i, ki in enumerate(k)) / 16.0
    p = _pad2d(v, (2, 2, 0, 0), "reflect")
    return sum(ki * p[..., :, i:i + W:2] for i, ki in enumerate(k)) / 16.0


def pyramid(imgs, levels):
    """Levels of float32 images [B, H, W], level 0 first (unpadded)."""
    pyr = [imgs.to(torch.float32)]
    for _ in range(levels - 1):
        pyr.append(_pyrdown(pyr[-1]))
    return pyr


def _level(imgJ, imgI, cJ, cI, aJ, a0, ok, tile, Hp, win, iters, eps, hiX,
           dt):
    """One level for tracks [T] on stacked tiles [B * Hp, Wp]; corners
    tile-local.  Returns (anchor [T, 2] (y, x), min_eig [T], err [T])."""
    T = cJ.shape[0]
    dev = imgJ.device
    Wp = imgJ.shape[1]
    P = int(round(hiX)) + 2 + win
    W2 = win + 2
    z2 = ok[:, None]
    cJ = torch.where(z2, cJ, torch.zeros_like(cJ)).long()
    cI = torch.where(z2, cI, torch.zeros_like(cI)).long()
    aJs = torch.where(z2, aJ, torch.ones_like(aJ))
    a = torch.where(z2, a0, torch.zeros_like(a0))
    off = tile.long() * Hp

    def region(img, row0, col0, n):
        k = torch.arange(n, device=dev)
        rows = (row0[:, None] + k).clamp(0, Hp - 1) + off[:, None]
        cols = (col0[:, None] + k).clamp(0, Wp - 1)
        return img[rows[:, :, None], cols[:, None, :]]

    iyJ = torch.floor(aJs[:, 0])
    ixJ = torch.floor(aJs[:, 1])
    fyJ = (aJs[:, 0] - iyJ)[:, None, None].to(dt)
    fxJ = (aJs[:, 1] - ixJ)[:, None, None].to(dt)
    R = region(imgJ, cJ[:, 0] + iyJ.long() - 1, cJ[:, 1] + ixJ.long() - 1,
               W2 + 1)
    slab = (1.0 - fyJ) * R[:, :W2, :] + fyJ * R[:, 1:, :]
    C = (1.0 - fxJ) * slab[:, :, :W2] + fxJ * slab[:, :, 1:]
    Jw = C[:, 1:win + 1, 1:win + 1]
    dx = 0.5 * (C[:, 1:win + 1, 2:] - C[:, 1:win + 1, :win])
    dy = 0.5 * (C[:, 2:, 1:win + 1] - C[:, :win, 1:win + 1])
    g00 = (dx * dx).sum((1, 2))
    g01 = (dx * dy).sum((1, 2))
    g11 = (dy * dy).sum((1, 2))
    det = g00 * g11 - g01 * g01
    det = torch.where(det.abs() > 1e-20, det, torch.full_like(det, 1e-20))
    tr = 0.5 * (g00 + g11)
    min_eig = (tr - torch.sqrt(torch.clamp(
        0.25 * (g00 - g11) ** 2 + g01 * g01, min=0.0))) / (win * win)

    pI = region(imgI, cI[:, 0], cI[:, 1], P)
    kw = torch.arange(win, device=dev)
    hi_i = int(hiX)

    def samp(ay, ax):
        iy = torch.nan_to_num(torch.floor(ay)).clamp(0, hi_i)
        ix = torch.nan_to_num(torch.floor(ax)).clamp(0, hi_i)
        fy = (ay - iy)[:, None, None].to(dt)
        fx = (ax - ix)[:, None, None].to(dt)
        ri = (iy.long()[:, None] + kw)[:, :, None].expand(T, win, P)
        rows = ((1.0 - fy) * torch.gather(pI, 1, ri)
                + fy * torch.gather(pI, 1, ri + 1))
        ci = (ix.long()[:, None] + kw)[:, None, :].expand(T, win, win)
        return ((1.0 - fx) * torch.gather(rows, 2, ci)
                + fx * torch.gather(rows, 2, ci + 1))

    done = ~ok
    for _ in range(iters):
        if bool(done.all()):
            break
        diff = Jw - samp(a[:, 0], a[:, 1])
        b0 = (diff * dx).sum((1, 2))
        b1 = (diff * dy).sum((1, 2))
        sx = ((g11 * b0 - g01 * b1) / det).to(torch.float32)
        sy = ((g00 * b1 - g01 * b0) / det).to(torch.float32)
        a2 = torch.stack([torch.clamp(a[:, 0] + sy, 0.0, hiX),
                          torch.clamp(a[:, 1] + sx, 0.0, hiX)], dim=1)
        a = torch.where(done[:, None], a, a2)
        done = done | (sx * sx + sy * sy < eps * eps)
    err = ((Jw - samp(a[:, 0], a[:, 1])).abs().sum((1, 2))
           / (win * win)).to(torch.float32)
    zero = torch.zeros_like(err)
    return (torch.where(z2, a, a0), torch.where(ok, min_eig.float(), zero),
            torch.where(ok, err, zero))


def track(prev_pyr, next_pyr, pts, valid, win=21, iters=30, eps=0.01,
          min_eig_threshold=1e-4, margin=7, dtype=torch.float32):
    """Track pts [B, K, 2] (x, y) of image b from ``prev_pyr`` to
    ``next_pyr`` (levels of [B, H, W]).  Returns (new_pts [B, K, 2],
    status [B, K], err [B, K]; err = inf where status is false)."""
    B, K = pts.shape[:2]
    levels = len(prev_pyr)
    dev = pts.device
    pts = pts.reshape(B * K, 2).to(torch.float32)
    valid = valid.reshape(B * K)
    tile = torch.arange(B, device=dev).repeat_interleave(K)
    r = win // 2
    pad = r + margin + 1
    Js = [_pad2d(l, (pad,) * 4, "replicate").to(dtype) for l in prev_pyr]
    Is = [_pad2d(l, (pad,) * 4, "replicate").to(dtype) for l in next_pyr]
    shapes = [tuple(l.shape[-2:]) for l in prev_pyr]
    inside = torch.ones(B * K, dtype=torch.bool, device=dev)
    for lvl in range(levels):
        H, W = shapes[lvl]
        p_l = pts / (2.0 ** lvl) + pad
        hi = torch.tensor([W - 1 + pad, H - 1 + pad], device=dev)
        inside = inside & torch.all((p_l >= pad) & (p_l <= hi), dim=-1)
    status = valid & inside
    pts_s = torch.where(status[:, None], pts, torch.zeros_like(pts))
    P = win + 2 * margin + 1
    hiX = float(P - 2 - win)
    g = torch.zeros_like(pts_s)
    err = None
    for lvl in range(levels - 1, -1, -1):
        Hp, Wp = Js[lvl].shape[-2:]
        imgJ = Js[lvl].reshape(B * Hp, Wp)
        imgI = Is[lvl].reshape(B * Hp, Wp)
        p_l = pts_s / (2.0 ** lvl) + pad
        pya, pxa = p_l[:, 1], p_l[:, 0]

        def corner(ya, xa, back, side):
            cy = torch.clamp(torch.floor(ya).to(torch.int32) - back,
                             0, Hp - side)
            cx = torch.clamp(torch.floor(xa).to(torch.int32) - back,
                             0, Wp - side)
            return cy, cx

        cyJ, cxJ = corner(pya, pxa, r + 1, win + 3)
        aJy = torch.clamp(pya - r - cyJ, min=1.0)
        aJx = torch.clamp(pxa - r - cxJ, min=1.0)
        q0 = p_l + g
        cyI, cxI = corner(q0[:, 1], q0[:, 0], r + margin, P)
        a0y = torch.clamp(q0[:, 1] - r - cyI, 0.0, hiX)
        a0x = torch.clamp(q0[:, 0] - r - cxI, 0.0, hiX)
        a_fin, eig, err_l = _level(
            imgJ, imgI, torch.stack([cyJ, cxJ], 1), torch.stack([cyI, cxI], 1),
            torch.stack([aJy, aJx], 1), torch.stack([a0y, a0x], 1), status,
            tile, Hp, win, iters, eps, hiX, dtype)
        status = status & (eig >= min_eig_threshold)
        q = torch.stack([(cxI + r).float() + a_fin[:, 1],
                         (cyI + r).float() + a_fin[:, 0]], dim=1)
        g_new = q - p_l
        g = g_new * 2.0 if lvl > 0 else g_new
        if lvl == 0:
            err = err_l
    new_pts = pts + g
    H0, W0 = shapes[0]
    hi0 = torch.tensor([W0 - 1, H0 - 1], dtype=torch.float32, device=dev)
    status = status & torch.all((new_pts >= 0) & (new_pts <= hi0), dim=-1)
    err = torch.where(status, err, torch.full_like(err, float("inf")))
    return (new_pts.reshape(B, K, 2), status.reshape(B, K),
            err.reshape(B, K))
