"""Pyramidal Lucas-Kanade sparse optical flow.

Replaces ``cv2.calcOpticalFlowPyrLK`` with the defaults the front-end relies
on: 21x21 window, 3 pyramid levels, <= 30 Newton iterations with eps = 0.01,
min-eigenvalue rejection at 1e-4 (0..255 intensity scale), ``err`` = mean
absolute window intensity difference.

The port has ONE LK semantics, that of the JAX package's kernel level loops
(``ops/lk.py::_lk_tiled_levels`` / ``_lk_fused_levels`` there): per level,
integer region corners and fractional anchors are formed here in tensor ops,
and the level itself runs in a hand-written CUDA kernel on the card (its
plain version on the CPU): ``ops/lk_tile.lk_level`` for an atlas with
agent-contiguous tracks (``impl="tiled"``), ``ops/lk_fused.lk_level`` for
tracks in any order on an image of any size (``impl="fused"``).  The window
start is capped at ``hiX = P - 2 - win`` on both axes.  Pyramid building and
``bilinear_sample`` are plain PyTorch.
"""

import torch
import torch.nn.functional as F

from mqslam_tpu_torch.ops import lk_fused, lk_tile

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
             min_eig_threshold: float = 1e-4, margin: int = 7,
             impl: str = "auto", store_dtype=None):
    """Track pts [N, 2] from prev_img to next_img ([H, W] each).

    Returns (new_pts [N, 2], status [N] bool, err [N] f32). ``err`` is the
    mean absolute intensity difference over the window (cv2 flags=0).
    ``impl`` / ``store_dtype``: see ``lk_track_pyr``."""
    return lk_track_pyr(build_pyramid(prev_img, levels),
                        build_pyramid(next_img, levels),
                        pts, pts_valid, win=win, iters=iters, eps=eps,
                        min_eig_threshold=min_eig_threshold, margin=margin,
                        impl=impl, store_dtype=store_dtype)


_STORE_DTYPES = {None: torch.float32, "float32": torch.float32,
                 "bfloat16": torch.bfloat16}


def lk_track_pyr(prev_pyr, next_pyr, pts, pts_valid=None, win: int = 21,
                 iters: int = 30, eps: float = 0.01,
                 min_eig_threshold: float = 1e-4, margin: int = 7,
                 prepad: bool = False, atlas_agents=None,
                 atlas_tiles: int = 1, atlas_contiguous: bool = False,
                 impl: str = "auto", store_dtype=None):
    """lk_track over prebuilt pyramids (sequences of [H, W] images, level 0 =
    full resolution), so sequential trackers build one pyramid per frame.

    ``prepad=True`` declares that every level is already edge-padded by
    ``lk_pad(win, margin)`` (see build_pyramid(pad=...)); coordinates are
    still unpadded-image coordinates.

    Atlas mode (multi-agent): per-level images vertically stacked from
    ``atlas_tiles`` equally-sized pre-padded tiles (one agent each); tracks
    keep their own tile coordinates.  ``atlas_agents`` [T] gives each track's
    tile, in any order; ``atlas_contiguous=True`` declares instead that track
    t belongs to tile ``t // (T / atlas_tiles)`` (no check, no host sync).

    ``impl``: ``"tiled"`` is the tile kernel (``ops/lk_tile``; needs
    agent-contiguous tracks and float32 images), ``"fused"`` the per-track
    strip kernel (``ops/lk_fused``; any track order).  ``"auto"`` has no size
    gate, since neither kernel's shared memory depends on the image size: the
    tile kernel for an atlas of more than one tile with agent-contiguous
    tracks, the strip kernel for everything else (a single image of any
    size, scattered agent ids).

    ``store_dtype``: ``None`` / ``"float32"`` / ``"bfloat16"`` — the type the
    strip kernel reads the level images in (converted here, once per level).
    bfloat16 halves the bytes a track moves and is exact for 8-bit imagery at
    level 0; it is opt-in, float32 is the default on every device."""
    levels = len(prev_pyr)
    T = pts.shape[0]
    dt = pts.dtype
    dev = pts.device
    if pts_valid is None:
        pts_valid = torch.ones(T, dtype=torch.bool, device=dev)
    r = win // 2
    pad = r + margin + 1  # corners never clamp for in-image points
    A = int(atlas_tiles)
    if store_dtype not in _STORE_DTYPES:
        raise ValueError(f"store_dtype {store_dtype!r}: expected None, "
                         "'float32' or 'bfloat16'")
    store = _STORE_DTYPES[store_dtype]
    if impl not in ("auto", "tiled", "fused"):
        raise ValueError(f"impl {impl!r}: expected 'auto', 'tiled' or "
                         "'fused'")

    if A > 1 and not prepad:
        raise ValueError("atlas mode requires prepadded pyramids")
    if A > 1 and atlas_agents is None and not atlas_contiguous:
        raise ValueError("atlas mode needs atlas_agents or "
                         "atlas_contiguous=True")
    if A > 1 and atlas_contiguous and T % A:
        raise ValueError(f"{T} agent-contiguous tracks do not divide into "
                         f"{A} tiles")
    contiguous = A == 1 or atlas_contiguous
    if not contiguous and impl != "fused" and T % A == 0:
        contiguous = torch.equal(
            atlas_agents.to(torch.int64),
            torch.arange(T, device=atlas_agents.device) // (T // A))
    if impl == "auto":
        impl = "tiled" if A > 1 and contiguous else "fused"
    if impl == "tiled" and not contiguous:
        raise ValueError("impl='tiled' needs agent-contiguous tracks; "
                         "scattered agent ids are impl='fused'")
    if impl == "tiled" and store is not torch.float32:
        raise ValueError("impl='tiled' reads float32 images only")

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

    # The strip kernel addresses the whole stacked image: a track's corners
    # are clamped against ALL rows and handed over absolute, but kept local
    # to the tile here (integer subtraction of the tile's first row), so the
    # anchors are formed from tile coordinates in both level loops.
    if impl == "tiled" or A == 1:
        tile = None
    elif atlas_contiguous:
        tile = (torch.arange(T, device=dev) // (T // A)).to(torch.int32)
    else:
        tile = torch.where(status, atlas_agents.to(dev).to(torch.int32), 0)

    P = win + 2 * margin + 1
    hiX = float(P - 2 - win)
    f32 = torch.float32
    g = torch.zeros_like(pts_s)
    err = None
    for lvl in range(levels - 1, -1, -1):
        want_err = lvl == 0
        Hp, Wp = Js[lvl].shape[0] // A, Js[lvl].shape[1]
        off = 0 if tile is None else tile * Hp      # the tile's first row
        rows = Hp if impl == "tiled" else A * Hp    # rows a corner may use
        p_l = pts_s / (2.0 ** lvl) + pad
        pya, pxa = p_l[:, 1], p_l[:, 0]

        def corner(ya, xa, back, side):
            cy = torch.clamp(torch.floor(ya).to(torch.int32) - back + off,
                             0, rows - side) - off
            cx = torch.clamp(torch.floor(xa).to(torch.int32) - back,
                             0, Wp - side)
            return cy, cx

        cyJ, cxJ = corner(pya, pxa, r + 1, win + 3)
        aJy = torch.clamp(pya.to(f32) - r - cyJ, min=1.0)
        aJx = torch.clamp(pxa.to(f32) - r - cxJ, min=1.0)
        q0 = p_l + g
        q0ya, q0xa = q0[:, 1], q0[:, 0]
        cyI, cxI = corner(q0ya, q0xa, r + margin, P)
        a0y = torch.clamp(q0ya.to(f32) - r - cyI, 0.0, hiX)
        a0x = torch.clamp(q0xa.to(f32) - r - cxI, 0.0, hiX)
        aJ = torch.stack([aJy, aJx], dim=1)
        a0 = torch.stack([a0y, a0x], dim=1)
        if impl == "tiled":
            a_fin, eig, err_l = lk_tile.lk_level(
                Js[lvl].to(f32).contiguous(), Is[lvl].to(f32).contiguous(),
                torch.stack([cyJ, cxJ], dim=1),
                torch.stack([cyI, cxI], dim=1), aJ, a0, status, A, win,
                iters, eps, hiX, want_err=want_err)
        else:
            a_fin, eig, err_l = lk_fused.lk_level(
                Js[lvl].to(store).contiguous(),
                Is[lvl].to(store).contiguous(),
                torch.stack([cyJ + off, cxJ], dim=1),
                torch.stack([cyI + off, cxI], dim=1), aJ, a0, status, win,
                iters, eps, hiX, want_err=want_err)
        status = status & (eig >= min_eig_threshold)
        q = torch.stack([(cxI + r).to(dt) + a_fin[:, 1].to(dt),
                         (cyI + r).to(dt) + a_fin[:, 0].to(dt)], dim=1)
        g_new = q - p_l
        g = g_new * 2.0 if lvl > 0 else g_new
        if want_err:
            err = err_l

    new_pts = pts + g
    H0, W0 = shapes[0]
    hi0 = torch.tensor([W0 - 1, H0 - 1], dtype=dt, device=dev)
    inside_final = torch.all((new_pts >= 0) & (new_pts <= hi0), dim=-1)
    status = status & inside_final
    return new_pts, status, torch.where(
        status, err, torch.full_like(err, float("inf")))
