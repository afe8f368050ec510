"""Pyramidal Lucas-Kanade sparse optical flow.

Replaces ``cv2.calcOpticalFlowPyrLK`` with the defaults the front-end relies
on: 21x21 window, 3 pyramid levels, <= 30 Newton iterations with eps = 0.01,
min-eigenvalue rejection at 1e-4 (0..255 intensity scale), ``err`` = mean
absolute window intensity difference.

The port has the JAX package's TWO LK semantics (``ops/lk.py`` there), on the
CPU and on the card alike:

* the kernel level loops' (``_lk_tiled_levels`` / ``_lk_fused_levels``
  there), which ``impl="auto"`` always picks: per level, integer region
  corners and fractional anchors are formed here in tensor ops and the level
  itself runs in a hand-written CUDA kernel on the card (its plain version
  on the CPU): ``ops/lk_tile.lk_level`` for an atlas with agent-contiguous
  tracks (``impl="tiled"``), ``ops/lk_fused.lk_level`` for tracks in any
  order on an image of any size (``impl="fused"``).  The window start is
  capped at ``hiX = P - 2 - win`` on both axes.
* the patch formulation's (``impl="xla"``, and ``impl="pallas"``, which
  shares its template setup): each track's template and search patches are
  extracted per level (through ``ops/extract`` with ``dma_extract``, by
  plain indexing otherwise); ``"xla"`` samples windows by banded
  interpolation products (plain ``torch.matmul`` in exact float32, as the
  JAX package's einsums outside any kernel), batches the template windows
  and gradients over levels, and runs the Newton loop over all tracks at
  once with the 8-iteration head and the 256-track tail compaction at
  ``T >= 1024``; ``"pallas"`` hands each level's patches to the Newton-loop
  kernel ``ops/lk_iterate.lk_iterate``.  It differs from the first
  semantics, and is reproduced, not fixed: the XLA loop caps the tracked
  POINT one pixel looser than ``hiX``; its template gradients are
  zero-padded at the patch border (with ``dma_extract`` the template patch
  is 48 rows high, so the row gradients use real rows below it); its step
  solve clamps the determinant at 1e-30, the kernels' at 1e-20.

Pyramid building and ``bilinear_sample`` are plain PyTorch.
"""

import contextlib

import torch
import torch.nn.functional as F

from mqslam_tpu_torch.ops import extract, linalg, lk_fused, lk_iterate, lk_tile

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
             impl: str = "auto", store_dtype=None, dma_extract=None):
    """Track pts [N, 2] from prev_img to next_img ([H, W] each).

    Returns (new_pts [N, 2], status [N] bool, err [N] f32). ``err`` is the
    mean absolute intensity difference over the window (cv2 flags=0).
    ``impl`` / ``store_dtype`` / ``dma_extract``: see ``lk_track_pyr``."""
    return lk_track_pyr(build_pyramid(prev_img, levels),
                        build_pyramid(next_img, levels),
                        pts, pts_valid, win=win, iters=iters, eps=eps,
                        min_eig_threshold=min_eig_threshold, margin=margin,
                        impl=impl, store_dtype=store_dtype,
                        dma_extract=dma_extract)


_STORE_DTYPES = {None: torch.float32, "float32": torch.float32,
                 "bfloat16": torch.bfloat16}


def lk_track_pyr(prev_pyr, next_pyr, pts, pts_valid=None, win: int = 21,
                 iters: int = 30, eps: float = 0.01,
                 min_eig_threshold: float = 1e-4, margin: int = 7,
                 prepad: bool = False, atlas_agents=None,
                 atlas_tiles: int = 1, atlas_contiguous: bool = False,
                 impl: str = "auto", store_dtype=None, dma_extract=None):
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
    size, scattered agent ids).  ``"xla"`` and ``"pallas"`` are the patch
    formulation (module docstring), in any track order.

    ``store_dtype``: ``None`` / ``"float32"`` / ``"bfloat16"`` — the type the
    strip kernel reads the level images in (converted here, once per level).
    bfloat16 halves the bytes a track moves and is exact for 8-bit imagery at
    level 0; it is opt-in, float32 is the default on every device.

    ``dma_extract`` (``impl="xla"`` only): extract patches through the
    extraction kernel (``ops/extract``: 48-row patches from the 8-aligned row,
    every level edge-padded to 8 rows / 128 columns, at least 256, first).
    ``None`` means on for float32 tracks on a CUDA device, off on the CPU, as
    the JAX package's default is on the TPU and off on the CPU."""
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
    if impl not in ("auto", "tiled", "fused", "xla", "pallas"):
        raise ValueError(f"impl {impl!r}: expected 'auto', 'tiled', "
                         "'fused', 'xla' or 'pallas'")
    if dma_extract is None:
        dma_extract = impl == "xla" and dev.type == "cuda" \
            and dt == torch.float32
    if dma_extract and impl != "xla":
        raise ValueError("dma_extract applies to impl='xla' only (the "
                         "Newton-loop kernel of impl='pallas' expects "
                         "square patches)")

    if A > 1 and not prepad:
        raise ValueError("atlas mode requires prepadded pyramids")
    if A > 1 and atlas_agents is None and not atlas_contiguous:
        raise ValueError("atlas mode needs atlas_agents or "
                         "atlas_contiguous=True")
    if A > 1 and atlas_contiguous and T % A:
        raise ValueError(f"{T} agent-contiguous tracks do not divide into "
                         f"{A} tiles")
    contiguous = A == 1 or atlas_contiguous
    if not contiguous and impl in ("auto", "tiled") and T % A == 0:
        contiguous = torch.equal(
            atlas_agents.to(torch.int64),
            torch.arange(T, device=atlas_agents.device) // (T // A))
    if impl == "auto":
        impl = "tiled" if A > 1 and contiguous else "fused"
    if impl == "tiled" and not contiguous:
        raise ValueError("impl='tiled' needs agent-contiguous tracks; "
                         "scattered agent ids are impl='fused'")
    if impl != "fused" and store is not torch.float32:
        raise ValueError(f"impl={impl!r} reads float32 images only")

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

    if impl in ("xla", "pallas"):
        return _lk_patch_levels(Js, Is, pts, pts_s, status, shapes, tile, A,
                                win, iters, eps, min_eig_threshold, margin,
                                impl, dma_extract)

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

    return _finish(pts, g, status, err, shapes)


# ------------------------------------------------- the patch formulation --

def _extract_patches(img, corner_yx, P):
    """Per-track P x P patches at integer corners [T, 2] (y, x), clamped to
    ``[0, H-P] x [0, W-P]``; returns (patch [T, P, P], cy, cx).  One
    advanced-indexing gather (the JAX package's strips + one-hot product is
    the same exact copy)."""
    H, W = img.shape
    cy = torch.clamp(corner_yx[:, 0], 0, H - P)
    cx = torch.clamp(corner_yx[:, 1], 0, W - P)
    k = torch.arange(P, device=img.device)
    patch = img[(cy[:, None] + k)[:, :, None], (cx[:, None] + k)[:, None, :]]
    return patch, cy, cx


def _extract_at(img_l, anchor, off, m, side, win, dma_extract):
    """The patch at floor(anchor)-r-m of anchors [T, 2] (x, y) in tile
    coordinates, ``off`` [T] (or 0) the tile's first row.  Returns (patch,
    row_base, cx, row_log) in tile coordinates: ``row_base`` is the patch's
    first stored row (what window anchors are measured against),
    ``row_log`` the clamped logical corner (what drift clips are measured
    against); they differ only with ``dma_extract``."""
    r = win // 2
    corner = torch.stack([
        torch.floor(anchor[:, 1]).to(torch.int32) - r - m + off,
        torch.floor(anchor[:, 0]).to(torch.int32) - r - m], dim=1)
    if dma_extract:
        patch, y0, cx = extract.extract_patches_dma(
            img_l, corner.to(torch.int32).contiguous(), side)
        cy_log = torch.clamp(corner[:, 0], 0, img_l.shape[0] - side)
        return patch, y0 - off, cx, cy_log - off
    patch, cy, cx = _extract_patches(img_l, corner, side)
    return patch, cy - off, cx, cy - off


def _pad_tiles(img):
    """Edge-pad an image to 8 rows / 128 columns, at least 256 columns: the
    extent on which ``ops/extract``'s clamps equal the TPU kernel's."""
    H, W = img.shape
    Hp = -(-H // 8) * 8
    Wp = max(-(-W // 128) * 128, 256)
    if (Hp, Wp) != (H, W):
        img = _pad2d(img, (0, Wp - W, 0, Hp - H), "replicate")
    return img


def _interp_weights(pos, win, P):
    """Banded linear-interpolation rows: pos [T] (the window's fractional
    start in patch coordinates) -> [T, win, P], W[t, i, j] = tri(pos_t + i
    - j)."""
    i = torch.arange(win, dtype=pos.dtype, device=pos.device)[None, :, None]
    j = torch.arange(P, dtype=pos.dtype, device=pos.device)[None, None, :]
    u = pos[:, None, None] + i - j
    return torch.clamp(1.0 - torch.abs(u), min=0.0)


def _window(patch, ay, ax, win):
    """The win x win window at fractional offset (ay, ax) [T] of patches
    [T, Py, Px], by two banded products.  Patches may be rectangular (the
    extraction kernel's have rows below the window; their weights are 0)."""
    Wy = _interp_weights(ay, win, patch.shape[-2])
    Wx = _interp_weights(ax, win, patch.shape[-1])
    return torch.matmul(torch.matmul(Wy, patch), Wx.transpose(-1, -2))


def _window_multi(patches, ay, ax, win):
    """The same window of C patches per track: [T, C, Py, Px] ->
    [T, C, win, win]."""
    Wy = _interp_weights(ay, win, patches.shape[-2])[:, None]
    Wx = _interp_weights(ax, win, patches.shape[-1])[:, None]
    return torch.matmul(torch.matmul(Wy, patches), Wx.transpose(-1, -2))


@contextlib.contextmanager
def _exact_f32():
    """Float32 products in full float32 (no TF32) for the banded windows,
    whatever the caller set."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _all_done(done):
    """The loop's early exit: one host read per iteration.  Running all
    iterations instead gives the same numbers (a done track's step is
    zeroed and the clip is idempotent)."""
    return bool(done.all())


def _newton(q, done, pI, baseI, Jw, dx, dy, g00, g01, g11, lo, hi, n_iters,
            win, eps):
    """Up to ``n_iters`` Newton steps for all tracks at once; q [T, 2]
    (x, y) in tile coordinates, clipped to [lo, hi]; done tracks frozen."""
    r = win // 2
    for _ in range(n_iters):
        if _all_done(done):
            break
        a = q - r - baseI              # window start in patch coords (x, y)
        diff = Jw - _window(pI, a[:, 1], a[:, 0], win)
        b0 = torch.sum(diff * dx, dim=(1, 2))
        b1 = torch.sum(diff * dy, dim=(1, 2))
        s0, s1 = linalg.solve2x2_sym(g00, g01, g11, b0, b1)
        step = torch.stack([s0, s1], dim=-1)
        step = torch.where(done[:, None], torch.zeros_like(step), step)
        # keep the window inside the patch (residual motion beyond the
        # margin is recovered by the next level / frame)
        q = torch.clamp(q + step, lo, hi)
        done = done | (torch.sum(step * step, dim=-1) < eps * eps)
    return q, done


def _lk_patch_levels(Js, Is, pts, pts_s, status, shapes, tile, A, win,
                     iters, eps, min_eig_threshold, margin, impl,
                     dma_extract):
    """``impl="xla"`` / ``"pallas"``: the JAX package's ``lk_track_pyr``
    after its kernel branches, operation for operation.  ``pts_s`` are the
    tracks with dead slots zeroed (every corner is formed from them);
    coordinates stay local to the track's atlas tile (``tile`` [T] or None),
    whose first row is added to integer corners only."""
    levels = len(Js)
    T = pts.shape[0]
    dt = pts.dtype
    r = win // 2
    P = win + 2 * margin + 1
    # the template window never moves: a 1-px margin (interpolation tap +
    # central-difference border) instead of the Newton search margin
    margin_j = 1
    PJ = win + 2 * margin_j + 1
    pad = r + margin + 1
    offs = [0 if tile is None else tile * (j.shape[0] // A) for j in Js]
    if dma_extract:
        # only the bottom tile of an atlas gains rows: row offsets unchanged
        Js = [_pad_tiles(l) for l in Js]
        Is = [_pad_tiles(l) for l in Is]
        for l in Js:
            if not extract.dma_extract_supported(*l.shape):
                raise ValueError(f"dma_extract: a {tuple(l.shape)} level is "
                                 "below the extraction kernel's minimum")
        Js = [l.to(torch.float32).contiguous() for l in Js]
        Is = [l.to(torch.float32).contiguous() for l in Is]

    # ---- template setup, batched over levels (flow-independent) ----
    p_ls, pJs, ayJs, axJs = [], [], [], []
    for lvl in range(levels):
        p_l = pts_s / (2.0 ** lvl) + pad
        pJ, cyJ, cxJ, _ = _extract_at(Js[lvl], p_l, offs[lvl], margin_j,
                                      PJ, win, dma_extract)
        ayJs.append(p_l[:, 1] - r - cyJ.to(dt))
        axJs.append(p_l[:, 0] - r - cxJ.to(dt))
        p_ls.append(p_l)
        pJs.append(pJ)

    if impl == "pallas":
        return _lk_pallas_levels(Is, p_ls, pJs, ayJs, axJs, pts, status,
                                 shapes, win, iters, eps, min_eig_threshold,
                                 margin, offs)

    with _exact_f32():
        pJ_flat = torch.stack(pJs).reshape((levels * T,)
                                           + pJs[0].shape[-2:])
        dxP = F.pad(0.5 * (pJ_flat[:, :, 2:] - pJ_flat[:, :, :-2]),
                    (1, 1, 0, 0))
        dyP = F.pad(0.5 * (pJ_flat[:, 2:, :] - pJ_flat[:, :-2, :]),
                    (0, 0, 1, 1))
        # template + gradient windows for ALL levels in one product pair
        wins3 = _window_multi(torch.stack([pJ_flat, dxP, dyP], dim=1),
                              torch.cat(ayJs), torch.cat(axJs), win)
        wins3 = wins3.reshape(levels, T, 3, win, win)
        Jw_l, dx_l, dy_l = wins3[:, :, 0], wins3[:, :, 1], wins3[:, :, 2]
        g00_l = torch.sum(dx_l * dx_l, dim=(2, 3))            # [L, T]
        g01_l = torch.sum(dx_l * dy_l, dim=(2, 3))
        g11_l = torch.sum(dy_l * dy_l, dim=(2, 3))
        tr = 0.5 * (g00_l + g11_l)
        min_eig = (tr - torch.sqrt(torch.clamp(
            0.25 * (g00_l - g11_l) ** 2 + g01_l * g01_l, min=0.0))) \
            / (win * win)
        status = status & torch.all(min_eig >= min_eig_threshold, dim=0)

        # ---- coarse-to-fine Newton loops ----
        # Tail compaction: a short head for everyone, then the unconverged
        # tracks (at most tail_cap, lowest indices first as lax.top_k
        # breaks ties; extras keep their head-phase flow) finish compactly
        head_iters = min(iters, 8)
        tail_cap = 256
        g = torch.zeros_like(pts_s)
        for lvl in range(levels - 1, -1, -1):
            p_l = p_ls[lvl]
            Jw, dx, dy = Jw_l[lvl], dx_l[lvl], dy_l[lvl]
            g00, g01, g11 = g00_l[lvl], g01_l[lvl], g11_l[lvl]
            q0 = p_l + g
            pI, rowI, cxI, rowIlog = _extract_at(Is[lvl], q0, offs[lvl],
                                                 margin, P, win, dma_extract)
            # sampling base: where the stored rows start; logical base: the
            # clamped corner the drift clips are measured against
            baseI = torch.stack([cxI.to(dt), rowI.to(dt)], dim=1)
            baseLog = torch.stack([cxI.to(dt), rowIlog.to(dt)], dim=1)
            lo = baseLog + r
            hi = baseLog + P - 2 - r
            q_init0 = torch.clamp(q0, lo, hi)
            args = (pI, baseI, Jw, dx, dy, g00, g01, g11, lo, hi)
            if T < 4 * tail_cap or iters <= head_iters:
                q, _ = _newton(q_init0, ~status, *args, iters, win, eps)
            else:
                q, done = _newton(q_init0, ~status, *args, head_iters, win,
                                  eps)
                sel = torch.argsort(done.to(torch.int8), stable=True)
                sel = sel[:tail_cap]
                live = ~done[sel]
                qc, _ = _newton(q[sel], ~live, *(x[sel] for x in args),
                                iters - head_iters, win, eps)
                q = q.index_put((sel,), torch.where(live[:, None], qc,
                                                    q[sel]))
            g_new = q - p_l           # the pad cancels (both padded coords)
            g = g_new * 2.0 if lvl > 0 else g_new

        # the error at level 0: the level-0 template window and the
        # already-extracted search patch (the clip keeps q inside it)
        a_fin = q - r - baseI
        err = torch.mean(torch.abs(
            Jw - _window(pI, a_fin[:, 1], a_fin[:, 0], win)), dim=(1, 2))
    return _finish(pts, g, status, err, shapes)


def _finish(pts, g, status, err, shapes):
    """(new_pts, status, err): the final point inside level 0, err = inf
    where status is false."""
    new_pts = pts + g
    H0, W0 = shapes[0]
    hi0 = torch.tensor([W0 - 1, H0 - 1], dtype=pts.dtype, device=pts.device)
    inside_final = torch.all((new_pts >= 0) & (new_pts <= hi0), dim=-1)
    status = status & inside_final
    return new_pts, status, torch.where(
        status, err, torch.full_like(err, float("inf")))


def _lk_pallas_levels(Is, p_ls, pJs, ayJs, axJs, pts, status, shapes, win,
                      iters, eps, min_eig_threshold, margin, offs):
    """Per-level driver of the Newton-loop kernel (``ops/lk_iterate``): the
    search patch of each level is extracted square at the level-start
    estimate, the kernel clips the anchor to ``[0, P - 2 - win]``; ``offs``
    move each track's patch row into its atlas tile."""
    r = win // 2
    P = win + 2 * margin + 1
    dt = pts.dtype
    f32 = torch.float32
    g = torch.zeros_like(p_ls[0])
    err = None
    for lvl in range(len(Is) - 1, -1, -1):
        p_l = p_ls[lvl]
        q0 = p_l + g
        pI, cyI, cxI, _ = _extract_at(Is[lvl], q0, offs[lvl], margin, P,
                                      win, False)
        baseI = torch.stack([cxI.to(dt), cyI.to(dt)], dim=1)
        q_init0 = torch.clamp(q0, baseI + r, baseI + P - 2 - r)
        aJ2 = torch.stack([ayJs[lvl], axJs[lvl]], dim=1)
        a0 = torch.stack([q_init0[:, 1] - r - baseI[:, 1],
                          q_init0[:, 0] - r - baseI[:, 0]], dim=1)
        a_fin, eig, err_win = lk_iterate.lk_iterate(
            pJs[lvl].to(f32).contiguous(), pI.to(f32).contiguous(),
            aJ2.to(f32).contiguous(), a0.to(f32).contiguous(), win, iters,
            eps)
        status = status & (eig >= min_eig_threshold)
        q = torch.stack([baseI[:, 0] + r + a_fin[:, 1].to(dt),
                         baseI[:, 1] + r + a_fin[:, 0].to(dt)], dim=1)
        g_new = q - p_l
        g = g_new * 2.0 if lvl > 0 else g_new
        if lvl == 0:
            err = err_win
    return _finish(pts, g, status, err, shapes)
