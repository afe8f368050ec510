"""One pyramid level of Lucas-Kanade for agent-contiguous tracks: the CUDA
kernel's wrapper and its plain PyTorch version.

Contract (both versions):

  imgJ, imgI   [A*Hp, Wp] f32 contiguous — the previous / next pre-padded
               atlas level, agent tiles stacked vertically, plain row-major
  cJ, cI       [T, 2] int32 (row, col) — integer corner of the template /
               search region, LOCAL to the track's agent tile
  aJ, a0       [T, 2] f32 (ay, ax) — template anchor (in [1, 2) for an
               in-image track) / initial search anchor (in [0, hiX])
               relative to those corners
  valid        [T] bool or int — tracks with valid == 0 are skipped
  scalars      A (tiles), win, iters, eps, hiX, want_err

  returns      a_final [T, 2] (ay, ax), min_eig [T], err [T]  (all f32)

Track t belongs to tile ``t // (T / A)``.  Per track: the template window
``Jw [win, win]`` and its central-difference gradients are bilinear samples
of imgJ at ``cJ + aJ``; ``G = [[sum dx dx, sum dx dy], [., sum dy dy]]``,
``min_eig = lambda_min(G) / win^2``; then up to ``iters`` Newton steps
``a += G^-1 b`` with ``b = sum (Jw - Iw(a)) * (dx, dy)``, the anchor clipped
to ``[0, hiX]``, frozen once ``|step|^2 < eps^2``.  ``err`` is
``mean |Jw - Iw(a_final)|`` when ``want_err`` else 0.  A skipped track
returns its ``a0`` with ``min_eig = err = 0``; its anchors and corners are
never used to form an address, so they may hold NaN.

On a CUDA tensor ``lk_level`` launches the kernel (``csrc/lk_level.cu``) or
raises; the plain version serves CPU tensors, and the comparison on the
card.  ``launches`` counts kernel launches and nothing else.

The launch shape is chosen here, in plain Python the CPU tests reach, and
the kernel takes what it is given: ``instantiation`` says whether ``(win,
P)`` is the window compiled into the kernel (``SPECIALISED``) or runs the
generic one-warp-a-track code, and ``lanes_per_track`` gives the threads a
track (one of ``LANE_SHAPES``) from the track count and the card's SM count.
Both level kernels (this one and ``lk_fused``'s) follow the same rule.
"""

import ctypes

import torch

__all__ = ["lk_level", "lk_level_plain", "launches", "search_side",
           "check_level_args", "launch_buffers", "SPECIALISED",
           "LANE_SHAPES", "instantiation", "lanes_per_track",
           "launch_lanes", "check_lanes", "sm_count", "kernel_info"]

launches = 0

_lib = None

SPECIALISED = (21, 36)     # (win, P) compiled into the level kernels
LANE_SHAPES = (32, 128)    # threads a track: one warp, or four
_TRACKS_PER_SM_FOR_128 = 4
_n_sm = {}


def search_side(win: int, hiX: float) -> int:
    """Side P of the square search region: hiX = P - 2 - win."""
    return int(round(hiX)) + 2 + win


def instantiation(win: int, P: int) -> str:
    """Which code a level launch runs for this window: ``"specialised"`` for
    ``SPECIALISED`` (compile-time window, 32 or 128 threads a track,
    persistent grid), ``"generic"`` for any other (one warp a track, runtime
    window).  The kernel makes the same choice at launch."""
    return "specialised" if (win, P) == SPECIALISED else "generic"


def lanes_per_track(T: int, n_sm: int) -> int:
    """Threads a track for the specialised window: 128 while the tracks
    would leave most of the card empty as one warp each (at most
    ``_TRACKS_PER_SM_FOR_128`` a SM: the four-warp groups then still fit in
    one wave and a track's chain is about a quarter as long), else 32 (one
    warp a track, a persistent grid that fills every SM).  Monotone: once 32,
    32 for every larger T."""
    if n_sm < 1:
        raise ValueError(f"n_sm must be >= 1, got {n_sm}")
    return 128 if T <= _TRACKS_PER_SM_FOR_128 * n_sm else 32


def launch_lanes(T: int, n_sm: int, win: int, P: int, force=None) -> int:
    """The threads a track a launch uses: ``force`` if given (checked),
    else ``lanes_per_track`` for the specialised window and 32 for the
    generic one."""
    check_lanes(force, win, P)
    if force is not None:
        return int(force)
    return lanes_per_track(T, n_sm) if instantiation(win, P) == \
        "specialised" else 32


def check_lanes(force, win: int, P: int):
    """Raise on a forced lane shape no launch takes: not one of
    ``LANE_SHAPES``, or more than one warp for the generic window."""
    if force is None:
        return
    if isinstance(force, bool) or force not in LANE_SHAPES:
        raise ValueError(f"_lanes must be one of {LANE_SHAPES}, got "
                         f"{force!r}")
    if force != 32 and instantiation(win, P) == "generic":
        raise ValueError(f"_lanes={force}: the generic window (win={win}, "
                         f"P={P}) runs one warp a track")


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (cached)."""
    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    if idx not in _n_sm:
        _n_sm[idx] = torch.cuda.get_device_properties(idx) \
            .multi_processor_count
    return _n_sm[idx]


def check_level_args(imgJ, imgI, cJ, cI, aJ, a0, valid, A,
                     img_dtype=torch.float32):
    """Raise on what a level (this one or ``lk_fused``'s) does not take."""
    T = cJ.shape[0]
    if imgJ.dim() != 2 or imgI.shape != imgJ.shape:
        raise ValueError("imgJ/imgI must be [A*Hp, Wp] of one shape")
    if imgJ.dtype != img_dtype or imgI.dtype != img_dtype:
        raise TypeError(f"imgJ/imgI must be {img_dtype}")
    if imgJ.shape[0] % A or T % A:
        raise ValueError(f"rows {imgJ.shape[0]} and tracks {T} must divide "
                         f"into A={A} tiles")
    for name, x, dt in (("cJ", cJ, torch.int32), ("cI", cI, torch.int32),
                        ("aJ", aJ, torch.float32), ("a0", a0, torch.float32)):
        if x.shape != (T, 2) or x.dtype != dt:
            raise TypeError(f"{name} must be [T, 2] {dt}")
    if valid.shape != (T,):
        raise ValueError("valid must be [T]")
    for x in (imgI, cJ, cI, aJ, a0, valid):
        if x.device != imgJ.device:
            raise ValueError("all tensors must lie on one device")


def lk_level_plain(imgJ, imgI, cJ, cI, aJ, a0, valid, A: int, win: int,
                   iters: int, eps: float, hiX: float, want_err: bool = True,
                   return_iters: bool = False):
    """The level in plain tensor ops (see the module docstring).

    ``return_iters`` also returns the number of Newton steps each track took
    (what a work count for this input needs)."""
    check_level_args(imgJ, imgI, cJ, cI, aJ, a0, valid, A)
    T = cJ.shape[0]
    dev = imgJ.device
    Hp, Wp = imgJ.shape[0] // A, imgJ.shape[1]
    P = search_side(win, hiX)
    W2 = win + 2
    ok = valid != 0
    # skipped tracks: zero everything an address is formed from
    z2 = ok[:, None]
    cJ = torch.where(z2, cJ, torch.zeros_like(cJ)).long()
    cI = torch.where(z2, cI, torch.zeros_like(cI)).long()
    aJs = torch.where(z2, aJ, torch.ones_like(aJ))
    a = torch.where(z2, a0, torch.zeros_like(a0))
    off = (torch.arange(T, device=dev) // (T // A)) * Hp       # tile row 0

    def region(img, row0, col0, n):
        """[T, n, n] gather at local (row0, col0), clamped to the tile."""
        k = torch.arange(n, device=dev)
        rows = (row0[:, None] + k).clamp(0, Hp - 1) + off[:, None]
        cols = (col0[:, None] + k).clamp(0, Wp - 1)
        return img[rows[:, :, None], cols[:, None, :]]

    # ---- template: window + gradients from one lerped (win+2)^2 grid ----
    iyJ = torch.floor(aJs[:, 0])
    ixJ = torch.floor(aJs[:, 1])
    fyJ = (aJs[:, 0] - iyJ)[:, None, None]
    fxJ = (aJs[:, 1] - ixJ)[:, None, None]
    R = region(imgJ, cJ[:, 0] + iyJ.long() - 1, cJ[:, 1] + ixJ.long() - 1,
               W2 + 1)
    slab = (1.0 - fyJ) * R[:, :W2, :] + fyJ * R[:, 1:, :]
    C = (1.0 - fxJ) * slab[:, :, :W2] + fxJ * slab[:, :, 1:]   # [T, W2, W2]
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

    # ---- search region + Newton loop ----
    pI = region(imgI, cI[:, 0], cI[:, 1], P)                    # [T, P, P]
    kw = torch.arange(win, device=dev)
    hi_i = int(hiX)

    def samp(ay, ax):
        # (a NaN anchor keeps its NaN weights but must not form an index)
        iy = torch.nan_to_num(torch.floor(ay)).clamp(0, hi_i)
        ix = torch.nan_to_num(torch.floor(ax)).clamp(0, hi_i)
        fy = (ay - iy)[:, None, None]
        fx = (ax - ix)[:, None, None]
        ri = (iy.long()[:, None] + kw)[:, :, None].expand(T, win, P)
        rows = ((1.0 - fy) * torch.gather(pI, 1, ri)
                + fy * torch.gather(pI, 1, ri + 1))             # [T, win, P]
        ci = (ix.long()[:, None] + kw)[:, None, :].expand(T, win, win)
        return ((1.0 - fx) * torch.gather(rows, 2, ci)
                + fx * torch.gather(rows, 2, ci + 1))

    done = ~ok
    n_it = torch.zeros(T, dtype=torch.int32, device=dev)
    for _ in range(iters):
        if bool(done.all()):
            break
        n_it += (~done).to(torch.int32)
        diff = Jw - samp(a[:, 0], a[:, 1])
        b0 = (diff * dx).sum((1, 2))
        b1 = (diff * dy).sum((1, 2))
        sx = (g11 * b0 - g01 * b1) / det
        sy = (g00 * b1 - g01 * b0) / det
        a2 = torch.stack([torch.clamp(a[:, 0] + sy, 0.0, hiX),
                          torch.clamp(a[:, 1] + sx, 0.0, hiX)], dim=1)
        a = torch.where(done[:, None], a, a2)
        done = done | (sx * sx + sy * sy < eps * eps)

    if want_err:
        err = (Jw - samp(a[:, 0], a[:, 1])).abs().sum((1, 2)) / (win * win)
    else:
        err = torch.zeros(T, dtype=torch.float32, device=dev)
    zero = torch.zeros_like(min_eig)
    out = (torch.where(z2, a, a0), torch.where(ok, min_eig, zero),
           torch.where(ok, err, zero))
    return out + (n_it,) if return_iters else out


def launch_buffers(imgJ, imgI, cJ, cI, aJ, a0, valid):
    """What a launch needs beside its checked inputs: ``valid`` as one byte
    per track, every input contiguous (raises otherwise), and the three
    output tensors.  Returns (valid, a_out, min_eig, err)."""
    if valid.dtype != torch.bool:
        valid = valid != 0
    for name, x in (("imgJ", imgJ), ("imgI", imgI), ("cJ", cJ), ("cI", cI),
                    ("aJ", aJ), ("a0", a0), ("valid", valid)):
        if not x.is_contiguous():
            raise ValueError(f"lk_level: {name} must be contiguous")
    T = cJ.shape[0]
    f32 = dict(dtype=torch.float32, device=imgJ.device)
    return (valid, torch.empty((T, 2), **f32), torch.empty(T, **f32),
            torch.empty(T, **f32))


def _library():
    global _lib
    if _lib is None:
        from mqslam_tpu_torch import csrc
        lib = csrc.load("lk_level")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.lk_level_launch.argtypes = [p, p, p, p, p, p, p, p, p, p,
                                        i, i, i, i, i, i, i, f, f, i, i, p, p]
        lib.lk_level_launch.restype = ctypes.c_int
        lib.lk_level_info.argtypes = [i, i, i, p]
        lib.lk_level_info.restype = ctypes.c_int
        _lib = lib
    return _lib


def info_dict(rc, out, win, P, lanes, what):
    """The record of an ``lk_*_info`` call (raises on a CUDA error)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
    return dict(win=win, P=P, lanes=lanes,
                instantiation="specialised" if out[3] else "generic",
                registers=out[0], shared_bytes_per_track=out[1],
                resident_warps_per_sm=out[2])


def kernel_info(win: int = 21, P: int = 36, lanes: int = 32) -> dict:
    """Registers a thread, shared bytes a track and resident warps a SM
    (CUDA occupancy API) of the kernel a launch with this window and lane
    shape runs, on the current CUDA device."""
    check_lanes(lanes, win, P)
    out = (ctypes.c_int * 4)()
    rc = _library().lk_level_info(win, P, lanes, ctypes.addressof(out))
    return info_dict(rc, out, win, P, lanes, "lk_level_info")


def lk_level(imgJ, imgI, cJ, cI, aJ, a0, valid, A: int, win: int,
             iters: int, eps: float, hiX: float, want_err: bool = True,
             _lanes=None):
    """The level for tensors on one device: the CUDA kernel for CUDA tensors
    (launched on the current stream, no sync; raises if it cannot build or
    launch), the plain version for CPU tensors.

    ``_lanes`` forces the threads a track (one of ``LANE_SHAPES``; 32 only
    for the generic window) instead of ``lanes_per_track``'s choice, so that
    every instantiation can be held against the plain version on the card;
    it changes no result and is not an option of any caller."""
    global launches
    check_lanes(_lanes, win, search_side(win, hiX))
    if imgJ.device.type == "cpu":
        return lk_level_plain(imgJ, imgI, cJ, cI, aJ, a0, valid, A, win,
                              iters, eps, hiX, want_err)
    if imgJ.device.type != "cuda":
        raise RuntimeError(f"lk_level: unsupported device {imgJ.device}")
    check_level_args(imgJ, imgI, cJ, cI, aJ, a0, valid, A)
    valid, a_out, eig, err = launch_buffers(imgJ, imgI, cJ, cI, aJ, a0,
                                            valid)
    T = cJ.shape[0]
    Hp, Wp = imgJ.shape[0] // A, imgJ.shape[1]
    P = search_side(win, hiX)
    lanes = launch_lanes(T, sm_count(imgJ.device), win, P, _lanes)
    nxt = torch.empty(1, dtype=torch.int32, device=imgJ.device)
    lib = _library()
    with torch.cuda.device(imgJ.device):
        rc = lib.lk_level_launch(
            imgJ.data_ptr(), imgI.data_ptr(), cJ.data_ptr(), cI.data_ptr(),
            aJ.data_ptr(), a0.data_ptr(), valid.data_ptr(),
            a_out.data_ptr(), eig.data_ptr(), err.data_ptr(),
            T, A, Hp, Wp, win, P, iters, eps, hiX, int(bool(want_err)),
            lanes, nxt.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lk_level kernel launch failed: CUDA error {rc}")
    launches += 1
    return a_out, eig, err
