"""One pyramid level of Lucas-Kanade for tracks in any order, each reading
its own regions from the whole level image: the CUDA kernel's wrapper and its
plain PyTorch version.  Counterpart of the JAX package's strip kernel
(``ops/lk_fused_pallas.py::lk_level_fused``).

Contract (both versions):

  imgJ, imgI   [R, Wp] float32 or bfloat16, contiguous — the previous / next
               pre-padded level, plain row-major; R is all rows of the level
               (atlas tiles stacked, or one image)
  cJ, cI       [T, 2] int32 ABSOLUTE (row, col) — integer corner of the
               template / search region in that image (an atlas track's tile
               row offset already added)
  aJ, a0       [T, 2] f32 (ay, ax) — template anchor (in [1, 2) for an
               in-image track) / initial search anchor (in [0, hiX])
               relative to those corners
  valid        [T] bool or int — tracks with valid == 0 are skipped
  scalars      win, iters, eps, hiX, want_err

  returns      a_final [T, 2] (ay, ax), min_eig [T], err [T]  (all f32)

The per-track function is the one of ``ops/lk_tile`` (template window and
gradients from one lerped grid, 2x2 structure tensor, Newton steps clipped to
``[0, hiX]`` and frozen at ``|step| < eps``, ``err`` = mean absolute window
difference); what differs is the addressing: any track order, absolute
corners, every read clamped to the WHOLE image ``[0, R-1] x [0, Wp-1]``.
bfloat16 images are widened to float32 before any arithmetic, by the kernel
as it loads and by the plain version up front, so both see the same values.
A skipped track returns its ``a0`` with ``min_eig = err = 0``; its anchors
and corners are never used to form an address, so they may hold NaN.

None of the TPU kernel's transport crosses over: no column-shifted stacked
copies, no 16-row / 128-lane aligned strip origins with residuals, no clip
base, no padding of T to groups of 8.

On a CUDA tensor ``lk_level`` launches the kernel (``csrc/lk_strip.cu``) or
raises; the plain version serves CPU tensors, and the comparison on the
card.  ``launches`` counts kernel launches and nothing else.  The launch
shape (compiled-in or generic window, threads a track) follows
``ops/lk_tile``'s rule: ``instantiation``, ``lanes_per_track``.
"""

import ctypes

import torch

from mqslam_tpu_torch.ops import lk_tile

__all__ = ["lk_level", "lk_level_plain", "launches", "kernel_info"]

launches = 0

_lib = None

_IMG_DTYPES = (torch.float32, torch.bfloat16)


def _check(imgJ, imgI):
    if imgJ.dtype not in _IMG_DTYPES or imgI.dtype != imgJ.dtype:
        raise TypeError("imgJ/imgI must both be float32 or both bfloat16")


def lk_level_plain(imgJ, imgI, cJ, cI, aJ, a0, valid, win: int, iters: int,
                   eps: float, hiX: float, want_err: bool = True,
                   return_iters: bool = False):
    """The level in plain tensor ops: with one tile spanning all R rows the
    tiled level's plain version has exactly this addressing (corners are
    absolute, reads clamp to the whole image, track order is free)."""
    _check(imgJ, imgI)
    f32 = torch.float32
    return lk_tile.lk_level_plain(imgJ.to(f32), imgI.to(f32), cJ, cI, aJ, a0,
                                  valid, 1, win, iters, eps, hiX, want_err,
                                  return_iters)


def _library():
    global _lib
    if _lib is None:
        from mqslam_tpu_torch import csrc
        lib = csrc.load("lk_strip")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.lk_strip_launch.argtypes = [p, p, p, p, p, p, p, p, p, p,
                                        i, i, i, i, i, i, f, f, i, i, i, p, p]
        lib.lk_strip_launch.restype = ctypes.c_int
        lib.lk_strip_info.argtypes = [i, i, i, i, p]
        lib.lk_strip_info.restype = ctypes.c_int
        _lib = lib
    return _lib


def kernel_info(win: int = 21, P: int = 36, lanes: int = 32,
                dtype=torch.float32) -> dict:
    """Registers a thread, shared bytes a track and resident warps a SM
    (CUDA occupancy API) of the kernel a launch with this window, lane shape
    and image type runs, on the current CUDA device."""
    lk_tile.check_lanes(lanes, win, P)
    out = (ctypes.c_int * 4)()
    rc = _library().lk_strip_info(win, P, lanes,
                                  int(dtype == torch.bfloat16),
                                  ctypes.addressof(out))
    return lk_tile.info_dict(rc, out, win, P, lanes, "lk_strip_info")


def lk_level(imgJ, imgI, cJ, cI, aJ, a0, valid, win: int, iters: int,
             eps: float, hiX: float, want_err: bool = True, _lanes=None):
    """The level for tensors on one device: the CUDA kernel for CUDA tensors
    (launched on the current stream, no sync; raises if it cannot build or
    launch), the plain version for CPU tensors.  ``_lanes``: as for
    ``lk_tile.lk_level`` (forces the threads a track; no caller's option)."""
    global launches
    lk_tile.check_lanes(_lanes, win, lk_tile.search_side(win, hiX))
    if imgJ.device.type == "cpu":
        return lk_level_plain(imgJ, imgI, cJ, cI, aJ, a0, valid, win, iters,
                              eps, hiX, want_err)
    if imgJ.device.type != "cuda":
        raise RuntimeError(f"lk_level: unsupported device {imgJ.device}")
    _check(imgJ, imgI)
    lk_tile.check_level_args(imgJ, imgI, cJ, cI, aJ, a0, valid, 1,
                             img_dtype=imgJ.dtype)
    valid, a_out, eig, err = lk_tile.launch_buffers(imgJ, imgI, cJ, cI, aJ,
                                                    a0, valid)
    T = cJ.shape[0]
    R, Wp = imgJ.shape
    P = lk_tile.search_side(win, hiX)
    lanes = lk_tile.launch_lanes(T, lk_tile.sm_count(imgJ.device), win, P,
                                 _lanes)
    nxt = torch.empty(1, dtype=torch.int32, device=imgJ.device)
    lib = _library()
    with torch.cuda.device(imgJ.device):
        rc = lib.lk_strip_launch(
            imgJ.data_ptr(), imgI.data_ptr(), cJ.data_ptr(), cI.data_ptr(),
            aJ.data_ptr(), a0.data_ptr(), valid.data_ptr(),
            a_out.data_ptr(), eig.data_ptr(), err.data_ptr(),
            T, R, Wp, win, P, iters, eps, hiX, int(bool(want_err)),
            int(imgJ.dtype == torch.bfloat16), lanes, nxt.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lk_strip kernel launch failed: CUDA error {rc}")
    launches += 1
    return a_out, eig, err
