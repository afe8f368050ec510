"""Per-track patch extraction for the LK driver's ``dma_extract`` path: the
CUDA kernel's wrapper and its plain PyTorch version.  Counterpart of the JAX
package's ``ops/extract_pallas.py::extract_patches_dma``.

Contract (both versions):

  img          [H, W] float32 contiguous, H >= ROWS_CAP, W >= 256
               (``dma_extract_supported``; the LK driver edge-pads every
               level to 8 rows / 128 columns, at least 256, first)
  corner_yx    [T, 2] int32 (row, col) — any values, clamped here
  P            patch columns, 1 <= P <= ROWS_CAP

  returns      patches [T, ROWS_CAP, P] f32 — rows y0 .. y0+47, columns
               cx .. cx+P-1 of img; y0 [T] int32 — the 8-aligned row at or
               above the clamped corner row; cx [T] int32 — the clamped
               corner column

The clamp (``_clamped_corners``) is the TPU kernel's: up to 7 rows / 127
columns tighter than ``H - P`` / ``W - P``, which changes only tracks that
are out of bounds already.  The caller adds ``corner_row - y0`` (in [0, 8),
up to 10 at the bottom clamp) to its fractional row anchor; the rows below
the requested window are real image rows.  None of the TPU kernel's
transport crosses over (the aligned 256-column strip copy, the lane roll).

An exact copy: the kernel and the plain version are bit-equal.  On a CUDA
tensor ``extract_patches_dma`` launches the kernel (``csrc/extract.cu``) or
raises; the plain version serves CPU tensors, and the comparison on the
card.  ``launches`` counts kernel launches and nothing else.

The kernel has two paths (``PATHS``; the source says how each copies,
and what each measured), and ``kernel_path(P)`` picks one from P alone:
``"vec4"`` (a thread copies four floats of one row with one 16-byte store)
when P % 4 == 0 — both sides of the main paths' window, 24 and 36 — else
``"element"``.
"""

import ctypes

import torch

__all__ = ["ROWS_CAP", "PATHS", "dma_extract_supported", "kernel_path",
           "check_path", "extract_patches_dma",
           "extract_patches_plain", "launches"]

ROWS_CAP = 48          # patch rows: 8-aligned, >= 8-residual + P(<=38) rows
_STRIP_COLS = 256      # the TPU strip's width, which the column cap keeps
PATHS = ("vec4", "element")    # the kernel's paths, its codes 0, 1

launches = 0

_lib = None


def dma_extract_supported(H: int, W: int) -> bool:
    """Image large enough for the extractor's clamps."""
    return H >= ROWS_CAP and W >= _STRIP_COLS


def kernel_path(P: int) -> str:
    """The kernel's path for patches of P columns: ``"vec4"`` when P % 4 ==
    0 (a patch row is then whole 16-byte units), else ``"element"``.  The
    kernel refuses the four-float path for any other P."""
    return "vec4" if P % 4 == 0 else "element"


def check_path(path, P: int):
    """Raise on a forced path no launch takes: not one of ``PATHS``, or
    the four-float path ``"vec4"`` for P % 4 != 0."""
    if path is None:
        return
    if path not in PATHS:
        raise ValueError(f"_path must be one of {PATHS}, got {path!r}")
    if path == "vec4" and P % 4:
        raise ValueError(f"_path={path!r} needs P % 4 == 0, got P = {P}")


def _clamped_corners(cy, cx, H, W, P):
    """Clamped corners and the 8-aligned row below which a patch starts:
    (cy, cx, y0, x0), x0 the 128-aligned column the TPU strip started at
    (kept for the caps; no copy here starts there)."""
    y0_max = ((H - ROWS_CAP) // 8) * 8
    x0_max = ((W - _STRIP_COLS) // 128) * 128
    cy = torch.clamp(cy, 0, min(H - P, y0_max + ROWS_CAP - P))
    cx = torch.clamp(cx, 0, min(W - P, x0_max + _STRIP_COLS - P))
    y0 = torch.clamp((cy // 8) * 8, max=y0_max)
    x0 = torch.clamp((cx // 128) * 128, max=x0_max)
    return cy, cx, y0, x0


def _check(img, corner_yx, P):
    if img.dim() != 2 or img.dtype != torch.float32:
        raise TypeError("img must be [H, W] float32")
    H, W = img.shape
    if not dma_extract_supported(H, W):
        raise ValueError(f"image {H}x{W} is below the extractor's "
                         f"{ROWS_CAP}x{_STRIP_COLS} minimum")
    if corner_yx.dim() != 2 or corner_yx.shape[1] != 2 \
            or corner_yx.dtype != torch.int32:
        raise TypeError("corner_yx must be [T, 2] int32")
    if not 1 <= P <= ROWS_CAP:
        raise ValueError(f"P = {P} outside [1, {ROWS_CAP}]")
    if corner_yx.device != img.device:
        raise ValueError("img and corner_yx must lie on one device")


def extract_patches_plain(img, corner_yx, P: int):
    """The extraction in plain tensor ops: clamp, then one advanced-indexing
    gather."""
    _check(img, corner_yx, P)
    H, W = img.shape
    _, cx, y0, _ = _clamped_corners(corner_yx[:, 0], corner_yx[:, 1], H, W,
                                    P)
    rows = y0[:, None] + torch.arange(ROWS_CAP, device=img.device)
    cols = cx[:, None] + torch.arange(P, device=img.device)
    return img[rows[:, :, None], cols[:, None, :]], y0, cx


def _library():
    global _lib
    if _lib is None:
        from mqslam_tpu_torch import csrc
        lib = csrc.load("extract")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.extract_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
        lib.extract_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def extract_patches_dma(img, corner_yx, P: int, _path=None):
    """The extraction for tensors on one device: the CUDA kernel for CUDA
    tensors (launched on the current stream, no sync; raises if it cannot
    build or launch), the plain version for CPU tensors.

    ``_path`` forces one of ``PATHS`` instead of ``kernel_path(P)`` (checked
    before the device is looked at), so that each path can be held against
    the plain version on the card; it changes no result and is not an option
    of any caller."""
    global launches
    check_path(_path, P)
    if img.device.type == "cpu":
        return extract_patches_plain(img, corner_yx, P)
    if img.device.type != "cuda":
        raise RuntimeError(f"extract_patches_dma: unsupported device "
                           f"{img.device}")
    _check(img, corner_yx, P)
    for name, x in (("img", img), ("corner_yx", corner_yx)):
        if not x.is_contiguous():
            raise ValueError(f"extract_patches_dma: {name} must be "
                             "contiguous")
    path = kernel_path(P) if _path is None else _path
    T = corner_yx.shape[0]
    H, W = img.shape
    out = torch.empty((T, ROWS_CAP, P), dtype=torch.float32,
                      device=img.device)
    y0 = torch.empty(T, dtype=torch.int32, device=img.device)
    cx = torch.empty(T, dtype=torch.int32, device=img.device)
    lib = _library()
    with torch.cuda.device(img.device):
        rc = lib.extract_launch(
            img.data_ptr(), corner_yx.data_ptr(), out.data_ptr(),
            y0.data_ptr(), cx.data_ptr(), T, H, W, P, PATHS.index(path),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"extract kernel launch failed ({path} path): "
                           f"CUDA error {rc}")
    launches += 1
    return out, y0, cx
