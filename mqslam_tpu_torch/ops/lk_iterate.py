"""The Lucas-Kanade Newton loop on pre-extracted patches (the driver's
``impl="pallas"`` mode): the CUDA kernel's wrapper and its plain PyTorch
version.  Counterpart of the JAX package's
``ops/lk_pallas.py::lk_iterate_pallas``.

Contract (both versions):

  patchesJ     [T, PJ, PJ] f32 — each track's template patch
  patchesI     [T, P, P] f32 — each track's search patch
  aJ, a0       [T, 2] f32 (ay, ax) — template window anchor (in [1, 2) for
               an in-image track; not clipped, >= 0 or NaN) / initial search
               anchor, in the track's own patch coordinates
  scalars      win, iters, eps

  returns      a_final [T, 2] (ay, ax), min_eig [T], err [T]  (all f32)

Per track: the template window and its gradients (lerped windows at +-1,
i.e. central differences of one lerped grid), ``G``, ``min_eig =
lambda_min(G) / win^2``, then up to ``iters`` Newton steps with the
determinant clamped at 1e-20, the anchor clipped to ``[0, P - 2 - win]``
(the search patch's side), frozen once ``|step| < eps``; ``err`` = mean
``|J - I|`` at the final anchor, always.  There is no ``valid``: every
track iterates and the caller gates status.  Every read is clamped to the
track's own patch, so a NaN anchor never forms an address.

This is the per-track function of ``ops/lk_tile`` with each track's patches
as its own tile and corners 0: the plain version is ``lk_tile``'s plain
level over the patches stacked as a T-tile atlas (the template patches
widened to the common side by repeating their last row and column, which
is what a clamped read sees).

On a CUDA tensor ``lk_iterate`` launches the kernel (``csrc/lk_iterate.cu``)
or raises; the plain version serves CPU tensors, and the comparison on the
card.  ``launches`` counts kernel launches and nothing else.

The launch shape follows the level kernels' rule (``ops/lk_tile``), chosen
here in plain Python: ``launch_shape`` gives the instantiation (the
compiled-in window ``lk_tile.SPECIALISED`` or the generic one-warp code)
and the threads a track (``lk_tile.launch_lanes``: 128 while the tracks
would leave most of the card empty as one warp each, else 32).
"""

import ctypes

import torch

from mqslam_tpu_torch.ops import lk_tile

__all__ = ["lk_iterate", "lk_iterate_plain", "launches", "launch_shape",
           "check_alignment", "kernel_info"]

launches = 0

_lib = None


def _check(patchesJ, patchesI, aJ, a0, win):
    T = patchesJ.shape[0]
    for name, x in (("patchesJ", patchesJ), ("patchesI", patchesI)):
        if x.dim() != 3 or x.shape[0] != T or x.shape[1] != x.shape[2] \
                or x.dtype != torch.float32:
            raise TypeError(f"{name} must be [T, side, side] float32")
    for name, x in (("aJ", aJ), ("a0", a0)):
        if x.shape != (T, 2) or x.dtype != torch.float32:
            raise TypeError(f"{name} must be [T, 2] float32")
    if patchesI.shape[1] < win + 2:
        raise ValueError(f"search patches of side {patchesI.shape[1]} are "
                         f"too small for win = {win}")
    for x in (patchesI, aJ, a0):
        if x.device != patchesJ.device:
            raise ValueError("all tensors must lie on one device")


def lk_iterate_plain(patchesJ, patchesI, aJ, a0, win: int = 21,
                     iters: int = 30, eps: float = 0.01,
                     return_iters: bool = False):
    """The loop in plain tensor ops (see the module docstring).
    ``return_iters`` also returns the Newton steps each track took."""
    _check(patchesJ, patchesI, aJ, a0, win)
    T, PJ, P = patchesJ.shape[0], patchesJ.shape[1], patchesI.shape[1]
    S = max(PJ, P)
    dev = patchesJ.device

    def tiles(p):
        idx = torch.arange(S, device=dev).clamp(max=p.shape[1] - 1)
        return p[:, idx][:, :, idx].reshape(T * S, S)

    # There is no valid mask: a NaN template anchor makes every output of
    # its track NaN, as in the kernel.  It runs here on a stand-in anchor so
    # that no index is formed from it, and its outputs are set after.
    nan_j = aJ.isnan().any(1)
    zero = torch.zeros((T, 2), dtype=torch.int32, device=dev)
    out = lk_tile.lk_level_plain(
        tiles(patchesJ), tiles(patchesI), zero, zero,
        torch.where(nan_j[:, None], torch.ones_like(aJ), aJ), a0,
        torch.ones(T, dtype=torch.bool, device=dev), T, win, iters, eps,
        float(P - 2 - win), True, return_iters)
    nan = torch.tensor(float("nan"), device=dev)
    a_fin, eig, err = (torch.where(nan_j.view((T,) + (1,) * (x.dim() - 1)),
                                   nan, x) for x in out[:3])
    if not return_iters:
        return a_fin, eig, err
    # NaN steps never fall below eps: such a track takes every step
    return a_fin, eig, err, torch.where(nan_j, iters, out[3]).to(out[3].dtype)


def _library():
    global _lib
    if _lib is None:
        from mqslam_tpu_torch import csrc
        lib = csrc.load("lk_iterate")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.lk_iterate_launch.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i,
                                          f, f, i, p, p]
        lib.lk_iterate_launch.restype = ctypes.c_int
        lib.lk_iterate_info.argtypes = [i, i, i, p]
        lib.lk_iterate_info.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch_shape(T: int, n_sm: int, win: int, P: int, _lanes=None):
    """(instantiation, threads a track) of a launch for T tracks with window
    ``win`` and search patches of side P on a card of ``n_sm`` SMs: the
    level kernels' rule (``lk_tile.instantiation``, ``lk_tile.launch_lanes``;
    ``_lanes`` forces the threads a track, checked)."""
    return (lk_tile.instantiation(win, P),
            lk_tile.launch_lanes(T, n_sm, win, P, _lanes))


def check_alignment(*ptrs):
    """Raise unless every address is 16-byte aligned: the compiled-in
    window's kernel copies each track's patches 16 bytes at a time (every
    track's patches then stay aligned: 24^2 and 36^2 floats are multiples
    of four)."""
    bad = [p for p in ptrs if p % 16]
    if bad:
        raise ValueError(f"lk_iterate: the patches must start 16-byte "
                         f"aligned, got {bad[0]:#x}")


def kernel_info(win: int = 21, P: int = 36, lanes: int = 32) -> dict:
    """Registers a thread, shared bytes a track and resident warps a SM
    (CUDA occupancy API) of the kernel a launch with this window and lane
    shape runs, on the current CUDA device."""
    lk_tile.check_lanes(lanes, win, P)
    out = (ctypes.c_int * 4)()
    rc = _library().lk_iterate_info(win, P, lanes, ctypes.addressof(out))
    return lk_tile.info_dict(rc, out, win, P, lanes, "lk_iterate_info")


def lk_iterate(patchesJ, patchesI, aJ, a0, win: int = 21, iters: int = 30,
               eps: float = 0.01, _lanes=None):
    """The loop for tensors on one device: the CUDA kernel for CUDA tensors
    (launched on the current stream, no sync; raises if it cannot build or
    launch), the plain version for CPU tensors.

    ``_lanes`` forces the threads a track (one of ``lk_tile.LANE_SHAPES``;
    32 only for the generic window) instead of the rule's choice, so that
    each instantiation can be held against the plain version on the card; it
    changes no result and is not an option of any caller."""
    global launches
    if _lanes is not None:
        lk_tile.check_lanes(_lanes, win, int(patchesI.shape[-1]))
    if patchesJ.device.type == "cpu":
        return lk_iterate_plain(patchesJ, patchesI, aJ, a0, win, iters, eps)
    if patchesJ.device.type != "cuda":
        raise RuntimeError(f"lk_iterate: unsupported device "
                           f"{patchesJ.device}")
    _check(patchesJ, patchesI, aJ, a0, win)
    for name, x in (("patchesJ", patchesJ), ("patchesI", patchesI),
                    ("aJ", aJ), ("a0", a0)):
        if not x.is_contiguous():
            raise ValueError(f"lk_iterate: {name} must be contiguous")
    T, PJ, P = patchesJ.shape[0], patchesJ.shape[1], patchesI.shape[1]
    inst, lanes = launch_shape(T, lk_tile.sm_count(patchesJ.device), win, P,
                               _lanes)
    if inst == "specialised":
        check_alignment(patchesJ.data_ptr(), patchesI.data_ptr())
    f32 = dict(dtype=torch.float32, device=patchesJ.device)
    a_out, eig, err = (torch.empty((T, 2), **f32), torch.empty(T, **f32),
                       torch.empty(T, **f32))
    nxt = torch.empty(1, dtype=torch.int32, device=patchesJ.device)
    lib = _library()
    with torch.cuda.device(patchesJ.device):
        rc = lib.lk_iterate_launch(
            patchesJ.data_ptr(), patchesI.data_ptr(), aJ.data_ptr(),
            a0.data_ptr(), a_out.data_ptr(), eig.data_ptr(), err.data_ptr(),
            T, PJ, P, win, iters, eps, float(P - 2 - win), lanes,
            nxt.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lk_iterate kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    return a_out, eig, err
