"""PyTorch/CUDA port of the multi-quadrotor SLAM engine.

A second package beside the JAX one, with the same sub-packages and function
names (``core/``, ``ops/``, ``frontend/``).  Plain tensor code is PyTorch;
every accelerator kernel is hand-written CUDA C++ under ``csrc/``, compiled
with ``nvcc`` at first use (see ``csrc/__init__.py``).

Conventions of the port:

* functions are plain functions on tensors and accept leading batch
  dimensions where the JAX package relied on ``vmap``;
* entry points (constructors and runners) take ``device=None`` meaning
  ``torch.device("cuda")`` and raise when no CUDA device is present; pass
  ``device="cpu"`` explicitly to run on the CPU (as the tests do);
* random draws are explicit arguments (``scores=`` / ``generator=``).
"""

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None):
    """``None`` -> the CUDA device (raises without one); else ``device``.

    Entry points never fall back to the CPU on their own: a caller who wants
    the CPU says so."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "mqslam_tpu_torch entry points run on a CUDA device by "
                "default and none is available; pass device='cpu' to run "
                "on the CPU explicitly")
        return torch.device("cuda")
    return torch.device(device)
