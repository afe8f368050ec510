"""Checkpoint / resume for the front-end sequence runner.

The reference's only recovery story is the periodic trajectory/map flush
(reference: slam2.py:1244-1248 write_output every 30 frames) — state is
lost on interruption. Here the FULL resumable state is serialized: the
fixed-capacity ``TrackerState``, the host bookkeeping (per-frame poses with
rejection holes, accepted flags, BA-info container, tracking history), the
sequence cursor, and what makes the rest of the run's random draws
reproducible, so the resumed run is bit-identical to an uninterrupted one.

The port's state has no PRNG key: its RANSAC draws are explicit.  So the
checkpoint also holds the state of the ``torch.Generator`` that draws them
(when one does) and of the loop-closure generator; with injected draws
(``ransac_scores``), the frame cursor ``frame_idx`` is also the cursor into
them (frame i uses row i - 1).

Format: one ``.npz`` — ``__version``, ``TrackerState`` leaves under the
port's field names, the generator states as uint8 arrays, and one pickled
blob for the host bookkeeping, as in the JAX package.  A checkpoint of the
JAX package is not read: its pickle names classes of that package, and its
state leaves include a PRNG key the port has no use for.  Unpickling runs
code, so load only checkpoints this program wrote.
"""

import pickle

import numpy as np
import torch

from mqslam_tpu_torch import resolve_device
from mqslam_tpu_torch.frontend.tracker import TrackerState

__all__ = ["save_checkpoint", "load_checkpoint"]

_VERSION = 1
_GENERATORS = ("generator", "loop_generator")


def save_checkpoint(path, state: TrackerState, frame_idx: int, prev_img,
                    poses, accepted, bookkeeping=None, generators=None):
    """Write a resumable checkpoint after processing frame ``frame_idx``.

    poses: list of (4x4 ndarray | None); accepted: list of int flags;
    bookkeeping: any picklable extras (BAData, history, ...);
    generators: {"generator" | "loop_generator": torch.Generator | None}.
    """
    arrays = {f"state_{name}": val.detach().cpu().numpy()
              for name, val in zip(TrackerState._fields, state)}
    for name, gen in (generators or {}).items():
        if name not in _GENERATORS:
            raise KeyError(f"unknown generator {name!r}")
        if gen is not None:
            arrays[f"rng_{name}"] = gen.get_state().numpy()
    pose_stack = np.stack([np.eye(4) if P is None else np.asarray(P)
                           for P in poses]) if poses else np.zeros((0, 4, 4))
    pose_valid = np.asarray([P is not None for P in poses], bool)
    blob = pickle.dumps({"bookkeeping": bookkeeping})
    np.savez_compressed(
        path, __version=np.int32(_VERSION),
        frame_idx=np.int64(frame_idx), prev_img=np.asarray(prev_img),
        poses=pose_stack, pose_valid=pose_valid,
        accepted=np.asarray(accepted, np.int32),
        host_blob=np.frombuffer(blob, np.uint8), **arrays)


def load_checkpoint(path, device=None):
    """Returns (state, frame_idx, prev_img, poses, accepted, bookkeeping,
    generator_states); the state lives on ``device`` (None: the CUDA
    device), ``generator_states`` maps the saved generators' names to
    their ``get_state()`` tensors (for ``torch.Generator.set_state``)."""
    device = resolve_device(device)
    with np.load(path, allow_pickle=False) as z:
        if int(z["__version"]) != _VERSION:
            raise ValueError(f"checkpoint version {int(z['__version'])} "
                             f"unsupported (want {_VERSION})")
        state = TrackerState(*(torch.as_tensor(z[f"state_{name}"]).to(device)
                               for name in TrackerState._fields))
        poses = [P if ok else None
                 for P, ok in zip(z["poses"], z["pose_valid"])]
        rng = {name: torch.as_tensor(z[f"rng_{name}"])
               for name in _GENERATORS if f"rng_{name}" in z.files}
        blob = pickle.loads(z["host_blob"].tobytes())
        return (state, int(z["frame_idx"]), np.asarray(z["prev_img"]),
                poses, [int(a) for a in z["accepted"]], blob["bookkeeping"],
                rng)
