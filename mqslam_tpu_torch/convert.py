"""State carried across from the JAX package, as NumPy arrays.

The port never sees a JAX object: a caller turns the JAX ``TrackerState`` /
calibration into NumPy (``np.asarray`` per field) and hands the dict here.
"""

import dataclasses

import numpy as np
import torch

from mqslam_tpu_torch import resolve_device
from mqslam_tpu_torch.core.camera import Cal3DS2
from mqslam_tpu_torch.frontend.tracker import TrackerConfig, TrackerState

__all__ = ["cal_from_numpy", "config_from_jax", "state_from_numpy",
           "state_to_numpy"]

_DTYPES = {
    "base_uv": torch.float32, "cur_uv": torch.float32,
    "active": torch.bool, "triangulated": torch.bool,
    "objp_idx": torch.int32, "objp": torch.float32,
    "objp_color": torch.float32, "objp_group": torch.int32,
    "n_objp": torch.int32, "rvec": torch.float32, "tvec": torch.float32,
    "rvec_keyfr": torch.float32, "tvec_keyfr": torch.float32,
    "group_id": torch.int32,
}


def cal_from_numpy(arr9, device=None):
    """Cal3DS2 from the 9-vector ``fx fy s u0 v0 k1 k2 p1 p2``."""
    device = resolve_device(device)
    a = torch.as_tensor(np.asarray(arr9, dtype=np.float32)).to(device)
    return Cal3DS2.from_array(a)


def config_from_jax(cfg):
    """The port's TrackerConfig from the JAX package's (a dataclass
    instance, or a dict of its fields); unknown fields are an error."""
    if dataclasses.is_dataclass(cfg):
        cfg = dataclasses.asdict(cfg)
    return TrackerConfig(**dict(cfg))


def state_from_numpy(fields, device=None):
    """TrackerState from {field: ndarray} (single agent or [A]-stacked).
    Every field of the JAX state is expected but its PRNG ``key``, which is
    ignored: the port's RANSAC draws are explicit arguments."""
    device = resolve_device(device)
    missing = [k for k in TrackerState._fields if k not in fields]
    if missing:
        raise KeyError(f"state fields missing: {missing}")
    return TrackerState(**{
        k: torch.as_tensor(np.array(fields[k])).to(_DTYPES[k]).to(device)
        for k in TrackerState._fields})


def state_to_numpy(state: TrackerState):
    """{field: ndarray} of a TrackerState (host copy)."""
    return {k: v.detach().cpu().numpy() for k, v in state._asdict().items()}
