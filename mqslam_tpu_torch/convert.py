"""State carried across from the JAX package, as NumPy arrays.

The port never sees a JAX object: a caller turns the JAX ``TrackerState`` /
calibration / ``BAProblem`` / ``BAVariables`` / ``KeyframeDB`` /
``PoseGraph`` into NumPy (``np.asarray`` per field) and hands the dict here.
``flatten_ba_data`` goes the other way for comparisons: it reads attributes
only, so it takes this package's ``io.ba_info.BAData`` and any object of the
same shape.
"""

import dataclasses

import numpy as np
import torch

from mqslam_tpu_torch import resolve_device
from mqslam_tpu_torch.ba.posegraph import PoseGraph
from mqslam_tpu_torch.ba.problem import BAProblem, BAVariables
from mqslam_tpu_torch.core import camera
from mqslam_tpu_torch.core.camera import Cal3DS2
from mqslam_tpu_torch.frontend.loopclosure import KeyframeDB
from mqslam_tpu_torch.frontend.tracker import TrackerConfig, TrackerState

__all__ = ["cal_from_numpy", "cal_from_K_dist", "config_from_jax",
           "state_from_numpy", "state_to_numpy", "flatten_ba_data",
           "problem_from_numpy", "variables_from_numpy",
           "variables_to_numpy", "keyframe_db_from_numpy",
           "keyframe_db_to_numpy", "pose_graph_from_numpy",
           "pose_graph_to_numpy"]

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


def cal_from_K_dist(K, dist=None, device=None):
    """Cal3DS2 from a NumPy 3x3 K and distortion coefficients
    (k1, k2, p1, p2[, k3]), as ``io.intrinsics`` loads them."""
    device = resolve_device(device)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32)).to(device)
    return camera.cal_from_K_dist(f32(K), None if dist is None
                                  else f32(dist))


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


def _tuple_to_numpy(t):
    return {k: x.detach().cpu().numpy() for k, x in t._asdict().items()}


def _ba_tensor(a, device):
    a = np.array(a)                 # a writable copy of a read-only view
    if a.dtype.kind == "f":
        return torch.as_tensor(a, dtype=torch.float32).to(device)
    if a.dtype.kind in "iu":
        return torch.as_tensor(a.astype(np.int32)).to(device)
    return torch.as_tensor(a).to(device)


def variables_from_numpy(fields, device=None):
    """BAVariables from {pose_r, pose_t, points: ndarray} (float32 on the
    device)."""
    device = resolve_device(device)
    return BAVariables(**{k: _ba_tensor(fields[k], device)
                          for k in BAVariables._fields})


def variables_to_numpy(v: BAVariables):
    """{field: ndarray} of BAVariables (host copy)."""
    return _tuple_to_numpy(v)


def problem_from_numpy(fields, device=None):
    """BAProblem from {field: ndarray}, with ``init`` itself a {field:
    ndarray} dict of the initial variables: the JAX package's problem, field
    by field (floats float32, indices int32, masks bool), so both packages
    solve the identical problem.  Every field is expected."""
    device = resolve_device(device)
    missing = [k for k in BAProblem._fields if k not in fields]
    if missing:
        raise KeyError(f"problem fields missing: {missing}")
    return BAProblem(
        init=variables_from_numpy(fields["init"], device),
        **{k: _ba_tensor(fields[k], device) for k in BAProblem._fields
           if k != "init"})


def _tuple_from_numpy(cls, fields, device, dtypes=None):
    """A NamedTuple of tensors from {field: ndarray}; every field is
    expected.  Floats become float32, integers int32 (``dtypes`` overrides
    per field), booleans stay."""
    device = resolve_device(device)
    missing = [k for k in cls._fields if k not in fields]
    if missing:
        raise KeyError(f"{cls.__name__} fields missing: {missing}")
    out = {k: _ba_tensor(fields[k], device) for k in cls._fields}
    for k, dt in (dtypes or {}).items():
        out[k] = out[k].to(dt)
    return cls(**out)


def keyframe_db_from_numpy(fields, device=None):
    """KeyframeDB from {field: ndarray} (the JAX package's, field by field:
    descriptors uint8, masks bool, the rest float32, ``count`` int32)."""
    return _tuple_from_numpy(KeyframeDB, fields, device,
                             {"desc": torch.uint8})


def keyframe_db_to_numpy(db: KeyframeDB):
    """{field: ndarray} of a KeyframeDB (host copy)."""
    return _tuple_to_numpy(db)


def pose_graph_from_numpy(fields, device=None):
    """PoseGraph from {field: ndarray} (floats float32, edge ids int32,
    masks bool)."""
    return _tuple_from_numpy(PoseGraph, fields, device)


def pose_graph_to_numpy(g: PoseGraph):
    """{field: ndarray} of a PoseGraph (host copy)."""
    return _tuple_to_numpy(g)


def flatten_ba_data(data):
    """{path: ndarray} of everything in a BAData-shaped object: each field,
    list entry by list entry (``"poses[0][3][1]"``), noise models as their
    kind / dim / sigmas, holes (None) as empty arrays under ``path + "?"``.
    Two dumps hold the same factor graph when their flattenings have equal
    keys and equal arrays."""
    out = {}

    def walk(path, x):
        if x is None:
            out[path + "?"] = np.zeros(0)
        elif hasattr(x, "sigmas"):
            out[path + ".kind"] = np.asarray(x.kind)
            out[path + ".dim"] = np.asarray(x.dim)
            out[path + ".sigmas"] = np.asarray(x.sigmas, np.float64)
        elif isinstance(x, (list, tuple)) and not (
                x and all(np.isscalar(v) for v in x)):
            out[path + "#"] = np.asarray(len(x))
            for i, v in enumerate(x):
                walk(f"{path}[{i}]", v)
        else:
            out[path] = np.asarray(x)

    for f in dataclasses.fields(data):
        walk(f.name, getattr(data, f.name))
    return out
