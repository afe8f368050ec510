"""Rolling-shutter feature-jitter statistics over a static-scene sequence.

Equivalent of the reference's Octave study (reference: Work/ARDrone2_tests/
rolling_shutter_analysis/rolling_shutter_statistics.m): track features
through a sequence of a static scene shot from a (nominally) static camera,
remove each track's mean, and classify tracks by their max absolute
deviation — the <=0.5 px class's spread is where the reference's
sigma = 0.8 px observation-noise default came from
(triangulation_comparison.py:277).
"""

from typing import NamedTuple

import numpy as np
import torch

from mqslam_tpu_torch import resolve_device

__all__ = ["RollingShutterStats", "analyze_sequence", "classify_tracks"]


class RollingShutterStats(NamedTuple):
    deviations_x: np.ndarray  # [frames, tracks] mean-removed x
    deviations_y: np.ndarray
    classes: dict             # name -> track index array
    stds: dict                # name -> std of x deviations in that class


def classify_tracks(dev_x, dev_y):
    """The reference's deviation classes (rolling_shutter_statistics.m:55-62):
    0 / <=0.5 px / <=1 px / <=3 px / >3 px (bad tracks)."""
    ax = np.abs(dev_x)
    ay = np.abs(dev_y)
    mx = ax.max(axis=0)
    classes = {
        "zero": np.flatnonzero(mx == 0),
        "half": np.flatnonzero((mx > 0) & (mx <= 0.5)),
        "one": np.flatnonzero((mx > 0.5) & (mx <= 1.0)),
        "three": np.flatnonzero((mx > 1.0) & (mx <= 3.0)),
        "bad": np.flatnonzero((ax.max(axis=0) > 3.0)
                              & (ay.max(axis=0) > 3.0)),
    }
    stds = {}
    for name, idx in classes.items():
        stds[name] = float(dev_x[:, idx].std()) if len(idx) else 0.0
    return classes, stds


def analyze_sequence(images, max_tracks: int = 256, detect_cell: int = 12,
                     device=None) -> RollingShutterStats:
    """Detect features in frame 0, LK-track through all frames on
    ``device`` (None: the card; one image, so ``lk_track``'s strip level
    kernel), return mean-removed deviations + the deviation
    classification."""
    from mqslam_tpu_torch.ops import features, lk

    device = resolve_device(device)
    images = [torch.as_tensor(np.asarray(im, dtype=np.float32)).to(device)
              for im in images]
    uv0, valid = features.detect_corners(images[0], max_corners=max_tracks,
                                         cell=detect_cell)
    alive = valid.cpu().numpy()
    pts = uv0.cpu().numpy()
    positions = [pts.copy()]
    cur = uv0
    for prev, nxt in zip(images[:-1], images[1:]):
        cur, st, err = lk.lk_track(prev, nxt, cur,
                                   torch.as_tensor(alive).to(device))
        alive = alive & st.cpu().numpy()
        positions.append(cur.cpu().numpy())
    traj = np.stack(positions)  # [frames, tracks, 2]
    traj = traj[:, alive]
    dev = traj - traj.mean(axis=0, keepdims=True)
    classes, stds = classify_tracks(dev[..., 0], dev[..., 1])
    return RollingShutterStats(dev[..., 0], dev[..., 1], classes, stds)
