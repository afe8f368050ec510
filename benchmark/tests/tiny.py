"""Tiny CPU versions of the benchmark's cells, for the tests."""

import copy

import torch

from benchmark import harness

TRACKER = dict(max_tracks=64, max_landmarks=1024, target_keypoints=50,
               ransac_hypotheses=16)


def spec(cell):
    """The cell's spec cut to a size a CPU test holds (same code paths)."""
    s = copy.deepcopy(harness.cell_spec(cell))
    cam, tr = s["config"]["camera"], s["workload"]["traffic"]
    driver = s["workload"]["driver"]
    if driver == "fleet_stream":
        cam.update(width=160, height=120, fx=97.6, fy=97.3, cx=78.1,
                   cy=62.0)
        tr.update(agents=2, init_points=40, judge_every=3, profile_groups=2)
    s["config"]["tracker"].update(TRACKER)
    return s


def cell(name, seed=2 ** 31 + 11, device="cpu"):
    s = spec(name)
    drv = harness.load_module("drivers", s["workload"]["driver"])
    return drv.Cell(harness.Context(s, seed, torch.device(device)))
