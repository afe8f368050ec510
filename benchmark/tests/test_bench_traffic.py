"""The traffic generators: the same seed gives the same inputs."""

import numpy as np
import torch

from benchmark.traffic import plane

CAM = dict(width=96, height=64, fx=75.0, fy=74.5, cx=47.0, cy=33.5,
           fps=20.0)
TRAFFIC = dict(lap_frames=40, speeds_m_s=[0.44, 0.99], plane_z=2.78,
               tex_scale=64.0, noise_sigma=2.0, offset_m=16.0)
BIG = 2 ** 31 + 977


def test_plane_stream_is_a_function_of_the_seed():
    a, ca = plane.stream(TRAFFIC, CAM, BIG, 3, "cpu")
    b, cb = plane.stream(TRAFFIC, CAM, BIG, 3, "cpu")
    c, _ = plane.stream(TRAFFIC, CAM, BIG + 1, 3, "cpu")
    assert a.dtype == torch.uint8 and a.shape == (3, 41, 64, 96)
    assert torch.equal(a, b) and np.array_equal(ca, cb)
    assert not torch.equal(a, c)


def test_plane_stream_laps_close_and_starts_spread():
    _, c = plane.stream(TRAFFIC, CAM, 5, 4, "cpu")
    assert np.allclose(c[:, 0], c[:, -1])
    for a in range(4):
        speed = TRAFFIC["speeds_m_s"][a % 2]
        base = plane.circuit_centres(40, plane.circuit_side(speed, 40, 20.0))
        off = c[a, 0, :2] - base[a * 10, :2]
        assert np.allclose(c[a, :-1, :2] - off,
                           base[(a * 10 + np.arange(40)) % 40, :2])


def test_each_agent_flies_its_lap_at_its_speed():
    _, c = plane.stream(TRAFFIC, CAM, 5, 2, "cpu")
    for a, speed in enumerate(TRAFFIC["speeds_m_s"]):
        path = np.linalg.norm(np.diff(c[a], axis=0), axis=1).sum()
        assert np.isclose(path / (40 / CAM["fps"]), speed)


def test_backproject_lands_on_the_plane_and_projects_back():
    uv = np.array([[10.0, 20.0], [50.5, 33.25]])
    X = plane.backproject(uv, np.array([1.0, 2.0, 0.0]), CAM, 4.0)
    assert np.allclose(X[:, 2], 4.0)
    xn = (X[:, :2] - [1.0, 2.0]) / 4.0
    assert np.allclose(xn * [75.0, 74.5] + [47.0, 33.5], uv)
