"""``viz/`` of both packages on the same inputs: colors, the drawing
primitives and overlays, the Composite 2D/3D painters, PNG, PLY and the
HTML viewer.

Tolerances: drawings equal array for array, those that go through the
float32 camera model too (``draw._project``, the painters'
``se3.from_rvec_tvec``: the projections agree to 1e-4 px, and no pixel
rounds the other way on these inputs); files (PNG, PLY, HTML) byte-equal.
"""

import numpy as np
import pytest
import torch

from mqslam_tpu.io import pcd as jpcd, tum as jtum
from mqslam_tpu.viz import (colors as jcol, draw as jdw, html_viewer as jhv,
                            painter as jpt, ply as jply)
from mqslam_tpu_torch.io import tum as ttum
from mqslam_tpu_torch.viz import (colors as tcol, draw as tdw,
                                  html_viewer as thv, painter as tpt,
                                  ply as tply)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def read(path):
    with open(path, "rb") as f:
        return f.read()


def test_colors():
    pj, nj = jcol.color_palette(2, 3, 4)
    pt, nt = tcol.color_palette(3, 3, 3)
    assert nt == 27
    pt, nt = tcol.color_palette(2, 3, 4)
    np.testing.assert_array_equal(pt, pj)
    assert nt == nj == 24
    lab = np.random.RandomState(0).randint(0, 256, (40, 3)).astype(np.uint8)
    np.testing.assert_array_equal(tcol.lab8_to_rgb8(lab),
                                  jcol.lab8_to_rgb8(lab))
    img = np.arange(12).reshape(3, 4)
    pts = np.array([[1.2, 0.4], [3.0, 2.0], [-4.0, 9.0]])
    np.testing.assert_array_equal(tcol.sample_colors(img, pts),
                                  jcol.sample_colors(img, pts))


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("with_colors", [True, False])
def test_ply(tmp_path, binary, with_colors):
    rng = np.random.RandomState(1)
    pts = rng.randn(9, 3).astype(np.float32)
    cols = rng.randint(0, 255, (9, 3)).astype(np.uint8) if with_colors \
        else None
    jply.save_ply(str(tmp_path / "j.ply"), pts, cols, binary=binary)
    tply.save_ply(str(tmp_path / "t.ply"), pts, cols, binary=binary)
    assert read(tmp_path / "t.ply") == read(tmp_path / "j.ply")


def test_pcd_to_ply(tmp_path):
    rng = np.random.RandomState(2)
    pts = rng.randn(7, 3).astype(np.float32)
    cols = rng.randint(0, 255, (7, 3)).astype(np.uint8)
    jpcd.save_pcd(tmp_path / "m.pcd", pts, cols)
    jply.pcd_to_ply(str(tmp_path / "m.pcd"), str(tmp_path / "j.ply"))
    tply.pcd_to_ply(str(tmp_path / "m.pcd"), str(tmp_path / "t.ply"))
    assert read(tmp_path / "t.ply") == read(tmp_path / "j.ply")


def test_html_viewer(tmp_path):
    rng = np.random.RandomState(0)
    pts = rng.uniform(-2, 2, (50, 3))
    for cols in (rng.randint(0, 255, (50, 3)).astype(np.uint8),
                 rng.uniform(0, 255, 50), None):
        jhv.export_viewer(str(tmp_path / "j.html"), pts, cols,
                          rng.uniform(-1, 1, (20, 3)))
        thv.export_viewer(str(tmp_path / "t.html"), pts, cols,
                          rng.uniform(-1, 1, (20, 3)))
    traj = (np.arange(3) / 30.0, np.arange(9).reshape(3, 3).astype(float),
            np.tile([0, 0, 0, 1.0], (3, 1)))
    jhv.export_viewer(str(tmp_path / "j.html"), pts, None,
                      jtum.CamTrajectory(*traj))
    thv.export_viewer(str(tmp_path / "t.html"), pts, None,
                      ttum.CamTrajectory(*traj))
    assert read(tmp_path / "t.html") == read(tmp_path / "j.html")
    thv.export_viewer(str(tmp_path / "e.html"), np.zeros((0, 3)))
    jhv.export_viewer(str(tmp_path / "f.html"), np.zeros((0, 3)))
    assert read(tmp_path / "e.html") == read(tmp_path / "f.html")
    jhv.export_live_viewer(str(tmp_path / "jl.html"), "traj.txt", "map.pcd",
                           period_s=2.0)
    thv.export_live_viewer(str(tmp_path / "tl.html"), "traj.txt", "map.pcd",
                           period_s=2.0)
    assert read(tmp_path / "tl.html") == read(tmp_path / "jl.html")


def _both(fn_name, shape, *args, **kw):
    a = np.zeros(shape, np.uint8)
    b = np.zeros(shape, np.uint8)
    getattr(jdw, fn_name)(a, *args, **kw)
    getattr(tdw, fn_name)(b, *args, **kw)
    return a, b


@pytest.mark.parametrize("call", [
    ("line", ((5, 5), (50, 40), tdw.rgb(255, 0, 0)), {}),
    ("line", ((-10, -10), (40, 40), tdw.rgb(9, 9, 9)), {"thickness": 3}),
    ("lines", ([(1, 2), (30, 3)], [(40, 40), (2, 30)], tdw.rgb(0, 9, 0)), {}),
    ("circle", ((20, 20), 5, tdw.rgb(0, 255, 0)), {"thickness": -1}),
    ("circle", ((19, 19), 6, tdw.rgb(255, 0, 0)), {"thickness": 2}),
    ("cross", ((30.4, 12.6), 3, tdw.rgb(1, 2, 3)), {}),
    ("fill_poly", ([(5, 5), (35, 5), (20, 30)], tdw.rgb(0, 0, 255)), {}),
    ("fill_poly", ([(50, 40), (80, 45), (70, 70), (45, 65)],
                   tdw.rgb(7, 7, 7)), {}),
])
def test_primitives(call):
    name, args, kw = call
    a, b = _both(name, (48, 64, 3), *args, **kw)
    assert a.any()
    np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(tdw.rgb(1, 2, 3), jdw.rgb(1, 2, 3))
    for x, y in zip(tdw.wireframe_3d_geometry(), jdw.wireframe_3d_geometry()):
        np.testing.assert_array_equal(x, y)


def test_keypoints_and_motion():
    rng = np.random.RandomState(3)
    img = rng.uniform(0, 255, (60, 80)).astype(np.float32)
    p1 = rng.uniform(0, 80, (12, 2))
    p2 = p1 + rng.uniform(-5, 5, (12, 2))
    np.testing.assert_array_equal(
        tdw.draw_keypoints_and_motion(img, p1, p2, (0, 255, 0)),
        jdw.draw_keypoints_and_motion(img, p1, p2, (0, 255, 0)))


K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]])


@pytest.mark.parametrize("rvec, tvec, dist", [
    (np.zeros(3), [0.0, 0.0, 10.0], None),
    ([0.2, -0.3, 0.1], [0.5, -0.2, 8.0], [0.05, -0.01, 0.001, 0.0]),
    ([1.1, 0.4, -0.7], [-1.0, 0.3, 12.0], None),
    (np.zeros(3), [100.0, 0.0, 10.0], None),          # origin off-image
])
def test_axis_system(rvec, tvec, dist):
    a, b = _both("draw_axis_system", (240, 320, 3), K, dist,
                 np.asarray(rvec), np.asarray(tvec), scale=4.0)
    np.testing.assert_array_equal(b, a)
    uj, zj = jdw._project(np.eye(3), rvec, tvec, K, dist)
    ut, zt = tdw._project(np.eye(3), rvec, tvec, K, dist)
    np.testing.assert_allclose(ut, uj, rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(zt, zj, rtol=1e-6)


@pytest.mark.parametrize("origin, neg_fy", [([[0.0, 0.0, 5.0]], False),
                                            ([[0.3, -0.2, 6.0]], True),
                                            ([[3.0, 0.0, 5.0]], False)])
def test_draw_camera(origin, neg_fy):
    P = np.eye(4)[:3]
    a, b = _both("draw_camera", (240, 320, 3), np.asarray(origin),
                 np.eye(3), K, P, neg_fy=neg_fy)
    np.testing.assert_array_equal(b, a)


def _painter_inputs(rng, n=40):
    uv = rng.uniform(0, 64, (n, 2)) * [1.0, 0.75]
    alive = rng.rand(n) < 0.8
    tri = rng.rand(n) < 0.6
    oidx = rng.randint(0, 20, n)
    objp = np.concatenate([rng.uniform(-1, 1, (20, 2)),
                           rng.uniform(4, 6, (20, 1))], 1).astype(np.float32)
    groups = rng.randint(0, 30, 20).astype(np.int32)
    return uv, alive, tri, oidx, objp, groups


@pytest.mark.parametrize("status, labels", [(1, False), (2, True),
                                            (0, False)])
def test_composite2d(tmp_path, status, labels):
    rng = np.random.RandomState(4)
    img = rng.uniform(0, 255, (48, 64)).astype(np.float32)
    Kp = np.array([[50.0, 0, 32], [0, 50.0, 24], [0, 0, 1]])
    uv, alive, tri, oidx, objp, groups = _painter_inputs(rng)
    args = (img, np.array([0.05, -0.02, 0.01]), np.array([0.1, 0, 2.0]),
            status, Kp, np.array([0.01, 0.0, 0.0, 0.0]), uv, alive, tri,
            oidx, objp, groups, 7)
    pj, pt = jpt.Composite2DPainter((64, 48)), tpt.Composite2DPainter((64, 48))
    a = pj.draw(*args, depth_labels=labels).copy()
    b = pt.draw(*args, depth_labels=labels).copy()
    np.testing.assert_array_equal(b, a)
    pj.save(str(tmp_path / "j.png"))
    pt.save(str(tmp_path / "t.png"))
    assert read(tmp_path / "t.png") == read(tmp_path / "j.png")
    if status == 0:
        assert (b[0, :, 0] == 255).all()      # the rejected frame's border


def test_composite3d_and_navigation(tmp_path):
    rng = np.random.RandomState(5)
    P_view = np.eye(4)
    P_view[2, 3] = 12.0
    pj = jpt.Composite3DPainter(P_view[:3], (96, 72))
    pt = tpt.Composite3DPainter(P_view[:3], (96, 72))
    pts = np.stack([np.linspace(-2, 2, 30), rng.uniform(-1, 1, 30),
                    np.full(30, 4.0)], 1)
    cols = rng.uniform(0, 255, 30)
    groups = rng.randint(0, 40, 30)
    for step, status in enumerate((1, 2, 0, 1, 2)):
        rvec = np.array([0.0, 0.02 * step, 0.0])
        tvec = np.array([-0.1 * step, 0.0, 0.0])
        if step == 3:
            for p in (pj, pt):
                p.zoom_in(2.0)
                p.rotate_z(0.3)
                p.move_left(0.5)
                p.move_up(0.25)
                p.switch_colors()
        a = pj.draw(rvec, tvec, status, pts, cols, groups,
                    neg_fy=step == 4).copy()
        b = pt.draw(rvec, tvec, status, pts, cols, groups,
                    neg_fy=step == 4).copy()
        np.testing.assert_array_equal(b, a)
        np.testing.assert_allclose(pt.cams_pos, pj.cams_pos, atol=1e-6)
        np.testing.assert_allclose(pt.cams_pos_keyfr, pj.cams_pos_keyfr,
                                   atol=1e-6)
    np.testing.assert_array_equal(pt.P, pj.P)
    assert len(pt.cams_pos) == 4 and len(pt.cams_pos_keyfr) == 2
    tpt.save_png(str(tmp_path / "t.png"), a)
    jpt.save_png(str(tmp_path / "j.png"), a)
    assert read(tmp_path / "t.png") == read(tmp_path / "j.png")
