"""Synthetic textured-plane sequence renderer (NumPy only).

A fully-known test world: texture on the z = plane_z plane, known camera
trajectory, closed-form init correspondences.  ``build_sequence`` and
``build_divergent_fleet`` construct the multi-agent throughput workload:
A independent agents with distinct textures, start offsets, turn rates and
velocities, so keyframes de-synchronize across the fleet.
``chessboard_texture``, ``chessboard_frame``, ``chessboard_scene``,
``board_view_poses`` and ``build_chessboard_sequence`` make chessboard
worlds for the calibration path and the chessboard bootstrap.
"""

import numpy as np

__all__ = ["make_texture", "render_plane_sequence", "backproject_to_plane",
           "sequence_poses", "build_sequence", "divergent_fleet_params",
           "build_divergent_fleet", "chessboard_texture", "chessboard_frame",
           "chessboard_scene", "board_view_poses",
           "build_chessboard_sequence"]


def make_texture(rng, size=1024, blur_passes=2):
    """Smooth random texture with dense gradient structure (float 0..255)."""
    tex = rng.rand(size // 4, size // 4) * 255.0
    tex = np.kron(tex, np.ones((4, 4)))
    k = np.array([1.0, 4.0, 6.0, 4.0, 1.0])
    k = np.outer(k, k)
    k /= k.sum()
    for _ in range(blur_passes):
        padded = np.pad(tex, 2, mode="wrap")
        out = np.zeros_like(tex)
        for i in range(5):
            for j in range(5):
                out += k[i, j] * padded[i:i + tex.shape[0],
                                        j:j + tex.shape[1]]
        tex = out
    return tex


def _bilinear_wrap(tex, x, y):
    h, w = tex.shape
    # float mod can return exactly w (huge inputs from rays grazing the
    # plane, tiny negatives) — re-fold and clamp before indexing
    x = np.mod(np.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0), w)
    y = np.mod(np.nan_to_num(y, nan=0.0, posinf=0.0, neginf=0.0), h)
    x = np.where(x >= w, x - w, x)
    y = np.where(y >= h, y - h, y)
    x0 = np.minimum(np.floor(x).astype(int), w - 1)
    y0 = np.minimum(np.floor(y).astype(int), h - 1)
    x1 = (x0 + 1) % w
    y1 = (y0 + 1) % h
    fx = x - x0
    fy = y - y0
    return ((1 - fy) * ((1 - fx) * tex[y0, x0] + fx * tex[y0, x1])
            + fy * ((1 - fx) * tex[y1, x0] + fx * tex[y1, x1]))


def render_plane_sequence(P_list, texture, size=(320, 240), f=280.0,
                          plane_z=4.0, tex_scale=64.0):
    """Render grayscale frames of the textured z=plane_z plane.

    P_list: [n, 4, 4] world-to-cam extrinsics. Returns imgs [n, H, W] f32.
    """
    W, H = size
    cx, cy = W / 2.0, H / 2.0
    us, vs = np.meshgrid(np.arange(W), np.arange(H))
    xn = (us - cx) / f
    yn = (vs - cy) / f
    d_cam = np.stack([xn, yn, np.ones_like(xn)], axis=-1)  # [H, W, 3]
    imgs = []
    for P in P_list:
        R = P[:3, :3]
        t = P[:3, 3]
        c = -R.T @ t                      # camera center in world
        d_world = d_cam @ R               # R^T applied to each ray
        s = (plane_z - c[2]) / d_world[..., 2]
        wx = c[0] + s * d_world[..., 0]
        wy = c[1] + s * d_world[..., 1]
        imgs.append(_bilinear_wrap(texture, wx * tex_scale,
                                   wy * tex_scale).astype(np.float32))
    return np.stack(imgs)


def backproject_to_plane(uv, P, f, c, plane_z=4.0):
    """Closed-form 3D points of pixels known to lie on z = plane_z."""
    uv = np.asarray(uv, dtype=np.float64)
    xn = (uv[:, 0] - c[0]) / f
    yn = (uv[:, 1] - c[1]) / f
    d_cam = np.stack([xn, yn, np.ones_like(xn)], axis=1)
    R = P[:3, :3]
    t = P[:3, 3]
    center = -R.T @ t
    d_world = d_cam @ R
    s = (plane_z - center[2]) / d_world[:, 2]
    return center[None, :] + s[:, None] * d_world


def sequence_poses(n_frames=33, ang_rate=0.05, vel=(1.2, 0.15, 0.2)):
    """[n, 4, 4] world-to-cam extrinsics of a camera that yaws by
    ``ang_rate`` rad and translates by ``vel`` over the run."""
    P_list = []
    for i in range(n_frames):
        frac = i / max(n_frames - 1, 1)
        ang = ang_rate * frac
        ca, sa = np.cos(ang), np.sin(ang)
        R = np.array([[ca, 0, sa], [0, 1, 0], [-sa, 0, ca]])
        center = np.array(vel) * frac
        P = np.eye(4)
        P[:3, :3] = R
        P[:3, 3] = -R @ center
        P_list.append(P)
    return np.stack(P_list)


def build_sequence(n_frames=33, size=(640, 480), f=500.0, plane_z=4.0,
                   seed=7, ang_rate=0.05, vel=(1.2, 0.15, 0.2),
                   tex_scale=64.0, frames=None):
    """One agent's sequence along ``sequence_poses``.  Returns (imgs
    [n, H, W] f32, P_list [n, 4, 4], f, size, plane_z).  ``frames`` (a
    slice) renders only those frames of the run, so one long sequence can be
    rendered in pieces."""
    tex = make_texture(np.random.RandomState(seed))
    P_list = sequence_poses(n_frames, ang_rate, vel)
    if frames is not None:
        P_list = P_list[frames]
    imgs = render_plane_sequence(P_list, tex, size=size, f=f,
                                 plane_z=plane_z, tex_scale=tex_scale)
    return imgs, P_list, f, size, plane_z


def divergent_fleet_params(A, n_frames=33, size=(640, 480), f=500.0,
                           plane_z=4.0):
    """``build_sequence`` keyword sets of A INDEPENDENT agents (seeds
    100 + a): distinct textures, turn rates and velocities."""
    params = []
    for a in range(A):
        sgn = 1.0 if a % 2 == 0 else -1.0
        params.append(dict(
            n_frames=n_frames, size=size, f=f, plane_z=plane_z,
            seed=100 + a, ang_rate=sgn * (0.03 + 0.015 * ((a * 7) % 5)),
            vel=(sgn * (0.8 + 0.12 * (a % 4)), 0.1 + 0.02 * (a % 3),
                 0.1 + 0.05 * ((a * 3) % 4))))
    return params


def build_divergent_fleet(A, n_frames=33, size=(640, 480), f=500.0,
                          plane_z=4.0):
    """The fleet as a list of ``build_sequence`` tuples (rendered one after
    the other; a caller in a hurry maps ``divergent_fleet_params`` over a
    process pool)."""
    return [build_sequence(**kw) for kw in
            divergent_fleet_params(A, n_frames, size, f, plane_z)]


def chessboard_texture(cols, rows, square=32, margin=32):
    """A board with (cols, rows) INNER corners — (cols + 1) x (rows + 1)
    squares of gray level 20 and 235, the top-left one dark — on a flat
    235 margin of ``margin`` pixels: [H, W] float.  Inner corner (c, r) lies at texture
    coordinate (margin + (c + 1) * square - 0.5, margin + (r + 1) * square
    - 0.5), pixel centres being integers (``render_plane_sequence``'s
    sampling)."""
    h = (rows + 1) * square + 2 * margin
    w = (cols + 1) * square + 2 * margin
    tex = np.full((h, w), 235.0)
    for r in range(rows + 1):
        for c in range(cols + 1):
            if (r + c) % 2 == 0:
                tex[margin + r * square:margin + (r + 1) * square,
                    margin + c * square:margin + (c + 1) * square] = 20.0
    return tex


def chessboard_frame(square, margin, tex_scale, plane_z, offset=(0, 0)):
    """The board frame of a ``chessboard_texture`` pasted at texture pixel
    ``offset`` (x, y) and rendered with ``tex_scale``: (T [4, 4] board ->
    world, square size in world units).  It is the frame of
    ``calib.zhang.grid_objp(board, square_size)``: origin at inner corner
    (0, 0), x along the board's rows (world +y), y along its columns (world
    +x), z = x cross y (world -z)."""
    o = (margin + square - 0.5) / tex_scale
    T = np.eye(4)
    T[:3, :3] = [[0.0, 1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, -1.0]]
    T[:3, 3] = [offset[0] / tex_scale + o, offset[1] / tex_scale + o,
                plane_z]
    return T, square / tex_scale


def chessboard_scene(board=(8, 6), square=24, margin=48, tex_size=1024,
                     tex_scale=64.0, plane_z=4.0):
    """A calibration scene: a ``chessboard_texture`` at the corner of a
    flat ``tex_size`` texture (wide enough that no second copy of the
    wrapping texture enters a view from nearby).  Returns (texture, T [4, 4]
    board -> world, square size in world units, the board's centre in the
    world: where ``board_view_poses`` aims)."""
    b = chessboard_texture(board[0], board[1], square, margin)
    tex = np.full((tex_size, tex_size), 235.0)
    tex[:b.shape[0], :b.shape[1]] = b
    T, sq = chessboard_frame(square, margin, tex_scale, plane_z)
    # the board's columns run along world x, its rows along world y
    centre = T[:3, 3] + np.array([(board[0] - 1) * sq / 2,
                                  (board[1] - 1) * sq / 2, 0.0])
    return tex, T, sq, centre


def board_view_poses(rng, n, center, distance, jitter=0.0):
    """[n, 4, 4] world-to-cam extrinsics of cameras aimed at ``center`` on
    the z = const plane from ``distance`` away, each tilted by a random
    angle of 10-30 degrees (random sign) about the camera's x and y axes,
    plus a roll of at most 5 degrees; the aim point moves by up to
    ``jitter`` world units in x and y.  Tilted views keep Zhang's system
    well posed (fronto-parallel ones make it degenerate)."""
    Ps = []
    lo, hi = np.deg2rad((10.0, 30.0))
    for _ in range(n):
        ax, ay = rng.uniform(lo, hi, 2) * rng.choice([-1.0, 1.0], 2)
        az = rng.uniform(-1.0, 1.0) * np.deg2rad(5.0)
        cx, sx = np.cos(ax), np.sin(ax)
        cy, sy = np.cos(ay), np.sin(ay)
        cz, sz = np.cos(az), np.sin(az)
        Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
        Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
        R = Rx @ Ry @ Rz                      # camera -> world
        aim = np.asarray(center, np.float64).copy()
        aim[:2] += rng.uniform(-jitter, jitter, 2)
        c = aim - distance * R[:, 2]
        P = np.eye(4)
        P[:3, :3] = R.T
        P[:3, 3] = -R.T @ c
        Ps.append(P)
    return np.stack(Ps)


def build_chessboard_sequence(n_frames=33, size=(640, 480), f=500.0,
                              plane_z=4.0, seed=7, ang_rate=0.05,
                              vel=(1.2, 0.15, 0.2), tex_scale=64.0,
                              board=(8, 6), square=20, margin=10,
                              frames=None):
    """``build_sequence`` with a ``chessboard_texture`` pasted into the
    random texture centred on the world origin, where frame 0 (the camera
    at the origin looking down +z) sees it whole.  The random texture keeps
    half its contrast about 128, so the board's saddles dominate
    the response map: ``find_chessboard_corners`` anchors the grid on the
    extreme candidates and fails when texture saddles pass its relative
    threshold.  Returns (imgs, P_list, T_board [4, 4] board -> world,
    square size in world units); ``frames`` (a slice) renders only those
    frames, as in ``build_sequence``."""
    tex = 128.0 + 0.5 * (make_texture(np.random.RandomState(seed)) - 128.0)
    b = chessboard_texture(board[0], board[1], square, margin)
    bh, bw = b.shape
    tex[:bh, :bw] = b
    tex = np.roll(tex, (-(bh // 2), -(bw // 2)), axis=(0, 1))
    P_list = sequence_poses(n_frames, ang_rate, vel)
    if frames is not None:
        P_list = P_list[frames]
    imgs = render_plane_sequence(P_list, tex, size=size, f=f,
                                 plane_z=plane_z, tex_scale=tex_scale)
    T, sq = chessboard_frame(square, margin, tex_scale, plane_z,
                             offset=(-(bw // 2), -(bh // 2)))
    return imgs, P_list, T, sq
