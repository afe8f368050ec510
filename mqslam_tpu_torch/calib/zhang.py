"""Zhang-style camera calibration from planar (chessboard) views.

Replaces ``cv2.calibrateCamera`` in the reference's intrinsics workflow
(reference: Work/calibration/application/calibrate.py:27-57
calibrate_camera_interactive; board model Work/python_libs/
calibration_tools.py:7-20 grid_objp): per-view plane homographies give the
image of the absolute conic (closed-form K), extrinsics follow from the
homography decomposition, distortion initializes to zero, and a joint
Levenberg-Marquardt refinement over (intrinsics, distortion, per-view poses)
minimizes pixel reprojection — all batched tensor code on one device.
"""

import numpy as np
import torch

from mqslam_tpu_torch import resolve_device
from mqslam_tpu_torch.core import camera as cam_mod, so3
from mqslam_tpu_torch.ops import homography as homog, linalg

__all__ = ["grid_objp", "calibrate_camera",
           "calibrate_camera_from_images"]


def grid_objp(board_size, scale=1.0):
    """Chessboard-corner object points, ordering of calibration_tools.py:7-20:
    (0,0,0), (0,1,0), ..., iterating boardSize[1] as x, boardSize[0] as y."""
    pts = [(float(i), float(j), 0.0)
           for i in range(board_size[1])
           for j in range(board_size[0])]
    return np.asarray(pts, dtype=np.float64) * scale


def _intrinsics_from_homographies(Hs):
    """Closed-form K from >=3 plane homographies (Zhang's B-matrix system).

    Hs: [V, 3, 3] pixel-space homographies from plane (x, y) coords."""
    def v_ij(H, i, j):
        h_i, h_j = H[:, :, i], H[:, :, j]
        return torch.stack([
            h_i[:, 0] * h_j[:, 0],
            h_i[:, 0] * h_j[:, 1] + h_i[:, 1] * h_j[:, 0],
            h_i[:, 1] * h_j[:, 1],
            h_i[:, 2] * h_j[:, 0] + h_i[:, 0] * h_j[:, 2],
            h_i[:, 2] * h_j[:, 1] + h_i[:, 1] * h_j[:, 2],
            h_i[:, 2] * h_j[:, 2],
        ], dim=1)  # [V, 6]

    rows = torch.cat([
        v_ij(Hs, 0, 1),
        v_ij(Hs, 0, 0) - v_ij(Hs, 1, 1),
    ], dim=0)  # [2V, 6]
    S = linalg.gram(rows)
    _, V = linalg.eigh_jacobi(S, sweeps=10)
    B11, B12, B22, B13, B23, B33 = V[:, 0]
    v0 = (B12 * B13 - B11 * B23) / (B11 * B22 - B12 ** 2)
    lam = B33 - (B13 ** 2 + v0 * (B12 * B13 - B11 * B23)) / B11
    alpha = torch.sqrt(torch.abs(lam / B11))
    beta = torch.sqrt(torch.abs(lam * B11 / (B11 * B22 - B12 ** 2)))
    gamma = -B12 * alpha ** 2 * beta / lam
    u0 = gamma * v0 / beta - B13 * alpha ** 2 / lam
    return alpha, beta, gamma, u0, v0


def _extrinsics_from_H(H, K_inv):
    """Per-view (rvec, tvec) from plane homography: [r1 r2 t] ~ K^-1 H."""
    A = linalg.matmul_small(K_inv, H)
    a1, a2, a3 = A[..., :, 0], A[..., :, 1], A[..., :, 2]
    s = torch.sqrt(torch.clamp(torch.linalg.norm(a1, dim=-1)
                               * torch.linalg.norm(a2, dim=-1), min=1e-30))
    sign = torch.where(a3[..., 2] >= 0, 1.0, -1.0)
    a1 = a1 * (sign / s)[..., None]
    a2 = a2 * (sign / s)[..., None]
    t = a3 * (sign / s)[..., None]
    r3 = torch.linalg.cross(a1, a2)
    M = torch.stack([a1, a2, r3], dim=-1)
    w3, V3 = linalg.eigh_jacobi(linalg.gram(M), sweeps=8)
    s_inv = 1.0 / torch.sqrt(torch.clamp(w3, min=1e-20))
    VsV = linalg.matmul_small(V3 * s_inv[..., None, :], V3.transpose(-1, -2))
    R = linalg.matmul_small(M, VsV)
    return so3.log(R), t


def _reproj_residual(params, objp, uv, n_views):
    """params: [4 + 4 + 6V] = fx, fy, u0, v0, k1, k2, p1, p2, per-view
    (rvec, tvec). objp [N, 3] shared board points; uv [V, N, 2]."""
    fx, fy, u0, v0 = params[0], params[1], params[2], params[3]
    dist = params[4:8]
    cal = cam_mod.Cal3DS2(fx, fy, torch.zeros_like(fx), u0, v0,
                          dist[0], dist[1], dist[2], dist[3])
    pose = params[8:].reshape(n_views, 6)
    R = so3.exp(pose[:, :3])                      # [V, 3, 3]
    Xc = (torch.sum(R[:, None] * objp[None, :, None, :], dim=-1)
          + pose[:, None, 3:])
    z = torch.where(torch.abs(Xc[..., 2]) > 1e-9, Xc[..., 2],
                    torch.full_like(Xc[..., 2], 1e-9))
    xn = Xc[..., :2] / z[..., None]
    xd = cam_mod.distort_normalized(xn, cal)
    proj = cam_mod.denormalize_points(xd, cal)
    return (proj - uv).reshape(-1)


def _jacobian(params, objp, uv, n_views):
    """d residual / d params [2VN, 8 + 6V], forward mode over the residual
    as written (the JAX package's ``jax.jacfwd``)."""
    J = torch.func.jacfwd(_reproj_residual)(params, objp, uv, n_views)
    return J.to(params.dtype)


def _lm_step(params, lam, objp, uv, n_views):
    """One damped step, accepted or rejected on the device (no host read):
    (params, lam) -> (params', lam')."""
    r = _reproj_residual(params, objp, uv, n_views)
    J = _jacobian(params, objp, uv, n_views)
    JtJ = linalg.gram(J[None])[0]
    Jtr = torch.sum(J * r[:, None], dim=0)
    d = torch.diagonal(JtJ)
    H = JtJ + lam * torch.diag(torch.clamp(d, min=1e-9))
    delta = torch.linalg.solve(H, -Jtr)
    new_params = params + delta
    new_cost = torch.sum(_reproj_residual(new_params, objp, uv,
                                          n_views) ** 2)
    old_cost = torch.sum(r ** 2)
    good = new_cost < old_cost
    params = torch.where(good, new_params, params)
    lam = torch.where(good, lam * 0.5, lam * 4.0)
    return params, lam


def _refine(params0, objp, uv, n_views, iters=20, damping=1e-4):
    lam = torch.tensor(damping, dtype=torch.float32, device=params0.device)
    params = params0
    for _ in range(iters):
        params, lam = _lm_step(params, lam, objp, uv, n_views)
    return params


def calibrate_camera(obj_points, img_points, image_size, refine_iters=25,
                     device=None):
    """Calibrate intrinsics + distortion from V chessboard views.

    obj_points: [N, 3] board points (z=0 plane, shared across views);
    img_points: [V, N, 2] detected corners.  Returns (cameraMatrix [3,3],
    distCoeffs [4], rvecs [V,3], tvecs [V,3], rms_error) as NumPy float64 —
    the cv2.calibrateCamera contract the reference relies on
    (calibrate.py:52).  Runs on ``device`` (None: the CUDA device) and
    reads the result back once."""
    device = resolve_device(device)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32)).to(device)
    objp = f32(obj_points)
    uv = f32(img_points)
    n_views = uv.shape[0]

    Hs = homog.fit_homography(
        objp[None, :, :2].expand((n_views,) + objp.shape[:1] + (2,)), uv)
    alpha, beta, gamma, u0, v0 = _intrinsics_from_homographies(Hs)
    zero, one = torch.zeros_like(alpha), torch.ones_like(alpha)
    K = torch.stack([
        torch.stack([alpha, zero, u0]),
        torch.stack([zero, beta, v0]),
        torch.stack([zero, zero, one]),
    ])
    K_inv = linalg.inv3x3(K)
    rvecs, tvecs = _extrinsics_from_H(Hs, K_inv)

    params0 = torch.cat([
        torch.stack([alpha, beta, u0, v0]),
        torch.zeros(4, dtype=torch.float32, device=device),
        torch.cat([rvecs, tvecs], dim=1).reshape(-1)])
    params = _refine(params0, objp, uv, n_views, iters=refine_iters)

    r = _reproj_residual(params, objp, uv, n_views)
    rms = torch.sqrt(torch.mean(torch.sum(r.reshape(-1, 2) ** 2, dim=1)))
    host = torch.cat([params, rms[None]]).cpu().numpy()
    fx, fy, u0r, v0r = (float(v) for v in host[:4])
    dist = host[4:8].astype(np.float64)
    pose = host[8:-1].astype(np.float64).reshape(n_views, 6)
    Kout = np.array([[fx, 0, u0r], [0, fy, v0r], [0, 0, 1.0]])
    return Kout, dist, pose[:, :3], pose[:, 3:], float(host[-1])


def calibrate_camera_from_images(images, board_size, square_size=1.0,
                                 refine_iters=25, device=None):
    """Full calibration from raw grayscale images: chessboard corners are
    detected and subpixel-refined per view (ops/chessboard), then Zhang's
    method runs on the successful views.

    The calibrate_camera_interactive flow of the reference
    (calibrate.py:27-57).  ``board_size`` = (cols, rows).  Returns
    (cameraMatrix, distCoeffs, rvecs, tvecs, rms, used) where ``used`` is
    the boolean per-image detection-success mask.  Runs on ``device``
    (None: the CUDA device)."""
    from mqslam_tpu_torch.ops import chessboard as cb

    device = resolve_device(device)
    img_points = []
    used = []
    shape = None
    for img in images:
        img = np.asarray(img, np.float32)
        shape = img.shape
        ok, corners = cb.find_chessboard_corners(img, board_size,
                                                 device=device)
        used.append(bool(ok))
        if ok:
            img_points.append(corners)
    if len(img_points) < 3:
        raise ValueError(
            f"chessboard detected in only {len(img_points)} images; "
            "Zhang's method needs >= 3 views")
    objp = grid_objp(board_size, scale=square_size)
    K, dist, rvecs, tvecs, rms = calibrate_camera(
        objp, np.stack(img_points), (shape[1], shape[0]),
        refine_iters=refine_iters, device=device)
    return K, dist, rvecs, tvecs, rms, np.asarray(used)
