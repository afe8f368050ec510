"""Plain two-view and pose geometry for the front-end's reference.

Written for the benchmark from the textbook problems the tracker solves,
not copied from the program: the pose of a calibrated pinhole camera by
Gauss-Newton on the squared pixel reprojection error over a given set of
2D-3D pairs (``mqslam_tpu_torch/ops/pnp.py::pnp_refine`` minimises the same
cost), and the two-view triangulation that minimises the squared
reprojection error in normalised coordinates of both views (the optimum
``ops/triangulation.py::optimal`` reaches in closed form, by Hartley and
Sturm's correction).  Batched over a leading dimension, in the dtype of the
inputs: the reference runs in float64, the lower-precision control in
bfloat16 (products and sums in bfloat16, the 6x6 / 3x3 solves in float32,
which ``torch.linalg`` needs).  Imports nothing of the program.
"""

import torch

__all__ = ["rodrigues", "project", "pose_gauss_newton", "triangulate"]


def _hat(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([z, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], z, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def rodrigues(rvec):
    """Rotation matrices [..., 3, 3] of rotation vectors [..., 3]."""
    th2 = (rvec * rvec).sum(-1)
    th = torch.sqrt(torch.clamp(th2, min=1e-30))
    small = th2 < 1e-12
    one = torch.ones_like(th2)
    # (tensor branches: a Python number in ``torch.where`` turns a forward
    # derivative into float64)
    a = torch.where(small, one - th2 / 6, torch.sin(th) / th)
    b = torch.where(small, 0.5 * one - th2 / 24,
                    (one - torch.cos(th)) / torch.clamp(th2, min=1e-30))
    K = _hat(rvec)
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


def project(R, t, X, K4):
    """Pixels [..., n, 2] of world points X [..., n, 3] seen by the
    world-to-camera pose (R [..., 3, 3], t [..., 3]); K4 = (fx, fy, cx,
    cy)."""
    Xc = (R[..., None, :, :] @ X[..., :, :, None])[..., 0] + t[..., None, :]
    z = Xc[..., 2]
    return torch.stack([K4[0] * Xc[..., 0] / z + K4[2],
                        K4[1] * Xc[..., 1] / z + K4[3]], -1)


def _solve(H, b):
    """H x = b in float32 at least (``torch.linalg`` has no bfloat16), with
    1e-6 of H's mean diagonal (and 1e-12) added to its diagonal: solvable
    where points are few; the fixed point (zero gradient) is the same."""
    dt = H.dtype
    wide = torch.float32 if dt in (torch.bfloat16, torch.float16) else dt
    H = H.to(wide)
    d = torch.diagonal(H, dim1=-2, dim2=-1).mean(-1)
    H = H + (1e-6 * d + 1e-12)[..., None, None] * torch.eye(
        H.shape[-1], dtype=wide, device=H.device)
    x = torch.linalg.solve(H, b.to(wide)[..., None])[..., 0]
    return x.to(dt)


def pose_gauss_newton(X, uv, w, R0, t0, K4, iters=15):
    """World-to-camera (R, t) minimising sum |project - uv|^2 over the
    points where w > 0 (X [B, n, 3], uv [B, n, 2], w [B, n]), from (R0, t0);
    a left-multiplied rotation increment and an additive translation."""
    R, t = R0.clone(), t0.clone()
    fx, fy = K4[0], K4[1]
    for _ in range(iters):
        Xc = (R[:, None] @ X[..., None])[..., 0] + t[:, None]
        x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
        z = torch.where(z.abs() > 1e-9, z, torch.full_like(z, 1e-9))
        r = torch.stack([fx * x / z + K4[2] - uv[..., 0],
                         fy * y / z + K4[3] - uv[..., 1]], -1)
        zero = torch.zeros_like(z)
        dpi = torch.stack([
            torch.stack([fx / z, zero, -fx * x / (z * z)], -1),
            torch.stack([zero, fy / z, -fy * y / (z * z)], -1)], -2)
        # d Xc / d(omega) = -[Xc - t]x, d Xc / d t = I
        dw = -_hat(Xc - t[:, None])
        # masked by selection, not by product: a dummy point's huge (in
        # bfloat16 infinite) terms must not turn into NaN
        on = w > 0
        J = torch.where(on[..., None, None], torch.cat([dpi @ dw, dpi], -1),
                        torch.zeros((), dtype=w.dtype, device=w.device))
        Jf = J.reshape(J.shape[0], -1, 6)
        rf = torch.where(on[..., None], r, torch.zeros(
            (), dtype=w.dtype, device=w.device)).reshape(r.shape[0], -1)
        H = Jf.transpose(1, 2) @ Jf
        g = (Jf.transpose(1, 2) @ rf[..., None])[..., 0]
        d = -_solve(H, g)
        R = rodrigues(d[:, :3]) @ R
        t = t + d[:, 3:]
    return R, t


def triangulate(x1, R1, t1, x2, R2, t2, iters=10):
    """3D points [B, 3] minimising the squared normalised reprojection
    error of x1, x2 [B, 2] (normalised image coordinates) in two views with
    world-to-camera poses (R [B, 3, 3], t [B, 3]); the linear (DLT)
    solution refined by Gauss-Newton."""
    def rows(x, R, t):
        P = torch.cat([R, t[..., None]], -1)                     # [B, 3, 4]
        return torch.stack([x[:, 0:1] * P[:, 2] - P[:, 0],
                            x[:, 1:2] * P[:, 2] - P[:, 1]], 1)
    A = torch.cat([rows(x1, R1, t1), rows(x2, R2, t2)], 1)      # [B, 4, 4]
    wide = torch.float64 if A.dtype == torch.float64 else torch.float32
    _, _, Vh = torch.linalg.svd(A.to(wide))
    h = Vh[:, -1]
    X = (h[:, :3] / h[:, 3:4]).to(x1.dtype)
    for _ in range(iters):
        Js, rs = [], []
        for x, R, t in ((x1, R1, t1), (x2, R2, t2)):
            Xc = (R @ X[..., None])[..., 0] + t
            z = Xc[:, 2:3]
            rs.append(Xc[:, :2] / z - x)
            dpi = torch.cat([torch.eye(2, dtype=X.dtype, device=X.device)
                             .expand(X.shape[0], 2, 2) / z[..., None],
                             (-Xc[:, :2] / (z * z))[..., None]], -1)
            Js.append(dpi @ R)
        J = torch.cat(Js, 1)
        r = torch.cat(rs, 1)
        H = J.transpose(1, 2) @ J
        g = (J.transpose(1, 2) @ r[..., None])[..., 0]
        X = X - _solve(H, g)
    return X
