"""Factor residuals and their Jacobians for the BA solver.

Residual conventions follow GTSAM's factors: GenericProjectionFactor over
Cal3DS2 (pixel residual, isotropic sigma), BetweenFactor<Pose3> (6-dof
residual, diagonal sigmas ordered rotation xyz then translation xyz) and
priors.  The Between / prior rotation residual is the SO(3) log of the
rotation discrepancy, the translation discrepancy is taken directly.

Poses are cam-to-world (rvec, tvec) 6-vectors, differentiated in the
body-frame chart of ``retract_single``.  Every function broadcasts over
leading batch dims.  The JAX package forms the Jacobians as
``vmap(jacfwd(...))`` of the residuals; here they are written out in closed
form (the chain rule through the same operations, the SO(3) log's by its
inverse Jacobians): ``torch.func.vmap(torch.func.jacfwd(...))`` of the same
residuals gives the same numbers but turns a linearization into ~10,000
small operations: 7-8.7x slower for the five Jacobians on an H100
(``chip_smoke.py``'s ``ba`` phase, ``PERF.md``).
"""

import torch

from mqslam_tpu_torch.core import camera as cam_mod, so3
from mqslam_tpu_torch.core.smallmat import matmul_small, matvec_small

__all__ = [
    "retract_single", "obs_residual", "obs_residual_jac",
    "odo_residual", "odo_residual_jac",
    "prior_pose_residual", "prior_pose_residual_jac",
]


def retract_single(pose6, delta6):
    """Manifold retraction: R' = R Exp(dr), c' = c + R dt (body-frame
    chart).  Returns (R' [..., 3, 3], c' [..., 3])."""
    R = so3.exp(pose6[..., :3])
    Rn = matmul_small(R, so3.exp(delta6[..., :3]))
    c = pose6[..., 3:] + matvec_small(R, delta6[..., 3:])
    return Rn, c


def _guard_z(z):
    return torch.where(torch.abs(z) > 1e-9, z, 1e-9)


def _obs_residual_single(delta6, pose6, point, uv, cal9, inv_sigma):
    """Whitened pixel reprojection residual [..., 2] at a body-frame pose
    increment ``delta6`` (zeros at the linearization point)."""
    R, center = retract_single(pose6, delta6)            # cam-to-world
    Xc = matvec_small(R.transpose(-1, -2), point - center)   # world -> cam
    xn = Xc[..., :2] / _guard_z(Xc[..., 2])[..., None]
    cal = cam_mod.Cal3DS2.from_array(cal9)
    proj = cam_mod.denormalize_points(cam_mod.distort_normalized(xn, cal),
                                      cal)
    # behind-camera observations get a large but smooth residual through
    # the z guard; invalid factors are masked by the caller
    return (proj - uv) * inv_sigma


def obs_residual(p6, pts, uv, cal, inv_sig):
    """[O, 2] whitened residuals; ``inv_sig`` is [O, 1]."""
    return _obs_residual_single(torch.zeros_like(p6), p6, pts, uv, cal,
                                inv_sig)


def obs_residual_jac(p6, pts, uv, cal, inv_sig):
    """Jacobians of ``obs_residual`` wrt (body-frame pose increment [O, 2,
    6], point [O, 2, 3]), in closed form at the linearization point:

        dXc/d(dr) = [Xc]_x,  dXc/d(dt) = -I,  dXc/dX = R^T,

    then the guarded perspective division, the DS2 distortion and K, each
    differentiated as ``jacfwd`` differentiates them (the z guard has no
    derivative where it holds)."""
    R = so3.exp(p6[..., :3])
    Rt = R.transpose(-1, -2)
    Xc = matvec_small(Rt, pts - p6[..., 3:])
    X, Y, Z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    live = torch.abs(Z) > 1e-9
    zg = torch.where(live, Z, 1e-9)
    x, y = X / zg, Y / zg
    iz = 1.0 / zg
    dz = torch.where(live, iz, 0.0)
    zero = torch.zeros_like(x)
    # d(x, y)/dXc [.., 2, 3]
    N = torch.stack([torch.stack([iz, zero, -x * dz], -1),
                     torch.stack([zero, iz, -y * dz], -1)], -2)
    cal = cam_mod.Cal3DS2.from_array(cal)
    r2 = x * x + y * y
    radial = 1.0 + r2 * (cal.k1 + r2 * cal.k2)
    drad = cal.k1 + 2.0 * r2 * cal.k2                    # d radial / d r2
    p1, p2 = cal.p1, cal.p2
    d00 = radial + 2.0 * x * x * drad + 2.0 * p1 * y + 6.0 * p2 * x
    d01 = 2.0 * x * y * drad + 2.0 * p1 * x + 2.0 * p2 * y   # = d10
    d11 = radial + 2.0 * y * y * drad + 6.0 * p1 * y + 2.0 * p2 * x
    s = inv_sig[..., 0]
    # K @ D, whitened [.., 2, 2]
    KD = torch.stack([
        torch.stack([(cal.fx * d00 + cal.s * d01) * s,
                     (cal.fx * d01 + cal.s * d11) * s], -1),
        torch.stack([cal.fy * d01 * s, cal.fy * d11 * s], -1)], -2)
    Jx = matmul_small(KD, N)                             # d r / d Xc
    J_pose = torch.cat([matmul_small(Jx, so3.hat(Xc)), -Jx], dim=-1)
    J_point = matmul_small(Jx, Rt)
    return J_pose, J_point


def _jr_inv(phi):
    """Inverse right Jacobian of SO(3) at rotation vector(s) phi [..., 3]:
    d log(Exp(phi) Exp(d)) / dd at d = 0,

        I + [phi]_x / 2 + (1/t^2 - (1 + cos t) / (2 t sin t)) [phi]_x^2,

    the coefficient by its series below t = 0.5 (the closed form cancels
    there in float32).  The inverse left Jacobian is ``_jr_inv(-phi)``."""
    t2 = torch.sum(phi * phi, dim=-1)
    t = torch.sqrt(torch.clamp(t2, min=0.25))
    exact = 1.0 / (t * t) - (1.0 + torch.cos(t)) / (2.0 * t * torch.sin(t))
    series = 1.0 / 12.0 + t2 / 720.0 + t2 * t2 / 30240.0
    c = torch.where(t2 < 0.25, series, exact)
    K = so3.hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye + 0.5 * K + c[..., None, None] * matmul_small(K, K)


def _blocks(a, b, c, d):
    """[..., 6, 6] from four [..., 3, 3] blocks [[a, b], [c, d]]."""
    return torch.cat([torch.cat([a, b], -1), torch.cat([c, d], -1)], -2)


def _odo_residual_single(df6, dt6, pose6_from, pose6_to, meas_r, meas_t,
                         inv_sigma6):
    """Whitened BetweenFactor residual [..., 6]: rotation log, then the
    translation delta."""
    Rf, cf = retract_single(pose6_from, df6)
    Rt, ct = retract_single(pose6_to, dt6)
    RfT = Rf.transpose(-1, -2)
    Rd = matmul_small(RfT, Rt)
    td = matvec_small(RfT, ct - cf)
    Rm = so3.exp(meas_r)
    r_rot = so3.log(matmul_small(Rm.transpose(-1, -2), Rd))
    return torch.cat([r_rot, td - meas_t], dim=-1) * inv_sigma6


def odo_residual(p6f, p6t, meas_r, meas_t, inv_sig):
    z = torch.zeros_like(p6f)
    return _odo_residual_single(z, z, p6f, p6t, meas_r, meas_t, inv_sig)


def odo_residual_jac(p6f, p6t, meas_r, meas_t, inv_sig):
    """Jacobians wrt the (from, to) body-frame increments, [Q, 6, 6] each,
    in closed form.  With E = Rm^T Rf^T Rt and phi = log E, the rotation
    rows are -Jl^-1(phi) Rm^T (from) and Jr^-1(phi) (to); the translation
    rows, td = Rf^T (ct - cf), are [td]_x and -I (from) and Rf^T Rt (to)."""
    Rf, Rt, Rm = so3.exp(p6f[..., :3]), so3.exp(p6t[..., :3]), so3.exp(meas_r)
    RfT = Rf.transpose(-1, -2)
    RfT_Rt = matmul_small(RfT, Rt)
    phi = so3.log(matmul_small(Rm.transpose(-1, -2), RfT_Rt))
    td = matvec_small(RfT, p6t[..., 3:] - p6f[..., 3:])
    zero = torch.zeros_like(Rf)
    eye = torch.eye(3, dtype=p6f.dtype, device=p6f.device).expand_as(Rf)
    J_from = _blocks(-matmul_small(_jr_inv(-phi), Rm.transpose(-1, -2)),
                     zero, so3.hat(td), -eye)
    J_to = _blocks(_jr_inv(phi), zero, zero, RfT_Rt)
    w = inv_sig[..., :, None]
    return J_from * w, J_to * w


def _prior_pose_residual_single(delta6, pose6, prior_r, prior_t,
                                inv_sigma6):
    Rp = so3.exp(prior_r)
    R, c = retract_single(pose6, delta6)
    r_rot = so3.log(matmul_small(Rp.transpose(-1, -2), R))
    return torch.cat([r_rot, c - prior_t], dim=-1) * inv_sigma6


def prior_pose_residual(p6, prior_r, prior_t, inv_sig):
    return _prior_pose_residual_single(torch.zeros_like(p6), p6, prior_r,
                                       prior_t, inv_sig)


def prior_pose_residual_jac(p6, prior_r, prior_t, inv_sig):
    """Jacobian wrt the body-frame increment, [Rp, 6, 6], in closed form:
    Jr^-1(log(Rp^T R)) for the rotation rows, R for the translation rows."""
    R, Rp = so3.exp(p6[..., :3]), so3.exp(prior_r)
    phi = so3.log(matmul_small(Rp.transpose(-1, -2), R))
    zero = torch.zeros_like(R)
    return _blocks(_jr_inv(phi), zero, zero, R) * inv_sig[..., :, None]
