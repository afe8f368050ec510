"""Tiny closed-form linear algebra, batched elementwise.

Per-point 2x2/3x3/4x4 solves are cofactor formulas; the Jacobi eigensolver
and the Cholesky factorization are fully unrolled over the static size n.
The arithmetic (operation order included) is kept identical to the JAX
package's ``ops/linalg.py``: RANSAC minimal sets make the 12x12 DLT Gram
matrix exactly singular, so the shifted Cholesky is roundoff-sensitive and a
library solver would pick other hypotheses.  All routines broadcast over
leading batch dims.
"""

import functools

import numpy as np
import torch

from mqslam_tpu_torch.core.smallmat import (  # noqa: F401  (re-exported)
    gram, gram_rhs, matmul_small, matvec_small,
)

__all__ = [
    "gram", "gram_rhs", "matmul_small", "matvec_small",
    "solve2x2_sym", "solve3x3_sym", "inv3x3", "solve3x3", "pinv_solve_sym",
    "solve6x6_spd",
    "eigh4x4_smallest", "eigh_jacobi", "svdvals3x3",
    "cholesky_small", "cho_solve_small", "smallest_eigvec_spd",
]


def _clamp_det(det, eps):
    """Keep |det| >= eps, preserving sign (zero counts as positive)."""
    e = torch.full_like(det, eps)
    return torch.where(torch.abs(det) > eps, det,
                       torch.where(det >= 0, e, -e))


def solve2x2_sym(a00, a01, a11, b0, b1, eps=1e-30):
    """Solve the symmetric 2x2 system [[a00,a01],[a01,a11]] x = b."""
    det = _clamp_det(a00 * a11 - a01 * a01, eps)
    x0 = (a11 * b0 - a01 * b1) / det
    x1 = (a00 * b1 - a01 * b0) / det
    return x0, x1


def solve3x3_sym(N, rhs, eps=1e-30):
    """Solve symmetric 3x3 systems N @ x = rhs by the adjugate formula.

    N: [..., 3, 3] (assumed symmetric), rhs: [..., 3]. Near-singular systems
    get a clamped determinant (large-but-finite solutions; the caller filters
    via status flags)."""
    a, b, c = N[..., 0, 0], N[..., 0, 1], N[..., 0, 2]
    d, e, f = N[..., 1, 1], N[..., 1, 2], N[..., 2, 2]
    A = d * f - e * e
    B = c * e - b * f
    C = b * e - c * d
    D = a * f - c * c
    E = b * c - a * e
    F = a * d - b * b
    det = _clamp_det(a * A + b * B + c * C, eps)
    r0, r1, r2 = rhs[..., 0], rhs[..., 1], rhs[..., 2]
    x0 = (A * r0 + B * r1 + C * r2) / det
    x1 = (B * r0 + D * r1 + E * r2) / det
    x2 = (C * r0 + E * r1 + F * r2) / det
    return torch.stack([x0, x1, x2], dim=-1)


def inv3x3(M, eps=1e-30):
    """Inverse of general 3x3 matrices [..., 3, 3] via the adjugate."""
    m = M
    c00 = m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1]
    c01 = m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2]
    c02 = m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]
    c10 = m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2]
    c11 = m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0]
    c12 = m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1]
    c20 = m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1]
    c21 = m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2]
    c22 = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    det = (m[..., 0, 0] * c00 + m[..., 0, 1] * c01 + m[..., 0, 2] * c02)
    det = _clamp_det(det, eps)
    adjT = torch.stack([
        torch.stack([c00, c10, c20], dim=-1),
        torch.stack([c01, c11, c21], dim=-1),
        torch.stack([c02, c12, c22], dim=-1),
    ], dim=-2)
    return adjT / det[..., None, None]


def solve3x3(M, rhs, eps=1e-30):
    """Solve general 3x3 systems M @ x = rhs (Cramer via the adjugate)."""
    return matvec_small(inv3x3(M, eps), rhs)


def pinv_solve_sym(N, rhs, sweeps: int = 6, rcond: float = None):
    """Min-norm least-squares solve of symmetric systems by the eigen
    pseudo-inverse: x = V diag(1/w if |w| > rcond*|w|max else 0) V^T rhs
    (cv2.solve(..., DECOMP_SVD) semantics, rank-deficient systems
    included, where the adjugate formula would blow up)."""
    if rcond is None:
        rcond = 32.0 * torch.finfo(N.dtype).eps
    w, V = eigh_jacobi(N, sweeps=sweeps)
    wmax = torch.amax(torch.abs(w), dim=-1, keepdim=True)
    ok = torch.abs(w) > rcond * torch.clamp(wmax, min=1e-30)
    inv_w = torch.where(ok, 1.0 / torch.where(ok, w, torch.ones_like(w)),
                        torch.zeros_like(w))
    tmp = torch.sum(V * rhs[..., :, None], dim=-2)      # V^T rhs
    return matvec_small(V, inv_w * tmp)


def solve6x6_spd(N, rhs, eps=1e-30):
    """Solve symmetric positive-definite 6x6 systems N @ x = rhs closed-form
    via 3x3 block elimination (Schur complement on the lower-right block):

        [[A, B], [B^T, D]] [x0, x1] = [r0, r1]
        S = D - B^T A^{-1} B;  x1 = S^{-1} (r1 - B^T A^{-1} r0);
        x0 = A^{-1} (r0 - B x1)

    Requires N SPD (callers add Levenberg damping)."""
    A = N[..., :3, :3]
    B = N[..., :3, 3:]
    D = N[..., 3:, 3:]
    r0, r1 = rhs[..., :3], rhs[..., 3:]
    Ainv = inv3x3(A, eps)
    AinvB = matmul_small(Ainv, B)
    S = D - matmul_small(B.transpose(-1, -2), AinvB)
    Ainv_r0 = matvec_small(Ainv, r0)
    rhs1 = r1 - torch.sum(B * Ainv_r0[..., :, None], dim=-2)  # B^T A^-1 r0
    x1 = solve3x3_sym(0.5 * (S + S.transpose(-1, -2)), rhs1, eps)
    x0 = Ainv_r0 - matvec_small(AinvB, x1)
    return torch.cat([x0, x1], dim=-1)


def _round_robin_rounds(n):
    """Tournament pairing: (n-1 if even else n) rounds of disjoint (p, q)
    pairs covering every pair exactly once per cycle."""
    m = n if n % 2 == 0 else n + 1
    players = list(range(m))
    rounds = []
    for _ in range(m - 1):
        pairs = []
        for i in range(m // 2):
            a, b = players[i], players[m - 1 - i]
            if a < n and b < n:
                pairs.append((min(a, b), max(a, b)))
        rounds.append(pairs)
        players = [players[0]] + [players[-1]] + players[1:-1]
    return rounds


@functools.lru_cache(maxsize=None)
def _jacobi_round_consts(n, dtype, device):
    """Static one-hot tensors per tournament round: selectors for the pivot
    entries (p,p)/(q,q)/(p,q) and the skeleton of the rotation matrix G.
    Cached per (n, dtype, device)."""
    consts = []
    for pairs in _round_robin_rounds(n):
        k = len(pairs)
        Epp = np.zeros((k, n, n), np.float64)
        Eqq = np.zeros((k, n, n), np.float64)
        Epq = np.zeros((k, n, n), np.float64)
        Spq = np.zeros((k, n, n), np.float64)
        base = np.eye(n)
        for i, (p, q) in enumerate(pairs):
            Epp[i, p, p] = 1.0
            Eqq[i, q, q] = 1.0
            Epq[i, p, q] = 1.0
            Spq[i, p, q] = 1.0
            Spq[i, q, p] = -1.0
            base[p, p] = 0.0
            base[q, q] = 0.0
        consts.append(tuple(
            torch.as_tensor(a, dtype=dtype, device=device)
            for a in (Epp, Eqq, Epq, Epp + Eqq, Spq, base)))
    return tuple(consts)


def eigh_jacobi(S, sweeps: int = 8):
    """Eigendecomposition of small symmetric matrices by parallel-ordering
    Jacobi.

    S: [..., n, n] symmetric, n small & static. Returns (eigenvalues [..., n]
    ascending, eigenvectors [..., n, n], columns as vectors).

    Each tournament round rotates all floor(n/2) disjoint pivot pairs at
    once; pivot extraction and rotation assembly are static one-hot broadcast
    contractions and the two-sided update is broadcast multiply + sum.  A
    fixed number of sweeps keeps the result independent of the batch."""
    n = S.shape[-1]
    consts = _jacobi_round_consts(n, S.dtype, S.device)

    def one_round(A, V, cc):
        Epp, Eqq, Epq, CM, SM, base = cc
        Ab = A[..., None, :, :]  # [..., 1, n, n]
        app = torch.sum(Ab * Epp, dim=(-2, -1))  # [..., k]
        aqq = torch.sum(Ab * Eqq, dim=(-2, -1))
        apq = torch.sum(Ab * Epq, dim=(-2, -1))
        zero_pq = apq == 0
        tau = (aqq - app) / (2.0 * torch.where(zero_pq,
                                               torch.ones_like(apq), apq))
        t = torch.sign(tau) / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
        t = torch.where(zero_pq, torch.zeros_like(t), t)
        c = 1.0 / torch.sqrt(1.0 + t * t)
        s = t * c
        G = (base
             + torch.sum(c[..., None, None] * CM, dim=-3)
             + torch.sum(s[..., None, None] * SM, dim=-3))
        GT = G.transpose(-1, -2)
        A = matmul_small(GT, matmul_small(A, G))
        V = matmul_small(V, G)
        return A, V

    A = S
    V = torch.eye(n, dtype=S.dtype, device=S.device).expand(S.shape)
    for _ in range(sweeps):
        for cc in consts:
            A, V = one_round(A, V, cc)
    w = torch.diagonal(A, dim1=-2, dim2=-1)
    order = torch.argsort(w, dim=-1, stable=True)
    w = torch.gather(w, -1, order)
    V = torch.gather(V, -1, order[..., None, :].expand(V.shape))
    return w, V


def eigh4x4_smallest(S, sweeps: int = 8):
    """Unit eigenvector of the smallest eigenvalue of symmetric 4x4 systems
    (the DLT null-space extractor: argmin_{|x|=1} x^T S x)."""
    _, V = eigh_jacobi(S, sweeps=sweeps)
    return V[..., :, 0]


def svdvals3x3(M, sweeps: int = 10):
    """Singular values (descending) of 3x3 matrices via eigh of M^T M."""
    w, _ = eigh_jacobi(gram(M), sweeps=sweeps)
    w = torch.clamp(w, min=0.0)
    return torch.sqrt(torch.flip(w, dims=(-1,)))


def cholesky_small(S, eps=1e-30):
    """Cholesky factor of small static-n SPD matrices, fully unrolled.

    S: [..., n, n]. Returns lower-triangular L as [..., n, n]. Every entry is
    a static-index elementwise expression over the batch."""
    n = S.shape[-1]
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = S[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(torch.clamp(s, min=eps))
        inv_d = 1.0 / L[j][j]
        for i in range(j + 1, n):
            s = S[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d
    zero = torch.zeros_like(S[..., 0, 0])
    rows = [torch.stack([L[i][j] if j <= i else zero for j in range(n)],
                        dim=-1) for i in range(n)]
    return torch.stack(rows, dim=-2)


def cho_solve_small(L, b):
    """Solve L L^T x = b for small static-n lower-triangular L (unrolled
    forward + back substitution). L: [..., n, n], b: [..., n]."""
    n = L.shape[-1]
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[..., i, k] * y[k]
        y[i] = s / L[..., i, i]
    x = [None] * n
    for i in range(n - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[..., k, i] * x[k]
        x[i] = s / L[..., i, i]
    return torch.stack(x, dim=-1)


def smallest_eigvec_spd(S, iters: int = 3, shift: float = 1e-5):
    """Unit eigenvector of the smallest eigenvalue of a small symmetric PSD
    matrix, by shifted inverse iteration.

    S: [..., n, n]. One unrolled Cholesky of S + shift*mean(diag)*I, then
    ``iters`` triangular solves. Built for DLT null-space extraction
    (ops/pnp.py): RANSAC minimal sets make S exactly singular, so the shift
    dominates the smallest eigenvalue and one solve already aligns with the
    null space; overdetermined LS systems converge at rate
    (lam_min + shift)/(lam_2 + shift) per iteration."""
    n = S.shape[-1]
    mean_diag = torch.diagonal(S, dim1=-2, dim2=-1).sum(-1) / n
    Sd = S + (shift * torch.clamp(mean_diag, min=1e-30))[..., None, None] \
        * torch.eye(n, dtype=S.dtype, device=S.device)
    L = cholesky_small(Sd)
    x = torch.ones(S.shape[:-1], dtype=S.dtype, device=S.device)
    for _ in range(iters):
        x = cho_solve_small(L, x)
        x = x / torch.clamp(
            torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-30)
    return x
