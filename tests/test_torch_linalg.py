"""mqslam_tpu_torch.ops.linalg against mqslam_tpu.ops.linalg on the CPU.

Tolerance: 1e-5 relative to the scale of the input matrices (the unrolled
arithmetic is the same operation for operation; backends differ in how they
order the few sums inside a broadcast-multiply-and-sum)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqslam_tpu.ops import linalg as jl
from mqslam_tpu_torch.ops import linalg as tl

SIZES = [2, 3, 4, 6, 9, 12]


@pytest.fixture
def rng():
    return np.random.RandomState(77)


def spd(rng, n, batch=24):
    A = rng.randn(batch, n + 3, n).astype(np.float32)
    return np.einsum("bki,bkj->bij", A, A).astype(np.float32)


def sym(rng, n, batch=24):
    A = rng.randn(batch, n, n).astype(np.float32)
    return (A + A.transpose(0, 2, 1)) / 2


def close(t, j, scale=1.0, tol=1e-5):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=tol * scale)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", ["spd", "sym"])
def test_eigh_jacobi(rng, n, kind):
    S = spd(rng, n) if kind == "spd" else sym(rng, n)
    scale = float(np.abs(S).max())
    wj, Vj = jl.eigh_jacobi(jnp.asarray(S))
    wt, Vt = tl.eigh_jacobi(torch.tensor(S))
    close(wt, wj, scale)
    close(Vt, Vj, 1.0, tol=2e-4)   # eigenvectors: unit scale, gaps amplify
    # and it is an eigendecomposition: V diag(w) V^T = S
    rec = (Vt * wt[:, None, :]) @ Vt.transpose(1, 2)
    np.testing.assert_allclose(rec.numpy(), S, atol=2e-5 * scale)
    assert (np.diff(wt.numpy(), axis=1) >= 0).all()


@pytest.mark.parametrize("n", SIZES)
def test_cholesky_and_solve(rng, n):
    S = spd(rng, n)
    b = rng.randn(S.shape[0], n).astype(np.float32)
    scale = float(np.abs(S).max())
    Lj = jl.cholesky_small(jnp.asarray(S))
    Lt = tl.cholesky_small(torch.tensor(S))
    close(Lt, Lj, np.sqrt(scale))
    xj = jl.cho_solve_small(Lj, jnp.asarray(b))
    xt = tl.cho_solve_small(Lt, torch.tensor(b))
    close(xt, xj, float(np.abs(np.asarray(xj)).max()), tol=1e-4)
    np.testing.assert_allclose(
        np.einsum("bij,bj->bi", S, xt.numpy()), b, atol=1e-3)


@pytest.mark.parametrize("n", SIZES)
def test_smallest_eigvec_spd(rng, n):
    S = spd(rng, n)
    for iters in (3, 4):
        close(tl.smallest_eigvec_spd(torch.tensor(S), iters=iters),
              jl.smallest_eigvec_spd(jnp.asarray(S), iters=iters))


def test_small_solves(rng):
    S3 = spd(rng, 3)
    r3 = rng.randn(24, 3).astype(np.float32)
    close(tl.solve3x3_sym(torch.tensor(S3), torch.tensor(r3)),
          jl.solve3x3_sym(jnp.asarray(S3), jnp.asarray(r3)), tol=1e-4)
    M = rng.randn(24, 3, 3).astype(np.float32)
    close(tl.inv3x3(torch.tensor(M)), jl.inv3x3(jnp.asarray(M)),
          float(np.abs(np.asarray(jl.inv3x3(jnp.asarray(M)))).max()))
    a, b, c, d, e = (rng.randn(24).astype(np.float32) for _ in range(5))
    a, c = np.abs(a) + 2, np.abs(c) + 2
    xj = jl.solve2x2_sym(*map(jnp.asarray, (a, b, c, d, e)))
    xt = tl.solve2x2_sym(*map(torch.tensor, (a, b, c, d, e)))
    close(xt[0], xj[0])
    close(xt[1], xj[1])
    # singular: clamped determinant, finite answer, same in both
    z = np.zeros(3, np.float32)
    xj = jl.solve2x2_sym(*map(jnp.asarray, (z, z, z, z + 1, z + 1)))
    xt = tl.solve2x2_sym(*map(torch.tensor, (z, z, z, z + 1, z + 1)))
    close(xt[0], xj[0])


def test_solve6x6_spd(rng):
    S = spd(rng, 6) + 0.1 * np.eye(6, dtype=np.float32)
    r = rng.randn(24, 6).astype(np.float32)
    xj = jl.solve6x6_spd(jnp.asarray(S), jnp.asarray(r))
    xt = tl.solve6x6_spd(torch.tensor(S), torch.tensor(r))
    close(xt, xj, float(np.abs(np.asarray(xj)).max()), tol=1e-4)
    np.testing.assert_allclose(np.einsum("bij,bj->bi", S, xt.numpy()), r,
                               atol=1e-3)


def test_svdvals_and_eigh4(rng):
    M = rng.randn(24, 3, 3).astype(np.float32)
    close(tl.svdvals3x3(torch.tensor(M)), jl.svdvals3x3(jnp.asarray(M)),
          tol=2e-5)
    np.testing.assert_allclose(tl.svdvals3x3(torch.tensor(M)).numpy(),
                               np.linalg.svd(M, compute_uv=False), atol=1e-4)
    S4 = spd(rng, 4)
    close(tl.eigh4x4_smallest(torch.tensor(S4)),
          jl.eigh4x4_smallest(jnp.asarray(S4)), tol=2e-4)


def test_round_robin_schedule():
    for n in SIZES:
        assert tl._round_robin_rounds(n) == jl._round_robin_rounds(n)
        pairs = [p for r in tl._round_robin_rounds(n) for p in r]
        assert len(pairs) == len(set(pairs)) == n * (n - 1) // 2


def test_near_singular_dlt_minimal_set(rng):
    """The 12x12 DLT Gram matrix of a 6-point minimal set is exactly
    singular: the shifted Cholesky lives on roundoff, which is why the
    arithmetic is ported operation for operation.  The null vector must
    agree with the JAX package's to 1e-4 (unit vector), not merely span the
    same space."""
    X = (rng.randn(16, 6, 3) + [0, 0, 5]).astype(np.float32)
    R = np.eye(3, dtype=np.float32)
    t = np.array([0.1, -0.2, 0.3], np.float32)
    pc = X @ R.T + t
    uv = pc[..., :2] / pc[..., 2:]
    one, zero = np.ones_like(X[..., 0]), np.zeros_like(X[..., 0])
    x, y = uv[..., 0], uv[..., 1]
    row_x = np.stack([X[..., 0], X[..., 1], X[..., 2], one, zero, zero, zero,
                      zero, -x * X[..., 0], -x * X[..., 1], -x * X[..., 2],
                      -x], -1)
    row_y = np.stack([zero, zero, zero, zero, X[..., 0], X[..., 1],
                      X[..., 2], one, -y * X[..., 0], -y * X[..., 1],
                      -y * X[..., 2], -y], -1)
    rows = np.concatenate([row_x, row_y], 1).astype(np.float32)
    S = np.einsum("bki,bkj->bij", rows, rows).astype(np.float32)
    pj = np.asarray(jl.smallest_eigvec_spd(jnp.asarray(S), iters=3))
    pt = tl.smallest_eigvec_spd(torch.tensor(S), iters=3).numpy()
    np.testing.assert_allclose(pt, pj, atol=1e-4)
    # it is the pose: p ~ [R | t] up to sign and scale (a minimal set in
    # float32 is noisy: most land within a few degrees in the 12-space)
    truth = np.concatenate([R, t[:, None]], 1).reshape(-1)
    truth /= np.linalg.norm(truth)
    cos = np.abs(pt @ truth)
    assert np.median(cos) > 0.99 and (cos > 0.9).all(), cos


def test_solve3x3(rng):
    M = rng.randn(24, 3, 3).astype(np.float32) + 2 * np.eye(3, dtype=np.float32)
    r = rng.randn(24, 3).astype(np.float32)
    xj = jl.solve3x3(jnp.asarray(M), jnp.asarray(r))
    xt = tl.solve3x3(torch.tensor(M), torch.tensor(r))
    close(xt, xj, float(np.abs(np.asarray(xj)).max()), tol=1e-4)
    np.testing.assert_allclose(np.einsum("bij,bj->bi", M, xt.numpy()), r,
                               atol=1e-3)


@pytest.mark.parametrize("rank", [3, 2])
def test_pinv_solve_sym(rng, rank):
    """Full-rank and rank-2 normal equations (the min-norm answer: the
    adjugate formula would blow up on the second)."""
    A = rng.randn(24, 4, rank).astype(np.float32)
    B = rng.randn(24, rank, 3).astype(np.float32)
    S = np.einsum("bki,bkj->bij", A @ B, A @ B).astype(np.float32)
    r = np.einsum("bij,bj->bi", S, rng.randn(24, 3)).astype(np.float32)
    xj = jl.pinv_solve_sym(jnp.asarray(S), jnp.asarray(r))
    xt = tl.pinv_solve_sym(torch.tensor(S), torch.tensor(r))
    close(xt, xj, float(np.abs(np.asarray(xj)).max()), tol=1e-3)
    assert np.isfinite(xt.numpy()).all()
    np.testing.assert_allclose(np.einsum("bij,bj->bi", S, xt.numpy()), r,
                               atol=2e-2 * np.abs(r).max())
