"""Full-precision products for tiny static matrices (3x3 / 4x4 / k x n).

The contractions are written as broadcast multiply + sum: exact float32 on
every device (no TF32 question), with a fixed, documented summation shape.
All broadcast over leading batch dims.
"""

import torch

__all__ = ["matmul_small", "matvec_small", "gram", "gram_rhs"]


def matmul_small(A, B):
    """C = A @ B for [..., m, k] x [..., k, n], k/m/n tiny and static."""
    return torch.sum(A[..., :, :, None] * B[..., None, :, :], dim=-2)


def matvec_small(A, v):
    """y = A @ v for [..., m, k] x [..., k]."""
    return torch.sum(A * v[..., None, :], dim=-1)


def gram(A):
    """A^T A for [..., k, n] row blocks."""
    return torch.sum(A[..., :, :, None] * A[..., :, None, :], dim=-3)


def gram_rhs(A, b):
    """A^T b for [..., k, n] rows and [..., k] targets."""
    return torch.sum(A * b[..., :, None], dim=-2)
