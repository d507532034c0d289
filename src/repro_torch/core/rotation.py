"""Adaptive vector decomposition (paper §4, step 1).

Port of ``repro/core/rotation.py``. A learnable skew-symmetric matrix ``A``
parameterizes a square orthonormal rotation ``R = expm(A)``
(``torch.linalg.matrix_exp`` for ``jax.scipy.linalg.expm``; both are
differentiable). ``A`` is held as its strictly-upper-triangular entries, so
no optimizer step can break the skew symmetry.
"""

from __future__ import annotations

import torch

from repro_torch.device import full_f32_matmul


def init_rotation_params(dim: int, *, device=None) -> torch.Tensor:
    """(D·(D−1)/2,) zero generator parameters: R = I, the PQ-compatible
    start (the reference's random ``scale`` start has no caller)."""
    return torch.zeros(dim * (dim - 1) // 2, dtype=torch.float32, device=device)


def skew_from_params(theta: torch.Tensor, dim: int) -> torch.Tensor:
    """The (D, D) skew-symmetric A from its upper triangle (row-major
    order, as ``jnp.triu_indices``)."""
    rows, cols = torch.triu_indices(dim, dim, offset=1, device=theta.device)
    a = theta.new_zeros((dim, dim)).index_put((rows, cols), theta)
    return a - a.T


def rotation_from_params(theta: torch.Tensor, dim: int) -> torch.Tensor:
    """R = expm(A(theta)); differentiable, orthonormal up to rounding."""
    return torch.linalg.matrix_exp(skew_from_params(theta, dim))


def rotate(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """x (..., D) → x @ Rᵀ (R x for row vectors), in full f32."""
    full_f32_matmul()
    return x @ r.T


def split_subvectors(x: torch.Tensor, m: int) -> torch.Tensor:
    """(..., D) → (..., M, D/M) vertical split of the (rotated) vector."""
    *lead, d = x.shape
    if d % m:
        raise ValueError(f"D={d} not divisible by M={m}")
    return x.reshape(*lead, m, d // m)


def merge_subvectors(x: torch.Tensor) -> torch.Tensor:
    """(..., M, D/M) → (..., D)."""
    *lead, m, dsub = x.shape
    return x.reshape(*lead, m * dsub)
