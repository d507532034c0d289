"""Differentiable quantizer (paper §4): rotation + Gumbel-Softmax PQ.

Port of ``repro/core/quantizer.py``. The state is :class:`RPQParams`, a
named tuple of tensors that the trainer and the optimizer treat as a tree.

* All quantization happens in the ROTATED space; squared distances are
  rotation-invariant, so ADC distances computed there equal those in the
  original space, and queries are rotated once at LUT-build time.
* ``soft_assign`` is Eq. 6 with the sign fixed:
  ``p(c_k | x_j) = softmax_k(−‖x_j − c_k‖² / T)``.
* ``gumbel_codes`` is Eq. 7; with ``straight_through`` the forward value is
  the exact one-hot argmax (``hard + (y − y.detach())``) while the gradient
  flows through the soft sample.

Every distance table comes from ``kernels.ops.pq_pairwise``: the CUDA
kernel forward on the card, with its PyTorch backward. The Gumbel noise of
``gumbel_codes`` comes from a ``torch.Generator``, or is handed in
(``noise=``) so that a test can inject the reference's draws.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import rotation as rot
from repro_torch.device import full_f32_matmul
from repro_torch.kernels import ops as kops
from repro_torch.pq import base as pqbase


class RPQParams(NamedTuple):
    theta: torch.Tensor      # (D*(D-1)/2,) skew-symmetric generator (upper tri)
    codebooks: torch.Tensor  # (M, K, D/M) codewords per subspace
    log_alpha: torch.Tensor  # () learnable loss-mixing coefficient (Eq. 11)


class RPQConfig(NamedTuple):
    dim: int
    m: int = 8                  # number of subspaces
    k: int = 256                # codewords per subspace (byte codes)
    assign_temp: float = 1.0    # T in softmax(-d/T) (Eq. 6)
    gumbel_tau: float = 1.0     # Gumbel-Softmax temperature (Eq. 7)
    routing_tau: float = 1.0    # τ in the routing loss (Eq. 9)
    adaptive_temp: bool = True  # normalize d by its batch scale (see _temp_scale)
    straight_through: bool = True
    learn_rotation: bool = True

    @property
    def dsub(self) -> int:
        return self.dim // self.m


def init_params(cfg: RPQConfig, codebooks: torch.Tensor) -> RPQParams:
    """R = I and the given (k-means) codebooks, on the codebooks' device."""
    if tuple(codebooks.shape) != (cfg.m, cfg.k, cfg.dsub):
        raise ValueError(f"codebooks {tuple(codebooks.shape)} do not match "
                         f"{(cfg.m, cfg.k, cfg.dsub)}")
    dev = codebooks.device
    return RPQParams(
        theta=rot.init_rotation_params(cfg.dim, device=dev),
        codebooks=codebooks.detach().to(torch.float32).clone(),
        log_alpha=torch.zeros((), dtype=torch.float32, device=dev))


# --------------------------------------------------------------------------
# Forward paths
# --------------------------------------------------------------------------

def rotation_matrix(cfg: RPQConfig, params: RPQParams) -> torch.Tensor:
    if not cfg.learn_rotation:
        return torch.eye(cfg.dim, dtype=torch.float32, device=params.theta.device)
    return rot.rotation_from_params(params.theta, cfg.dim)


def rotate_split(cfg: RPQConfig, params: RPQParams, x: torch.Tensor) -> torch.Tensor:
    """(N, D) → (N, M, dsub) rotated sub-vectors."""
    r = rotation_matrix(cfg, params)
    return rot.split_subvectors(rot.rotate(x, r), cfg.m)


def subspace_distances(cfg: RPQConfig, params: RPQParams,
                       x: torch.Tensor) -> torch.Tensor:
    """(N, D) → (N, M, K) table of ‖rot(x)_j − c_k^j‖² (the hot loop)."""
    return kops.pq_pairwise(rotate_split(cfg, params, x), params.codebooks)


def _temp_scale(cfg: RPQConfig, d: torch.Tensor) -> torch.Tensor:
    """Batch-mean NEAREST distance (no gradient): the closest codeword sits
    at d̃ ≈ 1 whatever the data's magnitude."""
    if not cfg.adaptive_temp:
        return torch.ones((), dtype=d.dtype, device=d.device)
    return (torch.mean(torch.amin(d, dim=-1)) + 1e-12).detach()


def soft_assign(cfg: RPQConfig, params: RPQParams, x: torch.Tensor) -> torch.Tensor:
    """Eq. 6 (sign-fixed): codeword assignment probabilities (N, M, K)."""
    d = subspace_distances(cfg, params, x)
    return torch.softmax(-d / (_temp_scale(cfg, d) * cfg.assign_temp), dim=-1)


def gumbel_noise(shape, *, generator: Optional[torch.Generator],
                 device) -> torch.Tensor:
    """Standard Gumbel draws ``−log(−log u)``, u uniform in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32, device=device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def gumbel_codes(cfg: RPQConfig, params: RPQParams, x: torch.Tensor, *,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eq. 7: approximate compact code as a (N, M, K) relaxed one-hot,
    ``softmax((log p + g) / tau)``, snapped to the exact one-hot forward
    under ``straight_through`` (argmax ties to the first index, as JAX).

    ``noise`` is the (N, M, K) Gumbel sample ``g``; without it, it is drawn
    from ``generator``."""
    d = subspace_distances(cfg, params, x)
    logp = torch.log_softmax(-d / (_temp_scale(cfg, d) * cfg.assign_temp), dim=-1)
    if noise is None:
        noise = gumbel_noise(logp.shape, generator=generator, device=logp.device)
    y = torch.softmax((logp + noise) / cfg.gumbel_tau, dim=-1)
    if cfg.straight_through:
        hard = torch.nn.functional.one_hot(torch.argmax(y, dim=-1),
                                           cfg.k).to(y.dtype)
        y = hard + (y - y.detach())
    return y


def decode_soft(cfg: RPQConfig, params: RPQParams, probs: torch.Tensor) -> torch.Tensor:
    """(N, M, K) assignment (soft or one-hot) → (N, D) quantized vectors in
    the ROTATED space."""
    full_f32_matmul()
    sub = torch.einsum("nmk,mkd->nmd", probs, params.codebooks)
    return rot.merge_subvectors(sub)


def quantize_st(cfg: RPQConfig, params: RPQParams, x: torch.Tensor, *,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x → x′: end-to-end differentiable quantized vectors (rotated space)."""
    return decode_soft(cfg, params, gumbel_codes(cfg, params, x,
                                                 generator=generator, noise=noise))


# --------------------------------------------------------------------------
# Inference paths (hard codes, LUTs) — what the serving engine uses
# --------------------------------------------------------------------------

@torch.no_grad()
def encode(cfg: RPQConfig, params: RPQParams, x: torch.Tensor) -> torch.Tensor:
    """(N, D) → (N, M) hard codes (uint8 if K ≤ 256), ties to the lowest
    codeword; the table is built ``pq.base.ENCODE_CHUNK`` rows at a time."""
    sub = rotate_split(cfg, params, x)
    dtype = torch.uint8 if cfg.k <= 256 else torch.int32
    codes = torch.empty((x.shape[0], cfg.m), dtype=dtype, device=x.device)
    for s in range(0, x.shape[0], pqbase.ENCODE_CHUNK):
        e = s + pqbase.ENCODE_CHUNK
        codes[s:e] = kops.pq_pairwise(sub[s:e], params.codebooks).argmin(dim=-1)
    return codes


def decode(cfg: RPQConfig, params: RPQParams, codes: torch.Tensor) -> torch.Tensor:
    """(N, M) codes → (N, D) quantized vectors in the rotated space."""
    m = torch.arange(cfg.m, device=codes.device)
    return rot.merge_subvectors(params.codebooks[m[None, :], codes.long()])


def build_lut(cfg: RPQConfig, params: RPQParams, queries: torch.Tensor) -> torch.Tensor:
    """(Q, D) queries → (Q, M, K) ADC lookup tables (rotated space)."""
    qs = rotate_split(cfg, params, torch.atleast_2d(queries))
    return kops.pq_pairwise(qs, params.codebooks)


def adc_distances(cfg: RPQConfig, params: RPQParams, codes: torch.Tensor,
                  queries: torch.Tensor) -> torch.Tensor:
    """(Q, D) × (N, M) → (Q, N) ADC distance estimates."""
    return kops.adc_scan_batch(codes, build_lut(cfg, params, queries))


@torch.no_grad()
def reconstruction_mse(cfg: RPQConfig, params: RPQParams, x: torch.Tensor) -> torch.Tensor:
    """Mean ‖rot(x) − decode(encode(x))‖²: the classic PQ distortion."""
    xq = decode(cfg, params, encode(cfg, params, x))
    r = rotation_matrix(cfg, params)
    return torch.mean(torch.sum((rot.rotate(x, r) - xq) ** 2, dim=-1))
