"""Entry points of the port's kernels, with device dispatch.

Call these from library code. A tensor on the card goes to the hand-written
CUDA kernel (``kernels/csrc/``); a tensor on the CPU goes to the plain
PyTorch version in :mod:`repro_torch.kernels.ref`. The device of the
tensors decides, and nothing else: there is no switch and no fallback from
the kernel to the plain version.

Dtype boundary: callers hand in codes and ids in whatever integer dtype
they store, and THIS module casts once to the canonical kernel dtypes —
uint8 codes (K ≤ 256), int32 ids, f32 LUTs and sub-vectors. The kernel
wrappers and the plain versions assume the canonical dtypes.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import adc_scan as _adc
from repro_torch.kernels import hop_adc as _hop
from repro_torch.kernels import pq_pairwise as _pqp
from repro_torch.kernels import ref as _ref


def pad_sentinel_row(x: torch.Tensor) -> torch.Tensor:
    """(N, ...) → (N+1, ...): append one all-zero row at index N.

    Row N is the sentinel every padded adjacency points at
    (graphs/adjacency.py), so tables gathered by beam ids carry a readable —
    never trusted — row there. Callers mask sentinel slots by id."""
    return torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))], dim=0)


def _codes_u8(codes: torch.Tensor) -> torch.Tensor:
    """Canonical plain codes: uint8, contiguous."""
    if codes.dtype != torch.uint8:
        codes = codes.to(torch.uint8)
    return codes.contiguous()


def _ids_i32(ids: torch.Tensor) -> torch.Tensor:
    if ids.dtype != torch.int32:
        ids = ids.to(torch.int32)
    return ids.contiguous()


def _f32(x: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.float32:
        x = x.float()
    return x.contiguous()


def _check_k(k: int) -> None:
    if k > 256:
        raise ValueError(f"uint8 codes address at most K=256 codewords, got K={k}")


def pq_pairwise(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Sub-vector/codeword distance table: (N, M, dsub) × (M, K, dsub) →
    (N, M, K) f32."""
    x, codebook = _f32(x), _f32(codebook)
    if x.is_cuda:
        return _pqp.pq_pairwise(x, codebook)
    return _ref.pq_pairwise_ref(x, codebook)


def kmeans_assign(x: torch.Tensor, centroids: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest centroid: (N, D) × (K, D) → (assign (N,) int32, sqdist (N,)
    f32); ties go to the lowest centroid index."""
    d = pq_pairwise(x[:, None, :], centroids[None, :, :])[:, 0, :]
    best, idx = torch.min(d, dim=1)
    return idx.to(torch.int32), best


def hop_adc(codes: torch.Tensor, ids: torch.Tensor, luts: torch.Tensor, *,
            m_prefix: int = 0) -> torch.Tensor:
    """FUSED per-hop beam ADC: (N, M) codes, (Q, R′) ids, (Q, M, K) LUTs →
    (Q, R′) f32 — gathers the R′ candidate code rows and reduces them
    against each query's LUT. R′ is the beam's frontier width (the degree R,
    or E·R with ``expand=E``). All ids must be rows of ``codes``.

    ``0 < m_prefix < M`` reduces only the FIRST m_prefix subspaces — the
    partial-LUT lower bound of hop pruning."""
    codes, ids, luts = _codes_u8(codes), _ids_i32(ids), _f32(luts)
    _check_k(luts.shape[2])
    m = codes.shape[1]
    mp = m_prefix if 0 < m_prefix < m else 0
    if codes.is_cuda:
        return _hop.hop_adc(codes, ids, luts, m_prefix=mp)
    if mp:
        return _ref.hop_adc_ref(codes[:, :mp], ids, luts[:, :mp])
    return _ref.hop_adc_ref(codes, ids, luts)


def adc_scan_batch(codes: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """Batched ADC scan: (N, M) codes × (Q, M, K) LUTs → (Q, N) f32."""
    codes, luts = _codes_u8(codes), _f32(luts)
    _check_k(luts.shape[2])
    if codes.is_cuda:
        return _adc.adc_scan_batch(codes, luts)
    return _ref.adc_scan_batch_ref(codes, luts)


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for mod in (_pqp, _hop, _adc):
        mod.launches = 0


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {"pq_pairwise": _pqp.launches, "hop_adc": _hop.launches,
            "adc_scan_batch": _adc.launches}
