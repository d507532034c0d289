"""Entry points of the port's kernels, with device dispatch.

Call these from library code. A tensor on the card goes to the hand-written
CUDA kernel (``kernels/csrc/``); a tensor on the CPU goes to the plain
PyTorch version in :mod:`repro_torch.kernels.ref`. The device of the
tensors decides, and nothing else: there is no switch and no fallback from
the kernel to the plain version.

Dtype boundary: callers hand in codes and ids in whatever integer dtype
they store, and THIS module casts once to the canonical kernel dtypes —
uint8 codes (K ≤ 256, or fs4 packed bytes), int32 ids, f32 LUTs and
sub-vectors, uint8 fs4 LUTs. The kernel wrappers and the plain versions
assume the canonical dtypes. The fs4 kernels return exact int32 sums; the
one affine dequant (:func:`_dequant`) stays here, outside both kernels, so
the float op sequence is the plain version's on every device.
"""

from __future__ import annotations

import torch

from repro_torch.device import full_f32_matmul
from repro_torch.kernels import adc_scan as _adc
from repro_torch.kernels import adc_scan_fs as _adcfs
from repro_torch.kernels import hop_adc as _hop
from repro_torch.kernels import hop_adc_fs as _hopfs
from repro_torch.kernels import hop_gather as _hopg
from repro_torch.kernels import pq_pairwise as _pqp
from repro_torch.kernels import ref as _ref


def pad_sentinel_row(x: torch.Tensor) -> torch.Tensor:
    """(N, ...) → (N+1, ...): append one all-zero row at index N.

    Row N is the sentinel every padded adjacency points at
    (graphs/adjacency.py), so tables gathered by beam ids carry a readable —
    never trusted — row there. Callers mask sentinel slots by id."""
    return torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))], dim=0)


def _codes_u8(codes: torch.Tensor) -> torch.Tensor:
    """Canonical plain codes, fs4 packed bytes and fs4 LUTs: uint8,
    contiguous."""
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


def pq_pairwise_backward(x: torch.Tensor, codebook: torch.Tensor,
                         grad: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Gradients of ``pq_pairwise`` for an upstream (N, M, K) ``grad``, per
    subspace: ``gx = 2·(x·Σ_k g − g·c)`` and ``gc = 2·(c·Σ_n g − gᵀ·x)``.

    The JAX package has no backward kernel: off the TPU it differentiates
    the oracle ``x² − 2·x·c + c²``, and its Pallas kernel cannot be
    differentiated at all. So these are two batched products and two
    reductions in PyTorch, in full f32, the same on every device."""
    full_f32_matmul()
    gx = 2.0 * (x * grad.sum(dim=2, keepdim=True)
                - torch.einsum("nmk,mkd->nmd", grad, codebook))
    gc = 2.0 * (codebook * grad.sum(dim=0)[:, :, None]
                - torch.einsum("nmk,nmd->mkd", grad, x))
    return gx, gc


class _PQPairwise(torch.autograd.Function):
    """``pq_pairwise`` with a gradient: the forward dispatches on the device
    (kernel for a CUDA tensor, plain version for a CPU one), the backward is
    :func:`pq_pairwise_backward` on both."""

    @staticmethod
    def forward(ctx, x, codebook):
        ctx.save_for_backward(x, codebook)
        if x.is_cuda:
            return _pqp.pq_pairwise(x, codebook)
        return _ref.pq_pairwise_ref(x, codebook)

    @staticmethod
    def backward(ctx, grad):
        x, codebook = ctx.saved_tensors
        gx, gc = pq_pairwise_backward(x, codebook, grad.contiguous())
        return (gx if ctx.needs_input_grad[0] else None,
                gc if ctx.needs_input_grad[1] else None)


def pq_pairwise(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Sub-vector/codeword distance table: (N, M, dsub) × (M, K, dsub) →
    (N, M, K) f32. Differentiable in both inputs: the result carries a
    ``grad_fn`` whenever an input requires grad."""
    return _PQPairwise.apply(_f32(x), _f32(codebook))


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


def hop_gather(codes: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """Per-hop beam ADC on PRE-GATHERED codes: (Q, R, M) codes × (Q, M, K)
    LUTs → (Q, R) f32. Prefer :func:`hop_adc` where the ids are still at
    hand — it fuses the gather too."""
    codes, luts = _codes_u8(codes), _f32(luts)
    _check_k(luts.shape[2])
    if codes.is_cuda:
        return _hopg.hop_gather(codes, luts)
    return _ref.hop_gather_ref(codes, luts)


def adc_scan(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """One-query ADC scan: (N, M) codes × (M, K) LUT → (N,) f32."""
    codes, lut = _codes_u8(codes), _f32(lut)
    _check_k(lut.shape[1])
    if codes.is_cuda:
        return _adc.adc_scan(codes, lut)
    return _ref.adc_scan_ref(codes, lut)


def adc_scan_batch(codes: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """Batched ADC scan: (N, M) codes × (Q, M, K) LUTs → (Q, N) f32."""
    codes, luts = _codes_u8(codes), _f32(luts)
    _check_k(luts.shape[2])
    if codes.is_cuda:
        return _adc.adc_scan_batch(codes, luts)
    return _ref.adc_scan_batch_ref(codes, luts)


# the fs4 oracles' own affine undo, applied here for kernel and plain
# version alike, so the f32 results of both equal the oracles'
_dequant = _ref.dequant


def adc_scan_fs(packed: torch.Tensor, luts_u8: torch.Tensor,
                scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Batched FAST-SCAN ADC: (N, ceil(M/2)) 4-bit-packed codes ×
    (Q, M, 16) uint8 LUTs + per-query (Q,) (scale, bias) → (Q, N) f32.
    Pack codes with ``pq.pack.pack_codes`` and quantize LUTs with
    ``pq.pack.quantize_luts``."""
    packed, luts_u8 = _codes_u8(packed), _codes_u8(luts_u8)
    if packed.is_cuda:
        acc = _adcfs.adc_scan_fs(packed, luts_u8)
    else:
        acc = _ref.adc_scan_fs_acc(packed, luts_u8)
    return _dequant(acc, scale, bias, luts_u8.shape[1])


def hop_adc_fs(packed: torch.Tensor, ids: torch.Tensor, luts_u8: torch.Tensor,
               scale: torch.Tensor, bias: torch.Tensor, *,
               m_prefix: int = 0) -> torch.Tensor:
    """FUSED per-hop FAST-SCAN ADC: (N, ceil(M/2)) packed codes, (Q, R′)
    ids, (Q, M, 16) uint8 LUTs + (Q,) (scale, bias) → (Q, R′) f32 — the
    packed twin of :func:`hop_adc`.

    ``0 < m_prefix < M`` sums only the first m_prefix sub-codes and
    dequantizes with ``m_prefix · bias``; an odd m_prefix is exact on the
    plain path too (the paired table zero-pads the dangling high nibble)."""
    packed, ids, luts_u8 = _codes_u8(packed), _ids_i32(ids), _codes_u8(luts_u8)
    m = luts_u8.shape[1]
    mp = m_prefix if 0 < m_prefix < m else 0
    m_eff = mp or m
    if packed.is_cuda:
        acc = _hopfs.hop_adc_fs(packed, ids, luts_u8, m_prefix=mp)
    else:
        acc = _ref.hop_adc_fs_acc(packed[:, :(m_eff + 1) // 2], ids,
                                  luts_u8[:, :m_eff])
    return _dequant(acc, scale, bias, m_eff)


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for mod in (_pqp, _hop, _adc, _hopfs, _adcfs, _hopg):
        mod.launches = 0
    _adc.query_launches = 0


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {"pq_pairwise": _pqp.launches, "hop_adc": _hop.launches,
            "adc_scan_batch": _adc.launches, "hop_adc_fs": _hopfs.launches,
            "adc_scan_fs": _adcfs.launches, "adc_scan": _adc.query_launches,
            "hop_gather": _hopg.launches}
