"""Entry points of the port's kernels, with device dispatch.

Call these from library code. A tensor on the card goes to the hand-written
CUDA kernel (``kernels/csrc/``); a tensor on the CPU goes to the plain
PyTorch version in :mod:`repro_torch.kernels.ref`. The device of the
tensors decides, and nothing else: there is no switch and no fallback from
the kernel to the plain version.

Dtype boundary: callers hand in codes and ids in whatever integer dtype
they store, and THIS module casts once to the canonical kernel dtypes —
uint8 codes stay uint8 and any other integer codes become int32 (K > 256,
the reference's canonical dtype; never narrowed to uint8), fs4 packed bytes
and LUTs uint8, int32 ids, f32 LUTs and sub-vectors. The kernel wrappers and the plain versions
assume the canonical dtypes. The fs4 kernels return exact int32 sums; the
one affine dequant (:func:`_dequant`) stays here, outside both kernels, so
the float op sequence is the plain version's on every device.
"""

from __future__ import annotations

import torch

from repro_torch.device import full_f32_matmul
from repro_torch.kernels import adc_scan as _adc
from repro_torch.kernels import adc_scan_fs as _adcfs
from repro_torch.kernels import beam_round as _round
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


def pad_rows_to_multiple(x: torch.Tensor, mult: int) -> torch.Tensor:
    """(N, ...) → (N', ...) with N' the next multiple of ``mult``, padded
    with zero rows (shard-divisibility padding)."""
    pad = (-x.shape[0]) % mult
    if pad == 0:
        return x
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))], dim=0)


def _codes_u8(codes: torch.Tensor) -> torch.Tensor:
    """Canonical fs4 packed bytes and fs4 LUTs: uint8, contiguous."""
    if codes.dtype != torch.uint8:
        codes = codes.to(torch.uint8)
    return codes.contiguous()


def _codes(codes: torch.Tensor) -> torch.Tensor:
    """Canonical plain codes, contiguous: uint8 stays uint8 (the kernels'
    byte rows), every other integer dtype becomes int32 (the kernels'
    int32 variants), so a code above 255 is never narrowed."""
    if codes.dtype not in (torch.uint8, torch.int32):
        codes = codes.to(torch.int32)
    return codes.contiguous()


def _ids_i32(ids: torch.Tensor) -> torch.Tensor:
    if ids.dtype != torch.int32:
        ids = ids.to(torch.int32)
    return ids.contiguous()


def _f32(x: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.float32:
        x = x.float()
    return x.contiguous()


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
    codes, ids, luts = _codes(codes), _ids_i32(ids), _f32(luts)
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
    codes, luts = _codes(codes), _f32(luts)
    if codes.is_cuda:
        return _hopg.hop_gather(codes, luts)
    return _ref.hop_gather_ref(codes, luts)


def adc_scan(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """One-query ADC scan: (N, M) codes × (M, K) LUT → (N,) f32."""
    codes, lut = _codes(codes), _f32(lut)
    if codes.is_cuda:
        return _adc.adc_scan(codes, lut)
    return _ref.adc_scan_ref(codes, lut)


def adc_scan_batch(codes: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """Batched ADC scan: (N, M) codes × (Q, M, K) LUTs → (Q, N) f32."""
    codes, luts = _codes(codes), _f32(luts)
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


def hop_adc_fs_acc(packed: torch.Tensor, ids: torch.Tensor, luts_u8: torch.Tensor,
                   *, m_prefix: int = 0) -> torch.Tensor:
    """FUSED per-hop FAST-SCAN accumulators: (N, ceil(M/2)) packed codes,
    (Q, R′) ids, (Q, M, 16) uint8 LUTs → (Q, R′) int32 exact sums, before
    any dequant. ``0 < m_prefix < M`` sums only the first m_prefix
    sub-codes (odd counts exact on both routes: the plain version's paired
    table zero-pads the dangling high nibble).

    For callers that dequantize on their own terms: the disk tier undoes a
    prefix sum with the FULL ``M · bias``, as the reference's
    ``storage/engine.py`` does, where :func:`hop_adc_fs` uses
    ``m_prefix · bias``."""
    packed, ids, luts_u8 = _codes_u8(packed), _ids_i32(ids), _codes_u8(luts_u8)
    m = luts_u8.shape[1]
    mp = m_prefix if 0 < m_prefix < m else 0
    if packed.is_cuda:
        return _hopfs.hop_adc_fs(packed, ids, luts_u8, m_prefix=mp)
    m_eff = mp or m
    return _ref.hop_adc_fs_acc(packed[:, :(m_eff + 1) // 2], ids, luts_u8[:, :m_eff])


def hop_adc_fs(packed: torch.Tensor, ids: torch.Tensor, luts_u8: torch.Tensor,
               scale: torch.Tensor, bias: torch.Tensor, *,
               m_prefix: int = 0) -> torch.Tensor:
    """FUSED per-hop FAST-SCAN ADC: (N, ceil(M/2)) packed codes, (Q, R′)
    ids, (Q, M, 16) uint8 LUTs + (Q,) (scale, bias) → (Q, R′) f32 — the
    packed twin of :func:`hop_adc`.

    ``0 < m_prefix < M`` sums only the first m_prefix sub-codes and
    dequantizes with ``m_prefix · bias``; an odd m_prefix is exact on the
    plain path too (the paired table zero-pads the dangling high nibble)."""
    m = luts_u8.shape[1]
    mp = m_prefix if 0 < m_prefix < m else 0
    acc = hop_adc_fs_acc(packed, ids, luts_u8, m_prefix=mp)
    return _dequant(acc, scale, bias, mp or m)


def beam_expand(neighbors: torch.Tensor, ids: torch.Tensor, dists: torch.Tensor,
                exp: torch.Tensor, live: torch.Tensor, visited: torch.Tensor,
                hops: torch.Tensor, ndist: torch.Tensor, count: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """First half of a classic beam round (``expand=1``, no hop pruning):
    each live lane of the (Q, h) sorted beam expands its best unexpanded
    finite entry over the (N, R) int32 adjacency. Updates the expanded
    flags, the (Q, W) visited bitsets, hops and n_dist in place; returns the
    (Q, R) int32 frontier ids (0 where not fresh), a new tensor every call,
    and the (Q, R) bool fresh mask. ``count`` is the 0-d int32 live count
    of :func:`beam_merge`."""
    if ids.is_cuda:
        return _round.beam_expand(neighbors, ids, dists, exp, live, visited, hops,
                                  ndist, count)
    return _ref.beam_expand_ref(neighbors, ids, dists, exp, live, visited, hops,
                                ndist, count)


def beam_merge(ids: torch.Tensor, dists: torch.Tensor, exp: torch.Tensor,
               front: torch.Tensor, fresh: torch.Tensor, front_d: torch.Tensor,
               live: torch.Tensor, step: torch.Tensor, ndist: torch.Tensor,
               count: torch.Tensor, *, n: int, tombstones=None, max_steps: int,
               max_rounds=None, max_n_dist=None) -> torch.Tensor:
    """Second half of a classic beam round: merges the frontier of
    :func:`beam_expand`, scored by the distance call as ``front_d``, into
    each live lane's beam (the h best of a stable sort of beam ++ frontier),
    counts the round in ``step`` and re-evaluates ``live`` under
    ``max_steps`` and the budgets, all in place. Returns ``count``: the
    number of live lanes, as a 0-d int32 tensor, the one value the host
    waits for."""
    front_d = _f32(front_d)
    if ids.is_cuda:
        return _round.beam_merge(ids, dists, exp, front, fresh, front_d, live, step,
                                 ndist, count, n=n, tombstones=tombstones,
                                 max_steps=max_steps, max_rounds=max_rounds,
                                 max_n_dist=max_n_dist)
    return _ref.beam_merge_ref(ids, dists, exp, front, fresh, front_d, live, step,
                               ndist, count, n=n, tombstones=tombstones,
                               max_steps=max_steps, max_rounds=max_rounds,
                               max_n_dist=max_n_dist)


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for mod in (_pqp, _hop, _adc, _hopfs, _adcfs, _hopg):
        mod.launches = 0
    _round.launches_expand = _round.launches_merge = 0
    _adc.query_launches = 0
    _hop.launches_i32 = _adc.launches_i32 = _hopg.launches_i32 = 0
    _adc.query_launches_i32 = 0


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`; the
    int32-code variants (K > 256) count under ``<kernel>_i32``."""
    return {"pq_pairwise": _pqp.launches, "hop_adc": _hop.launches,
            "adc_scan_batch": _adc.launches, "hop_adc_fs": _hopfs.launches,
            "adc_scan_fs": _adcfs.launches, "adc_scan": _adc.query_launches,
            "hop_gather": _hopg.launches, "beam_expand": _round.launches_expand,
            "beam_merge": _round.launches_merge, "hop_adc_i32": _hop.launches_i32,
            "adc_scan_batch_i32": _adc.launches_i32,
            "adc_scan_i32": _adc.query_launches_i32,
            "hop_gather_i32": _hopg.launches_i32}
