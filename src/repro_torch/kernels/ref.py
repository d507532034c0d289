"""Plain PyTorch versions of the port's kernels.

Each is the semantics contract of one CUDA kernel (``kernels/csrc/``) and a
port of the JAX oracle of the same name in ``repro/kernels/ref.py``. The
CPU path of ``kernels/ops.py`` runs them; ``chip_smoke.py`` holds each
kernel against its plain version on the card. Inputs arrive in the
canonical dtypes fixed by ``ops``: uint8 codes (plain or fs4-packed), int32
ids, f32 LUTs (uint8 for fs4).
"""

from __future__ import annotations

import torch


def hop_gather_ref(codes: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """Per-hop ADC on pre-gathered rows: (Q, R, M) codes × (Q, M, K) LUTs →
    (Q, R) f32, ``out[q, r] = sum_j luts[q, j, codes[q, r, j]]``."""
    idx = codes.long().transpose(1, 2)                 # (Q, M, R)
    return luts.float().gather(2, idx).sum(dim=1)      # (Q, R)


def hop_adc_ref(codes: torch.Tensor, ids: torch.Tensor,
                luts: torch.Tensor) -> torch.Tensor:
    """Fused per-hop ADC: (N, M) codes, (Q, R′) ids in [0, N), (Q, M, K)
    LUTs → (Q, R′) f32, ``out[q, i] = sum_j luts[q, j, codes[ids[q, i], j]]``.
    """
    return hop_gather_ref(codes[ids.long()], luts)


def adc_scan_ref(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """One-query ADC scan: (N, M) codes × (M, K) LUT → (N,) f32
    ``sum_j lut[j, codes[n, j]]``, accumulated one subspace at a time in j
    order (the kernel's order) without the (N, M) gather."""
    lut = lut.float()
    idx = codes.long()
    out = torch.zeros(codes.shape[0], dtype=torch.float32, device=lut.device)
    for j in range(codes.shape[1]):
        out += lut[j][idx[:, j]]
    return out


def adc_scan_batch_ref(codes: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """Batched ADC scan: (N, M) codes × (Q, M, K) LUTs → (Q, N) f32.

    Accumulates one subspace at a time, so the working set is the (Q, N)
    output and not the (Q, N, M) gather (64 GB at 1000 × 1M × 16)."""
    q, m, _ = luts.shape
    luts = luts.float()
    idx = codes.long()
    out = torch.zeros((q, codes.shape[0]), dtype=torch.float32,
                      device=luts.device)
    for j in range(m):
        out += luts[:, j, :][:, idx[:, j]]
    return out


# --------------------------------------------------------------------------
# Fast-scan (fs4): two 4-bit codes per byte, uint8 LUTs, exact int32
# accumulation. The ``*_acc`` functions are the contract of the fs4 CUDA
# kernels (int32 out); the f32 oracles add the one affine dequant.
# --------------------------------------------------------------------------

def _pair_lut(luts_u8: torch.Tensor) -> torch.Tensor:
    """(..., M, 16) u8 LUT → (..., ceil(M/2), 256) int32 PAIRED table,
    ``pair[..., b, byte] = lut[..., 2b, byte & 15] + lut[..., 2b+1, byte >> 4]``
    so one gather with the raw packed byte scores two sub-codes (nibble
    convention of :mod:`repro_torch.pq.pack`). Odd M pads a zero row."""
    li = luts_u8.to(torch.int32)
    if li.shape[-2] % 2:
        li = torch.nn.functional.pad(li, (0, 0, 0, 1))
    byte = torch.arange(256, device=li.device)
    return li[..., 0::2, :][..., byte & 0xF] + li[..., 1::2, :][..., byte >> 4]


def adc_scan_fs_acc(packed: torch.Tensor, luts_u8: torch.Tensor) -> torch.Tensor:
    """(N, ceil(M/2)) packed codes × (Q, M, 16) u8 LUTs → (Q, N) int32
    ``sum_j luts_u8[q, j, code_j]``, exact.

    Accumulates one packed byte column at a time, so the working set is the
    (Q, N) output and not the (Q, N, ceil(M/2)) gather (32 GB at 1000 × 1M
    × 8); integer sums are associative, so the order changes nothing."""
    pair = _pair_lut(luts_u8)                              # (Q, Mb, 256)
    idx = packed.long()
    out = torch.zeros((pair.shape[0], packed.shape[0]), dtype=torch.int32,
                      device=pair.device)
    for b in range(pair.shape[1]):
        out += pair[:, b, :][:, idx[:, b]]
    return out


def hop_adc_fs_acc(packed: torch.Tensor, ids: torch.Tensor,
                   luts_u8: torch.Tensor) -> torch.Tensor:
    """(N, ceil(M/2)) packed codes, (Q, R′) ids in [0, N), (Q, M, 16) u8
    LUTs → (Q, R′) int32 ``sum_j luts_u8[q, j, code_j(ids[q, i])]``."""
    pair = _pair_lut(luts_u8)                              # (Q, Mb, 256)
    rows = packed[ids.long()].long().transpose(1, 2)       # (Q, Mb, R′)
    return pair.gather(2, rows).sum(dim=1, dtype=torch.int32)


def dequant(acc: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            m: int) -> torch.Tensor:
    """Per-query affine undo of fs4 int32 sums: (Q, X) int32 + (Q,)
    scale/bias → (Q, X) f32 ``scale * acc + m * bias``, in the JAX
    oracles' op order (two roundings, no fused multiply-add)."""
    return scale.float()[:, None] * acc.float() + m * bias.float()[:, None]


def adc_scan_fs_ref(packed: torch.Tensor, luts_u8: torch.Tensor,
                    scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Batched fast-scan ADC: (Q, N) f32 ``scale[q] * acc + M * bias[q]``
    with the inner sum in exact int32."""
    return dequant(adc_scan_fs_acc(packed, luts_u8), scale, bias, luts_u8.shape[1])


def hop_adc_fs_ref(packed: torch.Tensor, ids: torch.Tensor, luts_u8: torch.Tensor,
                   scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Fused per-hop fast-scan ADC: (Q, R′) f32 dequantized distances."""
    return dequant(hop_adc_fs_acc(packed, ids, luts_u8), scale, bias, luts_u8.shape[1])


def pq_pairwise_ref(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """(N, M, dsub) sub-vectors × (M, K, dsub) codewords → (N, M, K) f32
    ``||x[n, j] - codebook[j, k]||^2`` as ``x² − 2·x·c + c²``."""
    x = x.float()
    c = codebook.float()
    x2 = (x * x).sum(dim=-1)[:, :, None]               # (N, M, 1)
    c2 = (c * c).sum(dim=-1)[None, :, :]               # (1, M, K)
    xc = torch.einsum("nmd,mkd->nmk", x, c)            # (N, M, K)
    return x2 - 2.0 * xc + c2
