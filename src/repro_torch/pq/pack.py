"""Fast-scan code packing + LUT quantization (the FAISS "fast scan" layout).

Port of ``repro/pq/pack.py``. At K=16 a PQ code needs only 4 bits, so two
sub-codes pack into one byte — half the bytes per distance — and the
(M, K) f32 LUT quantizes to uint8 with a per-query affine (scale, bias) —
a quarter of the LUT bytes. Distances accumulate exactly in int32 and
dequantize once per output:

    dist_f32 = scale * sum_j lut_u8[j, code_j] + M * bias

Packing convention (shared with kernels/ref.py and the fs4 CUDA kernels):
byte b of a row holds sub-code 2b in its LOW nibble and sub-code 2b+1 in
its HIGH nibble; odd M leaves the last byte's high nibble zero.

Nothing here imports the rest of the port, so any layer may depend on it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

FS_K = 16  # fast-scan codebook size: 4-bit codes, fixed by the nibble layout


class QuantizedLUT(NamedTuple):
    """Per-query uint8 ADC tables with the affine to undo them.

    lut:   (..., M, 16) uint8 — quantized per-subspace distance tables.
    scale: (...,) float32     — per-query step size ((max-min)/255).
    bias:  (...,) float32     — per-query minimum LUT entry.

    ``dist = scale * int_accumulate + M * bias``; the quantization error of
    a single distance is bounded by ``M * scale / 2``.
    """
    lut: torch.Tensor
    scale: torch.Tensor
    bias: torch.Tensor

    def dequantize(self) -> torch.Tensor:
        """(..., M, 16) f32 reconstruction (debug/error-analysis helper)."""
        extra = self.lut.dim() - self.scale.dim()
        shape = tuple(self.scale.shape) + (1,) * extra
        return (self.lut.float() * self.scale.reshape(shape)
                + self.bias.reshape(shape))

    def to(self, device) -> "QuantizedLUT":
        return QuantizedLUT(self.lut.to(device), self.scale.to(device),
                            self.bias.to(device))


def packed_width(m: int) -> int:
    """Bytes per packed code row for M sub-codes: ceil(M / 2)."""
    return (m + 1) // 2


def pack_codes(codes: torch.Tensor) -> torch.Tensor:
    """(N, M) sub-codes in [0, 16) → (N, ceil(M/2)) uint8 packed rows.

    Values ≥ 16 are a caller bug (train with K ≤ 16 for the fs4 layout);
    they are masked to 4 bits rather than corrupting the neighbor nibble.
    """
    c = codes.to(torch.uint8) & 0xF
    if c.shape[1] % 2:
        c = F.pad(c, (0, 1))
    return (c[:, 0::2] | (c[:, 1::2] << 4)).contiguous()


def unpack_codes(packed: torch.Tensor, m: int) -> torch.Tensor:
    """(N, ceil(M/2)) packed bytes → (N, M) uint8 sub-codes (inverse)."""
    p = packed.to(torch.uint8)
    full = torch.stack([p & 0xF, p >> 4], dim=-1).reshape(p.shape[0], -1)
    return full[:, :m].contiguous()


def quantize_luts(luts: torch.Tensor) -> QuantizedLUT:
    """(Q, M, K≤16) f32 LUTs → per-query uint8 tables + (scale, bias).

    The affine is per QUERY (one scale/bias over the whole (M, K) table).
    Rounding is half to even, as ``jnp.round``. K < 16 tables are
    zero-padded to 16 columns — codes never reference the padding because
    they were trained with the same K.
    """
    q, m, k = luts.shape
    if k > FS_K:
        raise ValueError(f"fast-scan LUTs need K <= {FS_K}, got K={k}")
    luts = luts.float()
    flat = luts.reshape(q, -1)
    lo = flat.min(dim=1).values                              # (Q,)
    hi = flat.max(dim=1).values
    scale = torch.where(hi > lo, (hi - lo) / 255.0, torch.ones_like(hi))
    qv = torch.clamp(torch.round((luts - lo[:, None, None]) / scale[:, None, None]),
                     0, 255).to(torch.uint8)
    if k < FS_K:
        qv = F.pad(qv, (0, FS_K - k))
    return QuantizedLUT(lut=qv.contiguous(), scale=scale, bias=lo)
