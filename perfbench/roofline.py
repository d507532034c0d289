"""The yardstick of the kernels: the card's published peaks, and the bytes
and operations that one launch of a kernel needs, counted from its inputs.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 3.35 TB/s of HBM3 and 67 TFLOP/s of float32 outside the tensor
cores. A launch's bound is max(bytes / HBM rate, operations / f32 rate).

Each input byte that a launch needs is counted once, what it reads again
is not, and the count follows the data: a beam round's frontier names
some rows several times and, in lanes that have converged, names only
the sentinel slot; counting every slot as a fresh row and every lookup
table as read whole would put the bound above what the kernel must read,
and its share above 100%.
"""

from __future__ import annotations

import torch

HBM_BYTES_S = 3.35e12
F32_FLOPS = 67e12


def bound_s(nbytes: float, ops: float) -> float:
    """The least time of a launch that moves ``nbytes`` and does ``ops``."""
    return max(nbytes / HBM_BYTES_S, ops / F32_FLOPS)


def distinct_per_row(keys: torch.Tensor) -> int:
    """Σ over rows of the number of distinct values in the row."""
    if keys.numel() == 0:
        return 0
    s, _ = torch.sort(keys, dim=-1)
    return int(keys.shape[:-1].numel() + (s[..., 1:] != s[..., :-1]).sum())


def _lut_entries(row_codes: torch.Tensor) -> int:
    """Distinct (query, subspace, code) lookups of a launch: row_codes is
    (Q, R′, M), the code of each frontier slot in each subspace."""
    return distinct_per_row(row_codes.permute(0, 2, 1).long())


def hop_adc_cost(codes: torch.Tensor, ids: torch.Tensor, luts: torch.Tensor,
                 **_) -> tuple[int, int]:
    """(bytes, operations) of one ``hop_adc`` launch: (N+1, M) code rows,
    (Q, R′) ids, (Q, M, K) f32 LUTs → (Q, R′) f32.

    Bytes: the ids as int32, each distinct code row once, each distinct
    (query, subspace, code) LUT entry once at 4 bytes, the f32 output.
    Operations: one add per slot and subspace."""
    ids = ids.long()
    m = codes.shape[1]
    rows = int(torch.unique(ids).numel())
    entries = _lut_entries(codes[ids])
    nbytes = 4 * ids.numel() + rows * m * codes.element_size() + 4 * entries + 4 * ids.numel()
    return nbytes, ids.numel() * m


def hop_adc_fs_cost(packed: torch.Tensor, ids: torch.Tensor, luts_u8: torch.Tensor,
                    *_, **__) -> tuple[int, int]:
    """(bytes, operations) of one ``hop_adc_fs`` launch: (N+1, ceil(M/2))
    packed rows, (Q, R′) ids, (Q, M, 16) uint8 LUTs → (Q, R′) int32.

    Bytes: the ids as int32, each distinct packed row once, each distinct
    (query, subspace, nibble) LUT byte once, the int32 output. Operations:
    one add per slot and subspace."""
    ids = ids.long()
    m = luts_u8.shape[1]
    rows = int(torch.unique(ids).numel())
    p = packed[ids]                                              # (Q, R′, Mb)
    nib = torch.stack([p & 0xF, p >> 4], dim=-1).reshape(*p.shape[:2], -1)[..., :m]
    entries = _lut_entries(nib)
    nbytes = 4 * ids.numel() + rows * packed.shape[1] + entries + 4 * ids.numel()
    return nbytes, ids.numel() * m
