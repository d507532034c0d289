"""Plain PyTorch versions of the kernels on the serving path.

Each is the semantics contract of one CUDA kernel (``kernels/csrc/``) and a
port of the JAX oracle of the same name in ``repro/kernels/ref.py``. The
CPU path of ``kernels/ops.py`` runs them; ``chip_smoke.py`` holds each
kernel against its plain version on the card. Inputs arrive in the
canonical dtypes fixed by ``ops``: uint8 codes, int32 ids, f32 LUTs.
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


def pq_pairwise_ref(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """(N, M, dsub) sub-vectors × (M, K, dsub) codewords → (N, M, K) f32
    ``||x[n, j] - codebook[j, k]||^2`` as ``x² − 2·x·c + c²``."""
    x = x.float()
    c = codebook.float()
    x2 = (x * x).sum(dim=-1)[:, :, None]               # (N, M, 1)
    c2 = (c * c).sum(dim=-1)[None, :, :]               # (1, M, K)
    xc = torch.einsum("nmd,mkd->nmk", x, c)            # (N, M, K)
    return x2 - 2.0 * xc + c2
