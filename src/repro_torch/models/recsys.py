"""Retrieval scoring (the ``retrieval_cand`` shape): exact and PQ/ADC.

Port of ``score_candidates_exact`` and ``score_candidates_adc`` of
``repro/models/recsys.py``, the paper's ADC scan used as a recommender's
candidate scorer. Both top-ks break ties toward the lower index, as
``lax.top_k`` does (``search.engine.topk_lower``).
"""

from __future__ import annotations

import torch

from repro_torch.device import full_f32_matmul
from repro_torch.kernels import ops as kops
from repro_torch.search.engine import topk_lower


def score_candidates_exact(query_vec: torch.Tensor, cand_emb: torch.Tensor,
                           k: int = 100) -> tuple[torch.Tensor, torch.Tensor]:
    """(D,) × (N, D) → top-k (scores descending, int32 ids): one GEMV, the
    baseline."""
    full_f32_matmul()
    scores = cand_emb @ query_vec
    neg, ids = topk_lower(-scores[None, :], k)
    return -neg[0], ids[0].to(torch.int32)


def score_candidates_adc(lut: torch.Tensor, cand_codes: torch.Tensor,
                         k: int = 100) -> tuple[torch.Tensor, torch.Tensor]:
    """(M, K) LUT × (N, M) codes → top-k (distances ascending, int32 ids):
    the one-query ``adc_scan`` kernel on the card."""
    d = kops.adc_scan(cand_codes, lut)
    vals, ids = topk_lower(d[None, :], k)
    return vals[0], ids[0].to(torch.int32)
