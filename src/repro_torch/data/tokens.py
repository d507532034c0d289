"""Synthetic LM token streams (for the arch-zoo smoke/e2e paths). Port of
``repro/data/tokens.py``: numpy only, so the same draws bit for bit.

Zipfian unigram draw with a deterministic per-document seed — enough
structure that a reduced LM's loss visibly falls below the uniform-entropy
ceiling within a few hundred steps, with zero external data."""

from __future__ import annotations

import numpy as np


def zipf_tokens(seed: int, batch: int, seq_len: int, vocab: int,
                alpha: float = 1.1) -> np.ndarray:
    """(batch, seq_len) int32 tokens, Zipf(alpha) over [0, vocab)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = ranks ** (-alpha)
    probs /= probs.sum()
    return rng.choice(vocab, size=(batch, seq_len), p=probs).astype(np.int32)


def lm_batch(seed: int, batch: int, seq_len: int, vocab: int):
    """(tokens, labels) = next-token pairs from one Zipf draw."""
    toks = zipf_tokens(seed, batch, seq_len + 1, vocab)
    return toks[:, :-1].copy(), toks[:, 1:].copy()
