"""Int8 gradient compression with error feedback (EF-SGD style).

Port of ``repro/dist/compression.py``. Data-parallel training averages a
gradient tree every step; each leaf is quantized to int8 with a single
per-leaf scale (max-abs / 127), and the quantization residual is carried
in a per-replica error-feedback state and added back before the next
step's quantization, so the *accumulated* compressed gradient stays within
one quantization step of the true sum (Karimireddy et al. 2019) instead of
drifting by O(steps).

The (q, scale) pair is what would travel on the wire: 4 bytes an element
become 1 byte plus one f32 scale per leaf. ``torch.round`` rounds half to
even as ``jnp.round`` does, so the results equal the reference's bit for
bit on the same f32 inputs.
"""

from __future__ import annotations

import torch

from repro_torch.common.treeutil import tree_leaves, tree_map, tree_unflatten


def init_state(tree):
    """Zero error-feedback residuals, one f32 buffer per gradient leaf."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), tree)


def quantize_leaf(g: torch.Tensor, err: torch.Tensor):
    """Quantize one leaf (with its EF residual folded in).

    Returns ``(q int8, scale f32 scalar, new_err f32)`` where
    ``dequantize_leaf(q, scale) + new_err == g + err`` exactly."""
    corrected = g.float() + err
    amax = corrected.abs().max()
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(corrected / scale), -127, 127).to(torch.int8)
    new_err = corrected - q.float() * scale
    return q, scale, new_err


def dequantize_leaf(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_tree(tree, state):
    """Compress a gradient tree under error feedback.

    Returns ``((q_tree, scale_tree), new_state)`` — the pair mirrors the
    original tree structure and is what :func:`decompress_tree` consumes."""
    out = [quantize_leaf(g, e) for g, e in zip(tree_leaves(tree), tree_leaves(state))]
    q_tree = tree_unflatten(tree, [o[0] for o in out])
    s_tree = tree_unflatten(tree, [o[1] for o in out])
    return (q_tree, s_tree), tree_unflatten(tree, [o[2] for o in out])


def decompress_tree(compressed):
    q_tree, s_tree = compressed
    return tree_map(dequantize_leaf, q_tree, s_tree)
