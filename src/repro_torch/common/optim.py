"""The reference's own Adam and learning-rate schedules, not ``torch.optim``.

Port of ``repro/common/optim.py``. Parameters are a tree of tensors (a
named tuple such as ``core.quantizer.RPQParams``); the state is an
:class:`OptState` of the same trees. ``update`` is functional: it returns
new tensors and leaves its inputs alone.

Numerics follow JAX's f32 arithmetic: every schedule value and both bias
corrections are f32 tensors (``b1 ** step`` in Python floats would be f64
and drift from JAX's f32 ``pow``), and a Python float meets an f32 tensor
the way a weakly typed JAX scalar does — rounded to f32 first.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.common.treeutil import (global_norm, tree_leaves, tree_map,
                                        tree_unflatten)

Schedule = Callable[[torch.Tensor], torch.Tensor]  # step -> lr (f32, 0-d)


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def constant_schedule(lr: float) -> Schedule:
    def sched(step):
        return _f32(lr, torch.as_tensor(step))
    return sched


def cosine_schedule(lr: float, total_steps: int, final_frac: float = 0.0) -> Schedule:
    """Cosine decay from ``lr`` to ``lr * final_frac`` over ``total_steps``."""
    def sched(step):
        step = torch.as_tensor(step)
        t = torch.clamp(step / max(total_steps, 1), 0.0, 1.0).to(torch.float32)
        cos = 0.5 * (1 + torch.cos(_f32(math.pi, t) * t))
        return _f32(lr, t) * (final_frac + (1 - final_frac) * cos)
    return sched


def warmup_cosine(lr: float, total_steps: int, warmup_steps: int,
                  final_frac: float = 0.0) -> Schedule:
    """Linear warm-up to ``lr`` over ``warmup_steps``, then the cosine of
    :func:`cosine_schedule` over the remaining steps."""
    def sched(step):
        step = torch.as_tensor(step)
        warm = (_f32(lr, step) * step) / max(warmup_steps, 1)
        t = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1),
                        0.0, 1.0).to(torch.float32)
        cos = _f32(lr, t) * (final_frac + (1 - final_frac) * 0.5
                             * (1 + torch.cos(_f32(math.pi, t) * t)))
        return torch.where(step < warmup_steps, warm, cos)
    return sched


def one_cycle(lr: float, total_steps: int, pct_start: float = 0.3,
              div_factor: float = 25.0, final_div_factor: float = 1e4) -> Schedule:
    """One-cycle LR: linear ramp from ``lr / div_factor`` to ``lr``, then a
    cosine anneal to ``lr / final_div_factor`` (the paper's recipe, §6)."""
    up_steps = max(int(total_steps * pct_start), 1)
    down_steps = max(total_steps - up_steps, 1)
    lo0 = lr / div_factor
    lo1 = lr / final_div_factor

    def sched(step):
        step = torch.as_tensor(step).to(torch.float32)
        up = _f32(lo0, step) + _f32(lr - lo0, step) * torch.clamp(
            step / _f32(up_steps, step), 0.0, 1.0)
        t = torch.clamp((step - _f32(up_steps, step)) / _f32(down_steps, step),
                        0.0, 1.0)
        cos = torch.cos(_f32(math.pi, step) * t)
        down = _f32(lo1, step) + _f32((lr - lo1) * 0.5, step) * (1 + cos)
        return torch.where(step < up_steps, up, down)
    return sched


class OptState(NamedTuple):
    step: torch.Tensor  # () int32
    inner: Any          # optimizer-specific slots


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], OptState]
    update: Callable[[Any, OptState, Any], tuple[Any, OptState]]
    # update(grads, state, params) -> (new_params, new_state)


def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` by ``min(1, max_norm / (norm + 1e-12))``; returns the
    scaled tree and the norm before clipping."""
    norm = global_norm(grads)
    scale = torch.clamp(_f32(max_norm, norm) / (norm + _f32(1e-12, norm)), max=1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), norm


def _weak(x: float, like: torch.Tensor) -> torch.Tensor:
    """A Python float meeting ``like`` as JAX's weakly typed scalar does:
    rounded to ``like``'s dtype first (PyTorch would keep it in f32 for a
    bf16 tensor)."""
    return torch.tensor(x, dtype=like.dtype, device=like.device)


def sgd(schedule: Schedule, momentum: float = 0.0, nesterov: bool = False,
        weight_decay: float = 0.0) -> Optimizer:
    """SGD with optional (Nesterov) momentum and L2 weight decay; the
    momentum buffer keeps each param's dtype."""

    def init(params):
        m = tree_map(torch.zeros_like, params) if momentum else None
        step = torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)
        return OptState(step, m)

    def update(grads, state: OptState, params):
        lr = schedule(state.step)
        if weight_decay:
            grads = tree_map(lambda g, p: g + _weak(weight_decay, g) * p.to(g.dtype),
                             grads, params)
        if momentum:
            m = tree_map(lambda mm, g: _weak(momentum, mm) * mm + g, state.inner, grads)
            eff = (tree_map(lambda mm, g: g + _weak(momentum, mm) * mm, m, grads)
                   if nesterov else m)
        else:
            m, eff = None, grads
        new_params = tree_map(lambda p, g: (p - lr * g.float()).to(p.dtype), params, eff)
        return new_params, OptState(state.step + 1, m)

    return Optimizer(init, update)


def adam(schedule: Schedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0, slot_dtype: Optional[torch.dtype] = None,
         chunk_bytes: int = 1 << 62) -> Optimizer:
    """AdamW. The moments are stored in ``slot_dtype``, else in a floating
    param's own dtype (f32 for any other); the update math runs in f32.
    A leaf of two or more dims whose f32 size passes ``chunk_bytes`` is
    updated one leading index at a time (the same numbers, less scratch)."""

    def _slot(p):
        dt = slot_dtype or (p.dtype if p.is_floating_point() else torch.float32)
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    def init(params):
        step = torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)
        return OptState(step, (tree_map(_slot, params), tree_map(_slot, params)))

    def update(grads, state: OptState, params):
        m0, v0 = state.inner
        step = state.step + 1
        lr = schedule(state.step)
        stepf = step.to(torch.float32)
        bc1 = 1 - torch.pow(_f32(b1, stepf), stepf)
        bc2 = 1 - torch.pow(_f32(b2, stepf), stepf)

        def upd_math(p, g, m, v):
            g32 = g.float()
            m32 = b1 * m.float() + (1 - b1) * g32
            v32 = b2 * v.float() + (1 - b2) * g32 * g32
            delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + eps)
            if weight_decay:
                delta = delta + weight_decay * p.float()
            return (p.float() - lr * delta).to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)

        def upd(p, g, m, v):
            if not (p.dim() >= 2 and p.shape[0] > 1 and p.numel() * 4 > chunk_bytes):
                return upd_math(p, g, m, v)
            outs = (torch.empty_like(p), torch.empty_like(m), torch.empty_like(v))
            for i in range(p.shape[0]):
                for out, part in zip(outs, upd_math(p[i], g[i], m[i], v[i])):
                    out[i] = part
            return outs

        out = [upd(*leaves) for leaves in zip(
            tree_leaves(params), tree_leaves(grads), tree_leaves(m0), tree_leaves(v0))]
        new = [tree_unflatten(params, [o[i] for o in out]) for i in range(3)]
        return new[0], OptState(step, (new[1], new[2]))

    return Optimizer(init, update)
