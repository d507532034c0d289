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
from typing import Any, Callable, NamedTuple

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


def adam(schedule: Schedule, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    """Adam with f32 moments (the reference's ``weight_decay``,
    ``slot_dtype`` and ``chunk_bytes`` serve the model zoo and wait for
    it)."""

    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        step = torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)
        return OptState(step, (tree_map(zeros, params), tree_map(zeros, params)))

    def update(grads, state: OptState, params):
        m0, v0 = state.inner
        step = state.step + 1
        lr = schedule(state.step)
        stepf = step.to(torch.float32)
        bc1 = 1 - torch.pow(_f32(b1, stepf), stepf)
        bc2 = 1 - torch.pow(_f32(b2, stepf), stepf)

        def upd(p, g, m, v):
            g32 = g.float()
            m32 = b1 * m + (1 - b1) * g32
            v32 = b2 * v + (1 - b2) * g32 * g32
            delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + eps)
            return (p.float() - lr * delta).to(p.dtype), m32, v32

        out = [upd(*leaves) for leaves in zip(
            tree_leaves(params), tree_leaves(grads), tree_leaves(m0), tree_leaves(v0))]
        new = [tree_unflatten(params, [o[i] for o in out]) for i in range(3)]
        return new[0], OptState(step, (new[1], new[2]))

    return Optimizer(init, update)

