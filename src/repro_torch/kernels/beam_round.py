"""Wrapper of the classic beam round's two kernels (``csrc/beam_round.cu``).

Replaces no TPU kernel: the JAX package's beam round is XLA ops inside its
while loop. Here a classic round (``expand=1``, no hop pruning) of
:func:`repro_torch.search.beam.beam_search` is ``beam_expand``, the
distance call, ``beam_merge``: three launches and one wait, in place of an
op chain of 96 launches and three stable sorts. Both kernels update the
beam's state in place; design and bound are noted in the source. Callers go
through :func:`repro_torch.kernels.ops.beam_expand` and
:func:`repro_torch.kernels.ops.beam_merge`, which send CPU tensors to the
plain versions (``kernels/ref.py``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# kernel launches since the last reset
launches_expand = 0
launches_merge = 0

MAX_H = 256    # beam slots a warp holds (8 chunks of 32)
MAX_R = 128    # frontier slots a warp holds (4 chunks of 32)
NO_CAP = 2 ** 63 - 1

_fns: dict = {}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_ARGS = {"beam_expand_launch": [_P, _L, _I, _P, _P, _P, _P, _P, _L, _P, _P, _I, _I,
                                _P, _P, _P, _P],
         "beam_merge_launch": [_P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _P, _P,
                               _P, _L, _L, _L, _P, _P]}


def _entry(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load("beam_round"), name)
        fn.argtypes = _ARGS[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check(fn: str, gpu: int, specs) -> None:
    """Each (name, tensor, dtype, shape) of ``specs`` on CUDA device
    ``gpu``, of the dtype and shape, contiguous. Cheap on purpose: it runs
    twice a beam round."""
    for name, t, dtype, shape in specs:
        if (t.get_device() != gpu or t.dtype != dtype or t.shape != shape
                or not t.is_contiguous()):
            raise ValueError(f"{fn}: {name} must be a contiguous {dtype} tensor of shape "
                             f"{tuple(shape)} on cuda:{gpu}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def _limits(fn: str, ids: torch.Tensor, h: int, r: int) -> int:
    """The CUDA device index of the beam, within the kernels' limits."""
    if not (1 <= h <= MAX_H and 1 <= r <= MAX_R):
        raise ValueError(f"{fn}: takes 1 <= h <= {MAX_H} beam slots and 1 <= R <= "
                         f"{MAX_R} neighbors, got h={h}, R={r}")
    if not ids.is_cuda:
        raise ValueError(f"{fn}: the beam must be on a CUDA device, got {ids.device}")
    return ids.get_device()


def beam_expand(neighbors: torch.Tensor, ids: torch.Tensor, dists: torch.Tensor,
                exp: torch.Tensor, live: torch.Tensor, visited: torch.Tensor,
                hops: torch.Tensor, ndist: torch.Tensor, count: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Expand each live lane's best unexpanded entry: (N, R) int32
    neighbors, the (Q, h) sorted beam (int64 ids, f32 dists, bool
    expanded), (Q,) bool live, (Q, W) int32 visited bitsets, (Q,) int32
    hops and n_dist → the (Q, R) int32 frontier ids (0 where not fresh) and
    (Q, R) bool fresh mask. Marks the entry expanded, sets the frontier's
    visited bits and counts its hop and its fresh ids, in place; clears the
    0-d int32 ``count`` that :func:`beam_merge` fills."""
    global launches_expand
    q, h = ids.shape
    n, r = neighbors.shape
    gpu = _limits("beam_expand", ids, h, r)
    nwords = visited.shape[-1]
    _check("beam_expand", gpu, (
        ("neighbors", neighbors, torch.int32, (n, r)), ("ids", ids, torch.int64, (q, h)),
        ("dists", dists, torch.float32, (q, h)), ("exp", exp, torch.bool, (q, h)),
        ("live", live, torch.bool, (q,)), ("visited", visited, torch.int32, (q, nwords)),
        ("hops", hops, torch.int32, (q,)), ("ndist", ndist, torch.int32, (q,)),
        ("count", count, torch.int32, ())))
    if nwords * 32 < n:
        raise ValueError(f"beam_expand: {nwords} visited words do not cover {n} ids")
    front = torch.empty((q, r), dtype=torch.int32, device=ids.device)
    fresh = torch.empty((q, r), dtype=torch.bool, device=ids.device)
    err = _entry("beam_expand_launch")(
        neighbors.data_ptr(), n, r, ids.data_ptr(), dists.data_ptr(), exp.data_ptr(),
        live.data_ptr(), visited.data_ptr(), nwords, hops.data_ptr(), ndist.data_ptr(),
        q, h, front.data_ptr(), fresh.data_ptr(), count.data_ptr(),
        _build.stream_handle(ids.device))
    _build.check("beam_round", err)
    launches_expand += 1
    return front, fresh


def beam_merge(ids: torch.Tensor, dists: torch.Tensor, exp: torch.Tensor,
               front: torch.Tensor, fresh: torch.Tensor, front_d: torch.Tensor,
               live: torch.Tensor, step: torch.Tensor, ndist: torch.Tensor,
               count: torch.Tensor, *, n: int, tombstones=None, max_steps: int,
               max_rounds=None, max_n_dist=None) -> torch.Tensor:
    """Merge :func:`beam_expand`'s frontier, scored as (Q, R) f32
    ``front_d``, into the beam of each live lane, as a stable sort of beam
    ++ frontier keeps the h best (a frontier slot not fresh, or a
    tombstoned id in the (W,) int32 bitset ``tombstones``, ranks +inf; one
    not fresh carries the sentinel id ``n``); then count the round in
    ``step`` and re-evaluate ``live`` under ``max_steps`` and the budgets
    (None: no cap). All in place; returns ``count``, the number of live
    lanes."""
    global launches_merge
    q, h = ids.shape
    r = front.shape[-1]
    gpu = _limits("beam_merge", ids, h, r)
    _check("beam_merge", gpu, (
        ("ids", ids, torch.int64, (q, h)), ("dists", dists, torch.float32, (q, h)),
        ("exp", exp, torch.bool, (q, h)), ("front", front, torch.int32, (q, r)),
        ("fresh", fresh, torch.bool, (q, r)), ("front_d", front_d, torch.float32, (q, r)),
        ("live", live, torch.bool, (q,)), ("step", step, torch.int32, (q,)),
        ("ndist", ndist, torch.int32, (q,)), ("count", count, torch.int32, ())))
    tomb = None
    if tombstones is not None:
        _check("beam_merge", gpu, (("tombstones", tombstones, torch.int32,
                                    (tombstones.numel(),)),))
        if tombstones.numel() * 32 < n:
            raise ValueError(f"beam_merge: {tombstones.numel()} tombstone words "
                             f"do not cover {n} ids")
        tomb = tombstones.data_ptr()
    caps = [NO_CAP if c is None else min(int(c), NO_CAP)
            for c in (max_steps, max_rounds, max_n_dist)]
    err = _entry("beam_merge_launch")(
        ids.data_ptr(), dists.data_ptr(), exp.data_ptr(), front.data_ptr(),
        fresh.data_ptr(), front_d.data_ptr(), tomb, n, q, h, r, live.data_ptr(),
        step.data_ptr(), ndist.data_ptr(), *caps, count.data_ptr(),
        _build.stream_handle(ids.device))
    _build.check("beam_round", err)
    launches_merge += 1
    return count
