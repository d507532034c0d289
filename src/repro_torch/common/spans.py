"""Spans and counters of the search path, kept in memory.

The port's own record of where a search call spends its time, for a traced
run to read (the JAX package has no counterpart). The recorder is off until
:func:`enable` switches it on, and off again by the same call; nothing else
switches it. Each site tests the module flag :data:`on` first, so while the
recorder is off a site costs that one test, with no clock read and no
allocation::

    sp = spans.begin("search.lut") if spans.on else -1
    luts = lut_fn(queries)
    if sp >= 0:
        spans.end(sp)

While it is on, each span keeps its name, its start and end on one monotonic
clock (:func:`now_ns`, ``time.perf_counter_ns``), the index of its parent
span and the id of its call: a span begun while no span is open is the root
of a new call, and every span inside it carries the root's id. A counter
(:func:`count`) belongs to the call of the innermost open span (-1 outside
any). Spans and counters stay in memory until :func:`drain` returns and
clears them. The recorder serves one thread: the caller that searches.

Spans of the search path (``search/engine.py``, ``search/beam.py``):
``search`` (the root of a call), ``search.lut``, ``search.route``,
``beam.init``, ``beam.round`` (one per round of the lockstep loop) and
``search.rerank``; counters ``sync``, one per wait of the host for the
card, and ``beam.fused``, one per classic round (``expand=1``, no hop
pruning), which runs through ``ops.beam_expand`` and ``ops.beam_merge``.
"""

from __future__ import annotations

import dataclasses
import time

now_ns = time.perf_counter_ns

on = False
_spans: list = []       # [name, start_ns, end_ns, parent, call] per span
_open: list = []        # indices of the open spans, innermost last
_counts: dict = {}      # (name, call) -> count
_next_call = 0


@dataclasses.dataclass(frozen=True)
class Span:
    name: str
    start_ns: int
    end_ns: int            # -1 for a span still open when drained
    parent: int            # index of the parent in the drained list; -1 for a root
    call: int              # id of the call (the root's)


def enable(flag: bool = True) -> None:
    """Switch the recorder on (``True``) or off."""
    global on
    on = bool(flag)


def begin(name: str) -> int:
    """Open a span inside the innermost open one; returns its index for
    :func:`end`."""
    global _next_call
    if _open:
        parent = _open[-1]
        call = _spans[parent][4]
    else:
        parent, call = -1, _next_call
        _next_call += 1
    i = len(_spans)
    _spans.append([name, now_ns(), -1, parent, call])
    _open.append(i)
    return i


def end(i: int) -> None:
    """Close span ``i`` and any span still open inside it (one that an
    exception left open); a span no longer open is left as it is."""
    if i not in _open:
        return
    t = now_ns()
    while True:
        j = _open.pop()
        _spans[j][2] = t
        if j == i:
            return


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the innermost open span's call."""
    key = (name, _spans[_open[-1]][4] if _open else -1)
    _counts[key] = _counts.get(key, 0) + n


def drain() -> tuple[list[Span], dict]:
    """The spans recorded so far, by start, and the counters as
    ``{(name, call): count}``; both are cleared."""
    global _spans, _counts
    got, counts = [Span(*s) for s in _spans], _counts
    _spans, _counts = [], {}
    _open.clear()
    return got, counts
