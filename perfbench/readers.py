"""What the metric readers (``perfbench/metrics/<name>.py``) share: each
takes a run's ``harness.Record`` and returns a number, or ``None`` when the
run holds nothing to read (the harness then leaves the metric out)."""

from __future__ import annotations

import numpy as np

from perfbench import roofline


def calls(rec):
    """The measured window's search calls (in a traced run too: the
    profiler runs only after it)."""
    return rec.window.calls or None


def beam_rounds(rec):
    """Mean over calls of the call's round trips (its slowest lane's)."""
    c = calls(rec)
    return None if c is None else float(np.mean([x.rounds for x in c]))


def round_ms(rec):
    """Host wall time (the benchmark's clock) of the search calls over all
    their round trips."""
    c = calls(rec)
    rounds = sum(x.rounds for x in c) if c else 0
    return None if not rounds else 1e3 * sum(x.t1 - x.t0 for x in c) / rounds


def n_dist_per_query(rec):
    """Mean distance evaluations per query."""
    c = calls(rec)
    return None if c is None else sum(x.n_dist for x in c) / sum(x.n for x in c)


def batch_queries(rec):
    """Mean queries per search call."""
    c = calls(rec)
    return None if c is None else float(np.mean([x.n for x in c]))


def device_idle(rec):
    """Percent of the traced window in which no operation ran on the card."""
    t = rec.trace
    if t is None or not t.device_ops or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)


def kernel_roofline(rec, entry, kernel: str, cost):
    """Percent of its bound at which a kernel ran: Σ bound / Σ device time
    over the window's launches whose arguments were kept, each launch of
    the entry point ``entry`` matched in order to one device kernel whose
    name holds ``kernel``. ``None`` when the trace holds no such kernel or
    the launches and kernels do not pair up."""
    r = rec.recorders.get(entry)
    if rec.trace is None or r is None or not r.launches:
        return None
    ks = rec.trace.kernels(kernel)
    if len(ks) != r.calls:
        return None
    bound = sum(roofline.bound_s(*cost(*ln.args, **ln.kwargs)) for ln in r.launches)
    busy = sum(e - s for _, s, e in ks[:len(r.launches)])
    return 100.0 * bound / busy if busy > 0 else None
