"""The traced run: ``torch.profiler`` over a short window run after the
measured one, the device's operations and busy time read from it, and
recorders around the program's kernel entry points.

Only a ``--trace 1`` run comes here; the untraced run installs nothing.
"""

from __future__ import annotations

import bisect
import dataclasses
import functools
import importlib
import time

import torch

OUTSIDE = "bench: between search calls"


@dataclasses.dataclass
class Launch:
    """One recorded call of a kernel entry point: its arguments, kept by
    reference until the window has closed."""
    args: tuple
    kwargs: dict


class Recorder:
    """Replaces ``module.name`` by a function that keeps each call's
    arguments (by reference, at most ``max_bytes`` of id tensors) while
    ``on``, then calls the original. :meth:`remove` puts the original
    back."""

    def __init__(self, module_name: str, name: str, max_bytes: int):
        self.module = importlib.import_module(module_name)
        self.name = name
        self.orig = getattr(self.module, name)
        self.launches: list[Launch] = []
        self.calls = 0
        self.on = False
        self.kept_bytes = 0
        self.max_bytes = max_bytes

        def recorded(*args, **kwargs):
            if self.on:
                ids = args[1]
                if ids.numel():
                    self.calls += 1
                    if self.kept_bytes + ids.nbytes <= self.max_bytes:
                        self.launches.append(Launch(args, kwargs))
                        self.kept_bytes += ids.nbytes
            return self.orig(*args, **kwargs)

        setattr(self.module, name, recorded)

    def remove(self) -> None:
        setattr(self.module, self.name, self.orig)


@dataclasses.dataclass
class DeviceTrace:
    """What the profiler saw: device operations as (name, start s, end s)
    on the profiler's clock, host operations (CUDA runtime calls) likewise,
    the window, and the benchmark's own spans (search calls, LUT builds)
    moved onto that clock."""
    device_ops: list
    host_ops: list
    window: tuple
    spans: list = dataclasses.field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals inside the window,
        as sorted disjoint (start, end) pairs."""
        lo, hi = self.window
        spans = sorted((max(s, lo), min(e, hi)) for _, s, e in self.device_ops
                       if e > lo and s < hi)
        merged = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [tuple(m) for m in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def kernels(self, pattern: str) -> list:
        """Device operations whose name holds ``pattern``, by start."""
        return sorted((op for op in self.device_ops if pattern in op[0]),
                      key=lambda op: op[1])

    def top_ops(self, n: int = 10) -> list:
        """[name, seconds] of the n device operations that took most time."""
        total = {}
        for name, s, e in self.device_ops:
            total[name] = total.get(name, 0.0) + (e - s)
        return [[k[:120], v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_by_host(self, n: int = 10) -> list:
        """[name, seconds] of idle device time by what the host was doing:
        each gap between busy intervals goes to the host operation running
        at its midpoint (a CUDA runtime call), else to the innermost of the
        benchmark's spans covering it (a LUT build inside a search call, a
        search call), else to OUTSIDE; the n largest sums."""
        gaps, prev = [], self.window[0]
        for s, e in self.busy_intervals() + [(self.window[1], self.window[1])]:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        total = {}
        for a, b in gaps:
            mid = 0.5 * (a + b)
            name = _covering(self._host, mid) or _covering(self._spans, mid) or OUTSIDE
            total[name] = total.get(name, 0.0) + (b - a)
        return [[k[:120], v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    @functools.cached_property
    def _host(self):
        return _by_start(self.host_ops)

    @functools.cached_property
    def _spans(self):
        return _by_start(self.spans)


def _by_start(ops: list) -> tuple:
    ops = sorted(ops, key=lambda op: op[1])
    return ops, [op[1] for op in ops]


def _covering(indexed: tuple, t: float, look_back: int = 64):
    """The name of the latest-starting operation that covers ``t`` among
    the ``look_back`` that start last before it (the innermost, for nested
    spans), or None."""
    ops, starts = indexed
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 1 - look_back), -1):
        if ops[j][2] >= t:
            return ops[j][0]
    return None


class Tracer:
    """``torch.profiler`` over the card (CUDA activity only: the kernels,
    copies and the CUDA runtime calls that launched them; recording every
    host operator as well doubled the host's time per beam round, so the
    per-layer numbers would have measured the profiler) while the block
    runs; on the CPU, the CPU's operators.

    The profiler's clock is not the host's: the window opens and closes
    with a ``torch.cuda.synchronize()`` whose runtime call the trace holds,
    and the benchmark's host spans (stamped with ``time.time``) are moved
    onto the profiler's clock by the first one's offset. :meth:`finish`
    leaves the :class:`DeviceTrace` in :attr:`trace`."""

    SYNC = "cudaDeviceSynchronize"

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        t0 = time.perf_counter()
        self.on_card = torch.cuda.is_available()
        self.prof = profile(activities=[ProfilerActivity.CUDA if self.on_card
                                        else ProfilerActivity.CPU])
        self.prof.__enter__()
        self.h0 = self._mark()
        self.start_s = time.perf_counter() - t0
        return self

    def _mark(self) -> float:
        if self.on_card:
            torch.cuda.synchronize()
        return time.time()

    def finish(self, spans: list) -> None:
        """Stop; ``spans`` are the benchmark's (name, start s, end s) host
        spans on the host's clock (``time.time``)."""
        h1 = self._mark()
        t_stop = time.perf_counter()
        self.prof.__exit__(None, None, None)
        t_read = time.perf_counter()
        self.trace = self._read((self.h0, h1), spans)
        self.cost_s = {"start": self.start_s, "stop": t_read - t_stop,
                       "read": time.perf_counter() - t_read}

    def _read(self, host_window: tuple, spans: list) -> DeviceTrace:
        dev_ops, host_ops, syncs = [], [], []
        cuda = torch.autograd.DeviceType.CUDA
        for ev in self.prof.profiler.kineto_results.events():
            s = ev.start_ns() * 1e-9
            e = s + ev.duration_ns() * 1e-9
            name = ev.name()
            if ev.device_type() == cuda:
                if not ev.is_user_annotation():
                    dev_ops.append((name, s, e))
            else:
                host_ops.append((name, s, e))
                if name == self.SYNC:
                    syncs.append(e)
        if len(syncs) >= 2:
            window = (min(syncs), max(syncs))
        elif not self.on_card:
            window = host_window
        else:
            raise RuntimeError("the trace holds no synchronization marking the window")
        shift = window[0] - host_window[0]
        return DeviceTrace(dev_ops, host_ops, window,
                           [(n, a + shift, b + shift) for n, a, b in spans])
