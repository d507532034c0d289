"""The one traffic generator: it reads a mix's file and drives the engine.

A mix's ``mode`` says how queries reach the engine:

- ``closed``: back-to-back ``search`` calls of ``batch`` fresh queries each,
  the next call once the last one's results are on the host (a caller
  that waits for each reply; ann-benchmarks' batch mode). The window lasts
  from the first call until the first call that ends after ``--seconds``.
- ``open``: single queries due as a Poisson stream at ``rate_qps`` (gaps
  from the mix's ``gap_seed`` and queries from its ``query_seed``, each
  pool in the order the run's seed draws); a greedy
  dispatcher hands each ``search`` call every query due so far, at most
  ``max_batch``. The window holds the queries due in ``--seconds``; they
  are all served, up to ``drain_s`` past the close, and a query's latency
  counts from its due time to its results being on the host.

Any other ``mode`` names a module ``perfbench/modes/<mode>.py`` (see
``harness.load_mode``), whose window may write to the engine between its
search calls and keeps a :class:`Writes` log of them.

Every call's results come to the host before the next call starts.
"""

from __future__ import annotations

import bisect
import dataclasses
import time

import numpy as np
import torch

from perfbench import gen


@dataclasses.dataclass
class Call:
    """One ``search`` call: its queries, host times (s from the window's
    start) and the program's counters: the call's round trips (its slowest
    lane's), and its sums of distance evaluations and hops."""
    n: int
    t0: float
    t1: float
    rounds: int
    n_dist: int
    hops: int
    log_pos: int = 0          # entries of the window's write log made before the call


@dataclasses.dataclass
class Writes:
    """The writes of a run's windows, in window order, for the reference to
    replay. Rows have stable keys: ``[0, n_base)`` are the base rows and the
    j-th inserted row gets ``n_base + j``. Entries of ``log``:

    - ``("insert", keys, ids)``: rows inserted, and the ids the engine gave them;
    - ``("delete", keys)``: rows deleted, by key;
    - ``("remap", id_to_key)``: after a consolidation, the engine's new map
      from ids to keys (-1: the id names no row).

    ``vectors`` holds the inserted rows in key order. A driver logs through
    :meth:`insert`, :meth:`delete` and :meth:`renumber`, which also keep its
    own view of which keys are live and under which id; the reference reads
    only the log and the vectors."""
    n_base: int
    log: list = dataclasses.field(default_factory=list)
    vectors: list = dataclasses.field(default_factory=list)

    def __post_init__(self):
        self.key_to_id = np.arange(self.n_base)
        self.live = np.ones(self.n_base, bool)

    def insert(self, vectors: torch.Tensor, ids) -> np.ndarray:
        """Log rows that the engine acknowledged under ``ids``; returns their keys."""
        ids = np.asarray(ids, np.int64)
        keys = np.arange(len(ids)) + len(self.key_to_id)
        self.log.append(("insert", keys, ids))
        self.vectors.append(vectors)
        self.key_to_id = np.concatenate([self.key_to_id, ids])
        self.live = np.concatenate([self.live, np.ones(len(ids), bool)])
        return keys

    def delete(self, keys) -> None:
        """Log keys whose delete the engine acknowledged."""
        keys = np.asarray(keys, np.int64)
        self.log.append(("delete", keys))
        self.live[keys] = False

    def renumber(self, old2new) -> None:
        """Log the map from ids to keys after a consolidation that moved the
        row under each old id to ``old2new[id]`` (-1: dropped)."""
        old2new = np.asarray(old2new, np.int64)
        named = np.flatnonzero(self.key_to_id >= 0)
        new = old2new[self.key_to_id[named]]
        kept = new >= 0
        id_to_key = np.full(int(new.max(initial=-1)) + 1, -1)
        id_to_key[new[kept]] = named[kept]
        self.log.append(("remap", id_to_key))
        self.key_to_id = np.full(len(self.key_to_id), -1)
        self.key_to_id[named[kept]] = new[kept]

    def live_keys(self) -> np.ndarray:
        """Keys live now that the engine names by an id."""
        return np.flatnonzero(self.live & (self.key_to_id >= 0))


@dataclasses.dataclass
class Window:
    calls: list
    queries: list             # per call, (n, D) on the device
    ids: list                 # per call, (n, k) on the host
    dists: list               # per call, (n, k) on the host
    latency_s: np.ndarray     # per answered query
    attempted: int
    window_s: float           # the window's length
    answered_in_window: int   # answered by the window's close
    late_s: float = 0.0       # open loop: the latest a call started after
    #                           the oldest query it took was due
    writes: Writes = None     # a writing mode's log; None: the window wrote nothing

    @property
    def answered(self) -> int:
        return int(sum(c.n for c in self.calls))


def search(engine, q: torch.Tensor, k: int, h: int):
    """One call; returns (ids, dists) on the host and (rounds, n_dist,
    hops) of the call."""
    res = engine.search(q, k=k, h=h)
    stats = torch.stack([res.rounds.max().long(), res.n_dist.sum().long(),
                         res.hops.sum().long()]).cpu()
    return res.ids.cpu(), res.dists.cpu(), tuple(int(v) for v in stats)


def closed_loop(engine, stream: gen.QueryStream, mix: dict, k: int, h: int,
                seconds: float) -> Window:
    calls, qs, ids, dists, lat = [], [], [], [], []
    t_start = time.perf_counter()
    now = 0.0
    while now < seconds:
        t0 = now
        q = stream.take(mix["batch"])
        i, d, (rounds, nd, hops) = search(engine, q, k, h)
        now = time.perf_counter() - t_start
        calls.append(Call(q.shape[0], t0, now, rounds, nd, hops))
        qs.append(q)
        ids.append(i)
        dists.append(d)
        lat.append(np.full(q.shape[0], now - t0))
    n = sum(c.n for c in calls)
    return Window(calls, qs, ids, dists, np.concatenate(lat), n, now, n)


def arrivals(mix: dict, seed: int, seconds: float) -> np.ndarray:
    """Due times of the queries due in ``[0, seconds)``."""
    n = int(mix["rate_qps"] * seconds * 1.2) + 1000
    due = gen.arrivals(mix["rate_qps"], n, mix["gap_seed"], seed)
    return due[due < seconds]


def open_loop(engine, queries: torch.Tensor, due: np.ndarray, mix: dict, k: int,
              h: int, seconds: float) -> Window:
    calls, qs, ids, dists = [], [], [], []
    lat = np.full(len(due), np.nan)
    late = 0.0
    t_start = time.perf_counter()
    i = 0
    while i < len(due):
        now = time.perf_counter() - t_start
        if now > seconds + mix["drain_s"]:
            break
        if due[i] > now:
            time.sleep(due[i] - now)
            continue
        j = min(bisect.bisect_right(due, now, lo=i), i + mix["max_batch"])
        late = max(late, now - due[i])
        q = queries[i:j]
        got_ids, got_d, (rounds, nd, hops) = search(engine, q, k, h)
        t1 = time.perf_counter() - t_start
        lat[i:j] = t1 - due[i:j]
        calls.append(Call(j - i, now, t1, rounds, nd, hops))
        qs.append(q)
        ids.append(got_ids)
        dists.append(got_d)
        i = j
    done = ~np.isnan(lat)
    in_window = int(np.sum(done & (due + np.nan_to_num(lat, nan=np.inf) <= seconds)))
    return Window(calls, qs, ids, dists, lat[done], len(due), seconds, in_window, late)
