"""churn: rounds of writes, then one search call of ``batch`` fresh
queries. A round's writes: ``delete`` live rows drawn from the run's seed,
``insert`` new rows, and every ``consolidate_every`` rounds a
consolidation. The
inserted rows come from ``gen.QueryStream`` under the mix's
``insert_seed``, the same rows for every run seed. Writes are timed inside
the window, between search calls; a call's latency is its own."""

import time

import numpy as np
import torch

from perfbench import gen, traffic


def warm_shapes(mix):
    return [mix["batch"]]


def driver(st, seed, seconds):
    mix, eng, k, h = st.mix, st.idx.engine, st.cfg["k"], st.cfg["beam_h"]
    writes = traffic.Writes(st.x.shape[0])
    queries = gen.QueryStream(st.data, seed, st.device)
    rows = gen.QueryStream(st.data, mix["insert_seed"], st.device)
    draw = gen.generator("cpu", seed, gen.ORDER)
    rounds = [0]

    def write():
        rounds[0] += 1
        live = writes.live_keys()
        gone = live[torch.randperm(len(live), generator=draw)[:mix["delete"]].numpy()]
        eng.delete(writes.key_to_id[gone])
        writes.delete(gone)
        new = rows.take(mix["insert"])
        writes.insert(new, eng.insert(new))
        if rounds[0] % mix["consolidate_every"] == 0:
            writes.renumber(eng.consolidate()["old2new"])

    def window(length):
        calls, qs, ids, dists, lat = [], [], [], [], []
        t_start = time.perf_counter()
        now = 0.0
        while now < length:
            write()
            now = time.perf_counter() - t_start
            q = queries.take(mix["batch"])
            i, d, (n_rounds, nd, hops) = traffic.search(eng, q, k, h)
            t1 = time.perf_counter() - t_start
            calls.append(traffic.Call(q.shape[0], now, t1, n_rounds, nd, hops, len(writes.log)))
            qs.append(q)
            ids.append(i)
            dists.append(d)
            lat.append(np.full(q.shape[0], t1 - now))
            now = t1
        n = sum(c.n for c in calls)
        return traffic.Window(calls, qs, ids, dists, np.concatenate(lat), n, now, n,
                              writes=writes)

    return window
