"""Deadline-aware degradation ladder (DESIGN.md §13).

A copy of ``repro/search/degrade.py`` (plain Python): the same rungs, the
same overrides, filtered against each port engine's ``search`` signature.

When a serving deadline tightens — a straggler shard, a slow disk, a load
spike — the right response is not a timeout error but a CHEAPER answer:
every rung below trades a known quantity of recall for a known quantity of
compute, in a fixed order, so operators reason about "level 3" instead of
a combinatorial knob space.

The ladder steps down the adaptive-routing configuration (DESIGN.md §11)
first — those knobs buy recall with extra work, so they are the first
work to shed — then drops the exact-rerank pass, then the delta scan:

* **L0** — full configuration, nothing shed.
* **L1** — frontier batching off (``expand=1``): one expansion per round,
  the smallest per-round distance bill.
* **L2** — multi-entry seeding off (``entries=1``): skip the coarse-index
  probe, route from the medoid alone.
* **L3** — aggressive hop pruning (``prune_eps`` raised to
  :data:`AGGRESSIVE_PRUNE_EPS`): the partial-LUT lower bound gates more
  full scores, accepting more wrong prunes.
* **L4** — exact rerank off (``rerank=-1``): answer straight from the ADC
  beam (engines without a rerank pass ignore this rung).
* **L5** — delta scan off (``skip_delta=True``): fresh inserts go
  invisible until the next consolidation (StreamingEngine only).

Rungs are CUMULATIVE: level 3 applies L1+L2+L3. :meth:`DegradationPolicy
.apply` filters the overrides against the target engine's ``search``
signature, so one policy drives every engine — a rung an engine cannot
express is simply skipped there. Compute budgets (``max_rounds`` /
``max_n_dist``) are orthogonal: the ladder changes WHAT work a round does,
budgets bound HOW MANY rounds run; launch/serve.py applies both.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Optional

AGGRESSIVE_PRUNE_EPS = 0.5

# rung → the search-kwarg overrides it adds (cumulative over lower rungs)
_LADDER: tuple[dict, ...] = (
    {},                                        # L0: full
    {"expand": 1},                             # L1: no frontier batching
    {"entries": 1},                            # L2: no multi-entry seeding
    {"prune_eps": AGGRESSIVE_PRUNE_EPS,        # L3: aggressive hop pruning
     "m_prefix": 0},                           #     (auto prefix split)
    {"rerank": -1},                            # L4: no exact rerank
    {"skip_delta": True},                      # L5: no delta scan
)

MAX_LEVEL = len(_LADDER) - 1


@dataclasses.dataclass(frozen=True)
class DegradationPolicy:
    """Maps a degradation level to concrete ``search()`` overrides.

    ``max_level`` clamps how far down the ladder this deployment is willing
    to go (e.g. a freshness-critical service sets ``max_level=4`` so the
    delta scan never drops). ``prune_eps`` overrides the L3 epsilon.
    """

    max_level: int = MAX_LEVEL
    prune_eps: float = AGGRESSIVE_PRUNE_EPS

    def __post_init__(self):
        if not 0 <= self.max_level <= MAX_LEVEL:
            raise ValueError(
                f"max_level must be in [0, {MAX_LEVEL}], got "
                f"{self.max_level}")

    def clamp(self, level: int) -> int:
        return max(0, min(int(level), self.max_level))

    def overrides(self, level: int) -> dict:
        """Cumulative search-kwarg overrides for ``level`` (clamped)."""
        out: dict = {}
        for rung in _LADDER[:self.clamp(level) + 1]:
            out.update(rung)
        if "prune_eps" in out:
            out["prune_eps"] = self.prune_eps
        return out

    def apply(self, engine, level: int, **search_kwargs) -> dict:
        """Final kwargs for ``engine.search``: the caller's kwargs with the
        level's overrides ON TOP, filtered to the parameters this engine's
        ``search`` actually accepts — one ladder, five engines."""
        params = inspect.signature(engine.search).parameters
        merged = dict(search_kwargs)
        for key, val in self.overrides(level).items():
            if key in params:
                merged[key] = val
        return merged

    def search(self, engine, queries, *, level: int = 0, **search_kwargs):
        """``engine.search`` at a degradation level."""
        return engine.search(queries,
                             **self.apply(engine, level, **search_kwargs))


def recommend_level(policy: DegradationPolicy, *, observed_s: float,
                    deadline_s: float, current: int = 0,
                    headroom: float = 0.8) -> int:
    """One-step ladder controller: step DOWN a rung when the observed batch
    latency exceeds the deadline, step back UP when it clears the deadline
    with ``headroom`` to spare (hysteresis — the gap between the two
    thresholds keeps the level from oscillating every batch)."""
    if observed_s > deadline_s:
        return policy.clamp(current + 1)
    if observed_s < headroom * deadline_s:
        return policy.clamp(current - 1)
    return policy.clamp(current)
