"""Sharding-aware, resumable input pipeline. Port of
``repro/data/pipeline.py``: numpy only, the same batches bit for bit.

A training loop checkpoints `iterator.state()` next to its params, so a
restarted job resumes mid-epoch WITHOUT replaying or skipping batches
(bit-identical batch sequence):

* determinism: batch t is a pure function of (seed, t) — permutations are
  derived per-epoch via fold_in, never from mutable RNG state;
* elasticity: `shard(host_id, n_hosts)` slices every batch by host, and
  because batches are (seed, t)-pure the SAME global batch sequence is
  reproduced under a different host count after resume;
* infinite stream over a finite array with per-epoch reshuffling (the
  paper's trainer samples anchors/queries — this pipeline feeds it ids).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class IndexStream:
    """Deterministic infinite stream of index batches over [0, n)."""
    n: int
    batch: int
    seed: int = 0
    step: int = 0              # resumable cursor
    host_id: int = 0
    n_hosts: int = 1

    @property
    def batches_per_epoch(self) -> int:
        return max(self.n // self.batch, 1)

    def _epoch_perm(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch]))
        return rng.permutation(self.n)

    def peek(self, step: Optional[int] = None) -> np.ndarray:
        """Global batch at `step` (pure; does not advance the cursor)."""
        t = self.step if step is None else step
        epoch, within = divmod(t, self.batches_per_epoch)
        perm = self._epoch_perm(epoch)
        lo = within * self.batch
        return perm[lo: lo + self.batch]

    def shard(self, ids: np.ndarray) -> np.ndarray:
        """This host's slice of a global batch (contiguous block split)."""
        per = len(ids) // self.n_hosts
        return ids[self.host_id * per: (self.host_id + 1) * per]

    def __next__(self) -> np.ndarray:
        out = self.shard(self.peek())
        self.step += 1
        return out

    def __iter__(self):
        return self

    # ---- checkpoint integration ------------------------------------
    def state(self) -> dict:
        return {"step": self.step, "seed": self.seed, "n": self.n,
                "batch": self.batch}

    @classmethod
    def from_state(cls, state: dict, *, host_id: int = 0, n_hosts: int = 1
                   ) -> "IndexStream":
        return cls(n=state["n"], batch=state["batch"], seed=state["seed"],
                   step=state["step"], host_id=host_id, n_hosts=n_hosts)
