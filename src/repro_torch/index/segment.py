"""Frozen base segment + tombstone bitset for the streaming index.

Port of ``repro/index/segment.py``. The mutable-index layout is the
DiskANN-lineage (FreshDiskANN / AiSAQ) segment model: one FROZEN,
generation-numbered base segment — a proximity graph over PQ codes, what
the read-only engines serve — plus a bounded append-only delta
(:mod:`repro_torch.index.delta`) and a tombstone bitset covering both.
Nothing in the base segment is mutated in place; deletes flip tombstone
bits, inserts append to the delta, and :mod:`repro_torch.index.consolidate`
folds both into a fresh base segment with a bumped generation, snapshotted
atomically through :mod:`repro_torch.dist.checkpoint` in the reference's
format, so either package restores the other's snapshots.
"""

from __future__ import annotations

import dataclasses
import zipfile
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.dist import checkpoint as ckpt
from repro_torch.graphs.adjacency import Graph
from repro_torch.pq import base as pqbase
from repro_torch.pq import pack
from repro_torch.search.beam import as_bitset

LAYOUTS = ("u8", "fs4")


def encode_codes(model: pqbase.QuantizerModel, x: torch.Tensor,
                 layout: str) -> torch.Tensor:
    """(B, D) vectors → (B, M) codes (uint8 for K ≤ 256, int32 beyond) or
    (B, ceil(M/2)) fs4 packed bytes, on x's device — the one encode path
    shared by base builds, delta inserts and serve.py."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    codes = pqbase.encode(model, x)
    if layout == "fs4":
        if model.k > pack.FS_K:
            raise ValueError(
                f"fs4 layout needs K <= {pack.FS_K} sub-codewords, got "
                f"K={model.k} (train with pq.train_pq_fs4)")
        codes = pack.pack_codes(codes)
    return codes


def bitset_words(capacity: int) -> int:
    """Words for a bitset over ids [0, capacity) — the sentinel-inclusive
    (n+31)//32 + 1 sizing shared with the beam's visited set, so one bitset
    serves both the global id space and any base-graph beam over it."""
    return (capacity + 31) // 32 + 1


class Tombstones:
    """Host-mutable deleted-id bitset over the global id space
    [0, n_base + delta_capacity).

    The host uint32 words are the source of truth (the reference's layout).
    :attr:`words` is their device view as the beam takes it (int32, the same
    bits), uploaded once after each mutation and reused by every search
    until the next one. Adds are idempotent; ``count`` tracks distinct
    tombstoned ids.
    """

    def __init__(self, capacity: int, device=None):
        self.capacity = int(capacity)
        self.device = resolve_device(device)
        self._words = np.zeros((bitset_words(self.capacity),), np.uint32)
        self._dev = None
        self.count = 0

    def add(self, ids) -> int:
        """Set bits for ``ids`` (any int array-like). Returns how many were
        newly tombstoned (already-dead ids are a no-op, not an error)."""
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        if ids.size and ((ids < 0) | (ids >= self.capacity)).any():
            bad = ids[(ids < 0) | (ids >= self.capacity)]
            raise ValueError(
                f"tombstone ids out of range [0, {self.capacity}): {bad}")
        fresh = int(np.unique(ids[~self.contains(ids)]).size)
        np.bitwise_or.at(self._words, ids >> 5,
                         np.uint32(1) << (ids & 31).astype(np.uint32))
        self.count += fresh
        if fresh:
            self._dev = None
        return fresh

    def contains(self, ids) -> np.ndarray:
        """Boolean mask: True where the id is tombstoned."""
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        if ids.size == 0:
            return np.zeros((0,), bool)
        return ((self._words[ids >> 5] >> (ids & 31).astype(np.uint32)) & 1
                ).astype(bool)

    @property
    def words(self) -> torch.Tensor:
        """(W,) int32 device view (the beam's bitset layout), uploaded once
        per mutation."""
        if self._dev is None:
            self._dev = as_bitset(self._words, self.device)
        return self._dev

    def clear(self) -> None:
        self._words[:] = 0
        self._dev = None
        self.count = 0


@dataclasses.dataclass
class BaseSegment:
    """One frozen, generation-numbered serving segment.

    Attributes:
      graph:      padded Vamana adjacency over the segment rows (sentinel n).
      codes:      (n, M) uint8 / int32 codes or (n, ceil(M/2)) fs4 packed
                  bytes — must match ``layout``.
      vectors:    (n, D) f32 full vectors ("on SSD" in the DiskANN layout —
                  resident here; consolidation and exact rerank need them).
                  May be None for a code-only restore
                  (``load_segment(with_vectors=False)``); ``dim_hint`` then
                  supplies D.
      layout:     "u8" | "fs4" (decides the LUT type the engine builds).
      generation: consolidation counter; doubles as the checkpoint step.
      dim_hint:   original dimensionality when ``vectors`` is None.
    """

    graph: Graph
    codes: torch.Tensor
    vectors: Optional[torch.Tensor]
    layout: str = "u8"
    generation: int = 0
    dim_hint: Optional[int] = None

    def __post_init__(self):
        if self.layout not in LAYOUTS:
            raise ValueError(f"layout must be one of {LAYOUTS}, "
                             f"got {self.layout!r}")
        if int(self.codes.shape[0]) != self.n:
            raise ValueError(f"codes rows {self.codes.shape[0]} != "
                             f"graph rows {self.n}")
        if self.vectors is None and self.dim_hint is None:
            raise ValueError("a vector-free BaseSegment needs dim_hint")

    @property
    def n(self) -> int:
        return self.graph.n

    @property
    def dim(self) -> int:
        if self.vectors is None:
            return int(self.dim_hint)
        return int(self.vectors.shape[1])

    @property
    def code_width(self) -> int:
        return int(self.codes.shape[1])

    @classmethod
    def build(cls, vectors: torch.Tensor, model: pqbase.QuantizerModel, *,
              generator: torch.Generator, layout: str = "u8", r: int = 24,
              l: int = 48, alpha: float = 1.2, batch: int = 1024,
              generation: int = 0, device=None) -> "BaseSegment":
        """Encode + build a Vamana graph over ``vectors`` on ``device``
        (default ``cuda``), the graph's draws from the CPU ``generator`` —
        the from-scratch (or rebuild) path; consolidation makes the
        incremental ones."""
        from repro_torch.graphs.vamana import build_vamana

        dev = resolve_device(device)
        vectors = torch.as_tensor(vectors).to(dev, torch.float32)
        codes = encode_codes(model.to(dev), vectors, layout)
        graph = build_vamana(vectors, generator=generator, r=r, l=l,
                             alpha=alpha, batch=batch, device=dev)
        return cls(graph=graph, codes=codes, vectors=vectors, layout=layout,
                   generation=generation)

    def memory_bytes(self) -> int:
        vec = 0 if self.vectors is None else self.vectors.numel() * 4
        return (self.codes.numel() * self.codes.element_size()
                + self.graph.neighbors.numel() * 4 + vec)


def save_segment(directory: str, seg: BaseSegment,
                 keep: Optional[int] = None,
                 model: Optional[pqbase.QuantizerModel] = None) -> str:
    """Atomic snapshot of a base segment at step = generation: readers see
    the old complete generation or the new one, never a half-written
    consolidation. ``model`` persists the quantizer the codes were encoded
    with inside the snapshot, so a restart after a codebook refresh resumes
    self-contained; ``model=None`` writes the codes-only format. The arrays
    and their dtypes are the reference's."""
    if seg.vectors is None:
        raise ValueError("cannot snapshot a vector-free BaseSegment — "
                         "consolidation and rerank need the vectors")
    index = {"neighbors": seg.graph.neighbors.to(torch.int32),
             "medoid": seg.graph.medoid.to(torch.int32),
             "codes": seg.codes,
             "vectors": seg.vectors.float(),
             "layout": seg.layout,
             "generation": int(seg.generation),
             "dim": int(seg.dim)}
    if model is not None:
        index["quantizer"] = {
            "r": model.r.float(), "codebooks": model.codebooks.float(),
            "m": int(model.m), "k": int(model.k)}
    return ckpt.save(directory, seg.generation, keep=keep, index=index)


def _load_one(directory: str, generation: Optional[int], with_model: bool,
              retry, with_vectors: bool, device):
    drop = () if with_vectors else ("index/vectors",)
    state = ckpt.restore(directory, step=generation, retry=retry, drop=drop,
                         device=device)
    t = state["index"]
    graph = Graph(neighbors=t["neighbors"].to(torch.int32),
                  medoid=t["medoid"].reshape(()).long())
    if with_vectors:
        vectors, dim_hint = t["vectors"].float(), None
    else:
        # a ckpt.Dropped placeholder (no bytes read); its manifest shape
        # covers snapshots that predate the "dim" key
        vectors = None
        dim_hint = int(t.get("dim") or t["vectors"].shape[1])
    seg = BaseSegment(graph=graph, codes=t["codes"], vectors=vectors,
                      layout=str(t["layout"]), generation=int(t["generation"]),
                      dim_hint=dim_hint)
    if not with_model:
        return seg
    q = t.get("quantizer")
    model = (pqbase.QuantizerModel(r=q["r"].float(),
                                   codebooks=q["codebooks"].float())
             if q is not None else None)
    return seg, model


def load_segment(directory: str, generation: Optional[int] = None, *,
                 with_model: bool = False, with_vectors: bool = True,
                 retry=None, on_fallback=None, device=None):
    """Restore the newest INTACT (or a given) consolidated generation, as
    tensors on ``device`` (default ``cuda``).

    Every snapshot read is CRC32-verified. With ``generation=None`` a
    snapshot that fails verification or is otherwise unreadable (truncated
    zip, missing tree, malformed manifest) does not poison the restore: the
    loader falls back generation by generation to the newest intact one,
    calling ``on_fallback(generation, error)`` per rejected snapshot, and
    raises a ``RuntimeError`` naming every failure only when none survives.
    An explicit ``generation`` never falls back.

    ``retry`` (a ``dist.retry.RetryPolicy``) retries transient read faults
    per generation. ``with_model=True`` returns ``(segment, model_or_None)``
    (None for a codes-only snapshot). ``with_vectors=False`` never reads the
    (n, D) vectors: the segment comes back with ``vectors=None`` and a
    ``dim_hint``."""
    dev = resolve_device(device)
    if generation is not None:
        return _load_one(directory, generation, with_model, retry,
                         with_vectors, dev)
    steps = ckpt.all_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {directory!r}")
    failures = []
    for gen in reversed(steps):
        try:
            return _load_one(directory, gen, with_model, retry, with_vectors,
                             dev)
        except (ckpt.ChecksumError, OSError, KeyError, ValueError,
                zipfile.BadZipFile) as e:
            failures.append((gen, e))
            if on_fallback is not None:
                on_fallback(gen, e)
    detail = "; ".join(f"gen {g}: {type(e).__name__}: {e}"
                       for g, e in failures)
    raise RuntimeError(
        f"no intact snapshot under {directory!r} — every generation failed "
        f"verification or read: {detail}")
