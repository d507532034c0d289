"""On-disk segment format: per-vertex records in one mmap-able file.

Port of ``repro/storage/format.py``, numpy and stdlib only, so the files
are byte-identical to the JAX package's for the same graph and codes and
either package reads the other's. One departure: :func:`write_segment`
refuses codes above 255 (K > 256), which the reference narrows to uint8
without a word.

The all-in-storage serving tier (DESIGN.md §14, AiSAQ — PAPERS.md arxiv
2404.06004) keeps the Vamana adjacency AND the packed PQ codes entirely on
disk; only the per-query LUTs, the entry points, and a bounded hot-vertex
cache stay DRAM-resident. The unit of I/O is the per-vertex RECORD — one
contiguous slab holding the vertex's R int32 neighbor ids followed by its
code bytes (u8 or fs4-packed, exactly the bytes a :class:`repro_torch.index
.segment.BaseSegment` carries) — so a single read yields both what a beam
round needs to SCORE the vertex (codes) and what a later round needs to
EXPAND it (adjacency): expansion never costs a second read.

File layout (``gen_<generation:08d>.seg``):

    [ header page: HEADER_SIZE bytes                                  ]
    [   MAGIC (8) | json_len u32 LE | json_crc32 u32 LE | json | pad  ]
    [ records: n × record_bytes, 8-byte aligned                       ]

The JSON header carries {n, r, code_width, layout, generation, dim,
medoid, record_bytes, data_crc32} and is CRC-checked on open — a torn or
corrupted header raises :class:`SegmentFormatError`, which
:func:`open_segment` turns into newest-intact-generation fallback (the
same discipline as ``index.segment.load_segment``). ``data_crc32`` covers
the whole record region for offline audits (:meth:`SegmentHeader
.verify_data`); per-record reads do not re-hash — the hot path trusts the
device, the drills corrupt on purpose (:func:`corrupt_record`).

Segments are written ATOMICALLY (tmp + ``os.replace``) and are immutable
per generation: a consolidation writes ``gen_00000001.seg`` next to
``gen_00000000.seg``, readers open the newest intact one. ``write_segment
(..., model=)`` drops a ``gen_*.model.npz`` sidecar (rotation + codebooks)
so :meth:`repro_torch.storage.engine.DiskEngine.open` restores self-contained.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import zlib
from typing import Callable, Optional

import numpy as np

MAGIC = b"RGPQSEG1"
HEADER_SIZE = 4096
FORMAT_VERSION = 1
_SEG_RE = re.compile(r"^gen_(\d{8})\.seg$")


class SegmentFormatError(ValueError):
    """The segment file's header (or size) fails verification."""


def record_bytes_for(r: int, code_width: int) -> int:
    """Bytes per vertex record: R int32 neighbors + code bytes, padded to
    8-byte alignment so mmap'd int32 views stay aligned."""
    raw = 4 * int(r) + int(code_width)
    return (raw + 7) // 8 * 8


@dataclasses.dataclass(frozen=True)
class SegmentHeader:
    """Decoded, verified header of one segment file."""

    n: int
    r: int                 # graph degree (neighbor slots per record)
    code_width: int        # code bytes per vertex (M for u8, ceil(M/2) fs4)
    layout: str            # "u8" | "fs4"
    generation: int
    dim: int               # original vector dimensionality (metadata only)
    medoid: int            # DRAM-resident entry point
    record_bytes: int
    data_crc32: int
    version: int = FORMAT_VERSION

    @property
    def data_bytes(self) -> int:
        return self.n * self.record_bytes

    @property
    def file_bytes(self) -> int:
        return HEADER_SIZE + self.data_bytes

    def record_offset(self, vid: int) -> int:
        return HEADER_SIZE + vid * self.record_bytes

    def parse_records(self, raw: bytes, count: int):
        """(count · record_bytes) raw bytes → ((count, R) int32 adjacency,
        (count, code_width) uint8 codes) — the one decode used by reader,
        cache seeding, and the round-trip tests alike."""
        a = np.frombuffer(raw, np.uint8).reshape(count, self.record_bytes)
        adj = a[:, :4 * self.r].copy().view(np.int32).reshape(count, self.r)
        codes = a[:, 4 * self.r:4 * self.r + self.code_width].copy()
        return adj, codes

    def verify_data(self, path: str) -> None:
        """Offline audit: re-hash the whole record region against the
        header's ``data_crc32`` (not on the hot path)."""
        crc = 0
        with open(path, "rb") as f:
            f.seek(HEADER_SIZE)
            while True:
                chunk = f.read(1 << 20)
                if not chunk:
                    break
                crc = zlib.crc32(chunk, crc)
        if crc != self.data_crc32:
            raise SegmentFormatError(
                f"{path}: record region crc32 {crc:#010x} != header "
                f"{self.data_crc32:#010x} — segment data is corrupt")


def segment_path(directory: str, generation: int) -> str:
    return os.path.join(directory, f"gen_{int(generation):08d}.seg")


def model_path(directory: str, generation: int) -> str:
    return os.path.join(directory, f"gen_{int(generation):08d}.model.npz")


def all_generations(directory: str) -> list:
    """Sorted generations with a segment file under ``directory``."""
    if not os.path.isdir(directory):
        return []
    gens = []
    for name in os.listdir(directory):
        m = _SEG_RE.match(name)
        if m:
            gens.append(int(m.group(1)))
    return sorted(gens)


def write_segment(directory: str, seg, model=None) -> str:
    """Serialize a :class:`repro_torch.index.segment.BaseSegment` into the
    record format, atomically (tmp + ``os.replace``). Returns the path.

    Only the adjacency and codes are written — the float vectors stay
    wherever the snapshot keeps them; this tier serves without them. The
    segment's tensors may lie on any device; they come to the host once.
    ``model`` (a ``pq.base.QuantizerModel``) lands in a sidecar npz so a
    reader can rebuild the LUT function with no caller-side state.

    Raises ``ValueError`` on a code above 255: a record holds one byte per
    code, and the reference's silent narrowing of K > 256 codes is not
    reproduced.
    """
    neighbors = seg.graph.neighbors.detach().cpu().numpy().astype(np.int32)
    codes = seg.codes.detach().cpu().numpy()
    if codes.size and (codes.min() < 0 or codes.max() > 255):
        raise ValueError(
            f"segment codes must fit one byte each (got values in "
            f"[{int(codes.min())}, {int(codes.max())}]): the record format "
            f"holds uint8 codes, so K > 256 codebooks cannot be written")
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n, r = neighbors.shape
    if codes.shape[0] != n:
        raise ValueError(f"codes rows {codes.shape[0]} != graph rows {n}")
    code_width = codes.shape[1]
    rb = record_bytes_for(r, code_width)
    records = np.zeros((n, rb), np.uint8)
    records[:, :4 * r] = neighbors.view(np.uint8).reshape(n, 4 * r)
    records[:, 4 * r:4 * r + code_width] = codes
    raw = records.tobytes()

    meta = {"version": FORMAT_VERSION, "n": n, "r": r,
            "code_width": code_width, "layout": str(seg.layout),
            "generation": int(seg.generation),
            "dim": int(seg.dim), "medoid": int(seg.graph.medoid),
            "record_bytes": rb, "data_crc32": zlib.crc32(raw)}
    blob = json.dumps(meta).encode()
    if len(blob) > HEADER_SIZE - 16:
        raise ValueError(f"segment header json too large: {len(blob)}")
    header = bytearray(HEADER_SIZE)
    header[:8] = MAGIC
    header[8:12] = np.uint32(len(blob)).tobytes()
    header[12:16] = np.uint32(zlib.crc32(blob)).tobytes()
    header[16:16 + len(blob)] = blob

    os.makedirs(directory, exist_ok=True)
    final = segment_path(directory, seg.generation)
    tmp = final + f".tmp-{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(bytes(header))
        f.write(raw)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)
    if model is not None:
        np.savez(model_path(directory, seg.generation),
                 r=model.r.detach().cpu().numpy().astype(np.float32),
                 codebooks=model.codebooks.detach().cpu().numpy().astype(
                     np.float32))
    return final


def read_header(path: str) -> SegmentHeader:
    """Parse + verify a segment file's header page.

    Raises :class:`SegmentFormatError` on a missing/short header, wrong
    magic, CRC mismatch, or a file shorter than the records the header
    promises — every way a torn write or bit flip can present.
    """
    try:
        with open(path, "rb") as f:
            head = f.read(HEADER_SIZE)
    except OSError as e:
        raise SegmentFormatError(f"{path}: unreadable header: {e}") from e
    if len(head) < HEADER_SIZE:
        raise SegmentFormatError(
            f"{path}: truncated header ({len(head)} < {HEADER_SIZE} bytes)")
    if head[:8] != MAGIC:
        raise SegmentFormatError(
            f"{path}: bad magic {head[:8]!r} (want {MAGIC!r})")
    blob_len = int(np.frombuffer(head[8:12], np.uint32)[0])
    want_crc = int(np.frombuffer(head[12:16], np.uint32)[0])
    if blob_len > HEADER_SIZE - 16:
        raise SegmentFormatError(f"{path}: header json length {blob_len} "
                                 f"exceeds the header page")
    blob = head[16:16 + blob_len]
    if zlib.crc32(blob) != want_crc:
        raise SegmentFormatError(
            f"{path}: header json crc32 {zlib.crc32(blob):#010x} != "
            f"recorded {want_crc:#010x} — header is corrupt")
    try:
        meta = json.loads(blob.decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise SegmentFormatError(f"{path}: header json unparseable: "
                                 f"{e}") from e
    hdr = SegmentHeader(**{f.name: meta[f.name] for f in
                           dataclasses.fields(SegmentHeader)})
    if os.path.getsize(path) < hdr.file_bytes:
        raise SegmentFormatError(
            f"{path}: file holds {os.path.getsize(path)} bytes but the "
            f"header promises {hdr.file_bytes} — records truncated")
    return hdr


def open_segment(directory: str, generation: Optional[int] = None, *,
                 on_fallback: Optional[Callable] = None):
    """Open the newest INTACT (or a specific) generation's segment file.

    Returns ``(path, header)``. Mirrors ``index.segment.load_segment``'s
    fallback contract: with ``generation=None`` a segment whose header
    fails verification does not poison the open — the loader walks
    generations newest-first, calling ``on_fallback(generation, error)``
    per rejected file, and raises only when none survives. An explicit
    ``generation`` never falls back.
    """
    if generation is not None:
        path = segment_path(directory, generation)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"no segment for generation {generation} under "
                f"{directory!r} (available: {all_generations(directory)})")
        return path, read_header(path)
    gens = all_generations(directory)
    if not gens:
        raise FileNotFoundError(f"no segment files under {directory!r}")
    failures = []
    for gen in reversed(gens):
        path = segment_path(directory, gen)
        try:
            return path, read_header(path)
        except SegmentFormatError as e:
            failures.append((gen, e))
            if on_fallback is not None:
                on_fallback(gen, e)
    detail = "; ".join(f"gen {g}: {e}" for g, e in failures)
    raise RuntimeError(
        f"no intact segment under {directory!r} — every generation failed "
        f"header verification: {detail}")


# --------------------------------------------------------------------------
# Chaos helpers (DESIGN.md §13/§14): deliberate, seeded corruption of the
# on-disk segment, for the resilience drills. Both flip bytes IN PLACE —
# unlike snapshot corruption there is no container checksum to stay
# consistent with; the header CRC (or a verify_data audit) is the only
# detector, which is exactly the layer the drills exercise.
# --------------------------------------------------------------------------

def corrupt_header(path: str, *, seed: int = 0) -> int:
    """Flip one byte inside the header's json region. Returns the offset."""
    rng = np.random.default_rng(seed)
    blob_len = max(1, int(np.frombuffer(
        open(path, "rb").read(12)[8:12], np.uint32)[0]))
    off = 16 + int(rng.integers(blob_len))
    with open(path, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0xFF]))
    return off


def corrupt_record(path: str, vid: Optional[int] = None, *,
                   seed: int = 0) -> int:
    """Flip one byte inside vertex ``vid``'s record (random vertex when
    None). The header stays intact — this is SILENT data corruption, the
    kind only ``verify_data`` (or a recall drill) can observe. Returns the
    corrupted vertex id."""
    hdr = read_header(path)
    rng = np.random.default_rng(seed)
    if vid is None:
        vid = int(rng.integers(hdr.n))
    off = hdr.record_offset(vid) + int(rng.integers(hdr.record_bytes))
    with open(path, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0xFF]))
    return int(vid)
