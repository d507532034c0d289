"""All-in-storage serving tier (DESIGN.md §14). Port of ``repro/storage``.

Graph adjacency + PQ codes live in one mmap-able segment file; DRAM holds
only per-query LUTs, entry points, and a bounded hot-vertex cache. The
pieces compose bottom-up: ``format`` (record layout + CRC'd header +
generation fallback; files byte-identical to the JAX package's) →
``reader`` (thread-pooled pread with retry/chaos seams) →
``cache``/``prefetch`` (BFS-seeded LRU + double-buffered frontier fetch) →
``engine`` (the protocol-compatible DiskEngine, which builds LUTs and
scores each round on the card through ``hop_adc`` / ``hop_adc_fs``).
"""

from repro_torch.storage.format import (SegmentFormatError, SegmentHeader,
                                        all_generations, corrupt_header,
                                        corrupt_record, open_segment,
                                        read_header, record_bytes_for,
                                        segment_path, write_segment)
from repro_torch.storage.reader import AsyncSegmentReader
from repro_torch.storage.cache import HotVertexCache
from repro_torch.storage.prefetch import FrontierPrefetcher, PendingFetch
from repro_torch.storage.engine import DiskEngine

__all__ = [
    "SegmentFormatError", "SegmentHeader", "all_generations",
    "corrupt_header", "corrupt_record", "open_segment", "read_header",
    "record_bytes_for", "segment_path", "write_segment",
    "AsyncSegmentReader", "HotVertexCache", "FrontierPrefetcher",
    "PendingFetch", "DiskEngine",
]
