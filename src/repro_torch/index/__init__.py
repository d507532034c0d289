"""Streaming mutable index: a frozen generation-numbered base segment +
bounded append-only delta + tombstone bitset, served live by
:class:`StreamingEngine` and folded together by :func:`consolidate`.
Port of ``repro/index``.

* :mod:`repro_torch.index.segment` — :class:`BaseSegment`,
  :class:`Tombstones`, atomic snapshot save/load (the reference's format).
* :mod:`repro_torch.index.delta` — :class:`DeltaSegment`;
  :class:`DeltaFullError` on overflow.
* :mod:`repro_torch.index.engine` — :class:`StreamingEngine`: the other
  engines' ``search()`` plus ``insert`` / ``delete`` / ``consolidate``.
* :mod:`repro_torch.index.consolidate` — compaction + graph repair + delta
  fold-in + generation bump.
* :mod:`repro_torch.index.refresh` — codebook refresh at the generation
  boundary (:class:`RefreshConfig`, :func:`refresh_quantizer`).
"""
from repro_torch.index.consolidate import consolidate  # noqa: F401
from repro_torch.index.delta import DeltaFullError, DeltaSegment  # noqa: F401
from repro_torch.index.engine import StreamingEngine  # noqa: F401
from repro_torch.index.refresh import RefreshConfig, refresh_quantizer  # noqa: F401
from repro_torch.index.segment import (  # noqa: F401
    BaseSegment, Tombstones, encode_codes, load_segment, save_segment,
)
