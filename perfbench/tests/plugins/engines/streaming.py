"""streaming: the program's ``StreamingEngine`` over the cached build: the
base as generation 0 (graph, codes, full vectors), a delta segment of the
configuration's ``delta_capacity`` rows for inserts, tombstones for
deletes, and ``consolidate()`` folding both into the next generation. Its
base arm routes by ``hop_adc`` (fs4 ``hop_adc_fs``), its delta arm scans
by ``adc_scan_batch``; it returns ADC distances (no exact rerank)."""

from repro_torch.index import BaseSegment, StreamingEngine


def make(cfg, graph, model, codes, x, device):
    seg = BaseSegment(graph=graph, codes=codes, vectors=x, layout=cfg["layout"])
    return StreamingEngine(seg, model, delta_capacity=cfg["delta_capacity"], device=device)
