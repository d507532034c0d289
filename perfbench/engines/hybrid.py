"""hybrid: the program's ``HybridEngine`` over the cached build: graph
routing by ADC (``hop_adc``, fs4 ``hop_adc_fs`` with uint8 tables), then an
exact rerank of the beam with the full vectors. The engine of every
configuration that names none.

An engine module gives ``make(cfg, graph, model, codes, x, device)``,
which returns the serving engine: an object with ``search(queries, k=,
h=)`` returning the program's ``SearchResult`` and a ``lut_fn`` attribute
that its search calls for the queries' tables (the check taps both). It
may set ``ROUTING = (module, entry point)``, the routing kernel whose
launches the check samples; without it, ``checks.ROUTING[layout]``.
"""

from repro_torch.pq import base as pqbase
from repro_torch.search.engine import HybridEngine


def make(cfg, graph, model, codes, x, device):
    fs4 = cfg["layout"] == "fs4"

    def lut_fn(q):
        return pqbase.build_lut(model, q, quantize=fs4)

    return HybridEngine(graph, codes, lut_fn, vectors=x, device=device)
