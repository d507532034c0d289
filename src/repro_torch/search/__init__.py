from repro_torch.search.beam import (SearchResult, Trace, beam_search,
                                     beam_search_trace)
from repro_torch.search.engine import (HybridEngine, InMemoryEngine, ShardedEngine,
                                       ShardedGraphEngine)

__all__ = ["SearchResult", "Trace", "beam_search", "beam_search_trace",
           "HybridEngine", "InMemoryEngine", "ShardedEngine", "ShardedGraphEngine"]
