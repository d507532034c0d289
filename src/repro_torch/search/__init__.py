from repro_torch.search.beam import SearchResult, beam_search
from repro_torch.search.engine import HybridEngine, InMemoryEngine, ShardedEngine

__all__ = ["SearchResult", "beam_search", "HybridEngine", "InMemoryEngine",
           "ShardedEngine"]
