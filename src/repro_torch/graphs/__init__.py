from repro_torch.graphs.adjacency import (Graph, degree_stats, find_medoid,
                                          from_lists, symmetrize)
from repro_torch.graphs.knn import knn_ids, topk_lower
from repro_torch.graphs.prune import prune_from_vectors, robust_prune
from repro_torch.graphs.vamana import build_vamana
from repro_torch.graphs.hnsw import HNSW, build_hnsw, descend
from repro_torch.graphs.nsg import build_nsg

__all__ = ["Graph", "degree_stats", "find_medoid", "from_lists", "symmetrize",
           "knn_ids", "topk_lower", "prune_from_vectors", "robust_prune",
           "build_vamana", "HNSW", "build_hnsw", "descend", "build_nsg"]
