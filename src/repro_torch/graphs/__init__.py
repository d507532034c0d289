from repro_torch.graphs.adjacency import (Graph, degree_stats, find_medoid,
                                          from_lists, symmetrize)
from repro_torch.graphs.knn import knn_ids
from repro_torch.graphs.prune import prune_from_vectors, robust_prune
from repro_torch.graphs.vamana import build_vamana

__all__ = ["Graph", "degree_stats", "find_medoid", "from_lists", "symmetrize", "knn_ids", "prune_from_vectors",
           "robust_prune", "build_vamana"]
