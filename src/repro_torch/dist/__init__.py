from repro_torch.dist.fault import MergedTopK, partial_merge

__all__ = ["MergedTopK", "partial_merge"]
