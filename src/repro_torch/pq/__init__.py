from repro_torch.pq import base
from repro_torch.pq.base import QuantizerModel
from repro_torch.pq.kmeans import kmeans, kmeans_multi
from repro_torch.pq.pq import train_pq

__all__ = ["base", "QuantizerModel", "kmeans", "kmeans_multi", "train_pq"]
