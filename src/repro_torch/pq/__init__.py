from repro_torch.pq import base, pack
from repro_torch.pq.base import QuantizerModel
from repro_torch.pq.kmeans import kmeans, kmeans_multi
from repro_torch.pq.opq import train_opq
from repro_torch.pq.pack import QuantizedLUT
from repro_torch.pq.pq import train_pq, train_pq_fs4

__all__ = ["base", "pack", "QuantizerModel", "QuantizedLUT", "kmeans",
           "kmeans_multi", "train_opq", "train_pq", "train_pq_fs4"]
