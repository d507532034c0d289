from repro_torch.pq import base, pack
from repro_torch.pq.base import (QuantizerModel, adc, build_lut, decode,
                                 distortion, encode)
from repro_torch.pq.kmeans import kmeans, kmeans_multi
from repro_torch.pq.opq import train_opq
from repro_torch.pq.pack import (QuantizedLUT, pack_codes, packed_width,
                                 quantize_luts, unpack_codes)
from repro_torch.pq.pq import train_pq, train_pq_fs4

__all__ = ["base", "pack", "QuantizerModel", "adc", "build_lut",
           "decode", "distortion", "encode", "kmeans", "kmeans_multi",
           "train_opq", "QuantizedLUT", "pack_codes", "packed_width",
           "quantize_luts", "unpack_codes", "train_pq", "train_pq_fs4"]
