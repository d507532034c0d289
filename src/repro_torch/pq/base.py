"""Serving-side quantizer representation shared by PQ / OPQ / RPQ.

Every trainable quantizer exports a :class:`QuantizerModel` — an
orthonormal rotation + codebooks — which is all the serving engine needs:
``encode`` the base vectors once offline, ``build_lut`` per query online,
``adc`` via the batched scan kernel. Port of ``repro/pq/base.py``: the
distance tables of ``encode`` and ``build_lut`` come from the
``pq_pairwise`` kernel on the card (the JAX ``build_lut`` pins its plain
version; here it goes through the kernel).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import full_f32_matmul
from repro_torch.kernels import ops as kops

# Rows per pq_pairwise call in encode: the (rows, M, K) f32 table is 1 GB
# at M=16, K=256, instead of 16 GB for 1M rows at once.
ENCODE_CHUNK = 65536


@dataclasses.dataclass
class QuantizerModel:
    r: torch.Tensor          # (D, D) orthonormal rotation; identity for PQ
    codebooks: torch.Tensor  # (M, K, dsub)

    @property
    def dim(self) -> int:
        return self.r.shape[0]

    @property
    def m(self) -> int:
        return self.codebooks.shape[0]

    @property
    def k(self) -> int:
        return self.codebooks.shape[1]

    @property
    def dsub(self) -> int:
        return self.codebooks.shape[2]

    def to(self, device) -> "QuantizerModel":
        return QuantizerModel(self.r.to(device), self.codebooks.to(device))


def rotate_split(model: QuantizerModel, x: torch.Tensor) -> torch.Tensor:
    """(N, D) → (N, M, dsub) rotated sub-vectors (full-f32 product)."""
    full_f32_matmul()
    xr = x.float() @ model.r.T
    return xr.reshape(x.shape[0], model.m, model.dsub)


def encode(model: QuantizerModel, x: torch.Tensor) -> torch.Tensor:
    """(N, D) → (N, M) hard codes (uint8 when K ≤ 256), ties to the lowest
    codeword; the distance table is built ENCODE_CHUNK rows at a time."""
    sub = rotate_split(model, x)
    dtype = torch.uint8 if model.k <= 256 else torch.int32
    codes = torch.empty((x.shape[0], model.m), dtype=dtype, device=x.device)
    cb = model.codebooks.float().contiguous()
    for s in range(0, x.shape[0], ENCODE_CHUNK):
        e = s + ENCODE_CHUNK
        codes[s:e] = kops.pq_pairwise(sub[s:e], cb).argmin(dim=-1)
    return codes


def decode(model: QuantizerModel, codes: torch.Tensor) -> torch.Tensor:
    """(N, M) codes → (N, D) reconstruction in the ORIGINAL space (R^T x')."""
    sub = model.codebooks[torch.arange(model.m, device=codes.device)[None, :],
                          codes.long()]                      # (N, M, dsub)
    return sub.reshape(codes.shape[0], -1) @ model.r


def build_lut(model: QuantizerModel, queries: torch.Tensor) -> torch.Tensor:
    """(Q, D) → (Q, M, K) per-query ADC lookup tables."""
    qs = rotate_split(model, torch.atleast_2d(queries))
    return kops.pq_pairwise(qs, model.codebooks)


def adc(model: QuantizerModel, codes: torch.Tensor,
        queries: torch.Tensor) -> torch.Tensor:
    """(Q, D) × (N, M) → (Q, N) estimated squared distances."""
    return kops.adc_scan_batch(codes, build_lut(model, queries))


def distortion(model: QuantizerModel, x: torch.Tensor) -> torch.Tensor:
    """Mean squared reconstruction error (the vertex-oriented PQ objective)."""
    codes = encode(model, x)
    return ((x - decode(model, codes)) ** 2).sum(dim=-1).mean()


def identity_rotation(dim: int, *, device=None) -> torch.Tensor:
    return torch.eye(dim, dtype=torch.float32, device=device)
