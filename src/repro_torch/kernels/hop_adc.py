"""Wrapper of the fused per-hop ADC kernel (``csrc/hop_adc.cu``).

Replaces ``repro/kernels/hop_adc.py::hop_adc``, the Pallas kernel of every
beam round, for uint8 codes and (K > 256) int32 codes; a LUT too large for
shared memory goes in subspace chunks. It is bound by bytes: the per-query
LUTs dominate a round's reads (16 MB at Q=1000, M=16, K=256). Design and
bound are noted in the source. Callers go through :func:`repro_torch.kernels.ops.hop_adc`, which
fixes the dtypes and sends CPU tensors to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# kernel launches since the last reset (chip_smoke.py reads them)
launches = 0       # uint8 codes
launches_i32 = 0   # int32 codes (K > 256)

# One launch's f32 LUT slice in shared memory: a query whose (M, K) LUT is
# larger goes in chunks of subspaces (``subspace_chunks``).
MAX_LUT_BYTES = 200 * 1024
CODE_DTYPES = (torch.uint8, torch.int32)

_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = _build.load("hop_adc").hop_adc_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def subspace_chunks(m: int, k: int, max_bytes: int = MAX_LUT_BYTES
                    ) -> list[tuple[int, int]]:
    """[j0, j1) ranges covering the first ``m`` subspaces, each with an
    (j1 − j0, K) f32 LUT slice of at most ``max_bytes``: one range when the
    whole LUT fits. The kernels sum the chunks in order, each launch
    continuing the sums the last one left in the output."""
    per = max_bytes // (4 * k)
    if per < 1:
        raise ValueError(f"one subspace's LUT row of K={k} f32 entries passes "
                         f"{max_bytes} bytes of shared memory")
    return [(j0, min(m, j0 + per)) for j0 in range(0, m, per)]


def launch(codes: torch.Tensor, ids: torch.Tensor, luts: torch.Tensor,
           m_eff: int, out: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on checked tensors, one launch per subspace chunk
    of the first ``m_eff``; no validation here."""
    global launches, launches_i32
    q, r = ids.shape
    n_rows, m = codes.shape
    k = luts.shape[2]
    if q and r:
        size = codes.element_size()
        for j0, j1 in subspace_chunks(m_eff, k):
            err = _entry()(codes.data_ptr() + j0 * size, size, n_rows, m,
                           ids.data_ptr(), q, r, luts.data_ptr() + j0 * k * 4,
                           m * k, k, j1 - j0, int(j0 > 0), out.data_ptr(),
                           _build.stream_handle(codes.device))
            _build.check("hop_adc", err)
            if codes.dtype == torch.int32:
                launches_i32 += 1
            else:
                launches += 1
    return out


def hop_adc(codes: torch.Tensor, ids: torch.Tensor, luts: torch.Tensor, *,
            m_prefix: int = 0) -> torch.Tensor:
    """(N, M) uint8 or int32 codes, (Q, R′) int32 ids, (Q, M, K) f32 LUTs →
    (Q, R′) f32 on the card. Every id must be a row of ``codes`` — with the
    sentinel row appended by ``ops.pad_sentinel_row``, that is [0, N]; the
    check is a device-side assert, not a Python exception. Codes must be
    below K. ``0 < m_prefix < M`` sums the first ``m_prefix`` subspaces
    only."""
    for name, t, dtypes, ndim in (("codes", codes, CODE_DTYPES, 2),
                                  ("ids", ids, (torch.int32,), 2),
                                  ("luts", luts, (torch.float32,), 3)):
        if t.device.type != "cuda" or t.device != codes.device:
            raise ValueError(f"hop_adc: {name} must be on {codes.device} (CUDA)")
        if t.dtype not in dtypes or t.dim() != ndim or not t.is_contiguous():
            raise ValueError(f"hop_adc: {name} must be a contiguous {ndim}-d "
                             f"{' or '.join(map(str, dtypes))} tensor, got "
                             f"{t.dtype} {tuple(t.shape)}")
    q, _ = ids.shape
    n_rows, m = codes.shape
    if luts.shape[:2] != (q, m):
        raise ValueError(f"hop_adc: luts {tuple(luts.shape)} do not match "
                         f"ids {tuple(ids.shape)} and codes {tuple(codes.shape)}")
    if ids.numel():
        # asynchronous, so a beam round pays no host sync for it: a bad id
        # fails the next synchronization with a device-side assert
        torch._assert_async(((ids >= 0) & (ids < n_rows)).all(),
                            f"hop_adc: ids outside [0, {n_rows})")
    m_eff = m_prefix if 0 < m_prefix < m else m
    out = torch.empty(ids.shape, dtype=torch.float32, device=codes.device)
    return launch(codes, ids, luts, m_eff, out)
