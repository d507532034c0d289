"""Wrapper of the fused per-hop ADC kernel (``csrc/hop_adc.cu``).

Replaces ``repro/kernels/hop_adc.py::hop_adc``, the Pallas kernel of every
beam round, for uint8 codes and (K > 256) int32 codes, in one launch whatever
the LUT's size (the kernel stages nothing). It is bound by bytes: the
per-query LUTs dominate a round's reads (16 MB at Q=1000, M=16, K=256).
Design and bound are noted in the source. The 16-byte row vectors a thread holds in
registers (a choice the one-query ``adc_scan`` kernel shares) are picked
here, so the CPU tests can check the choice. Callers go through
:func:`repro_torch.kernels.ops.hop_adc`, which fixes the dtypes and sends
CPU tensors to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# kernel launches since the last reset (chip_smoke.py reads them)
launches = 0       # uint8 codes
launches_i32 = 0   # int32 codes (K > 256)

# One launch's f32 LUT slice, the shared-memory budget of the LUT-staging
# kernels (``adc_scan``, ``adc_scan_batch``, ``hop_gather``): a query whose
# (M, K) LUT is larger goes in chunks of subspaces (``subspace_chunks``).
MAX_LUT_BYTES = 200 * 1024
CODE_DTYPES = (torch.uint8, torch.int32)
# 16-byte row vectors a thread may hold in registers (the kernels' template
# instances: kPre of 1, 2 or 4).
PREFETCH_VECTORS = (1, 2, 4)

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


def row_vectors(ptr: int, ldc: int, j0: int, mc: int, size: int) -> int:
    """16-byte loads that hold the codes [j0, j0 + mc) of a row, for rows of
    ``ldc`` codes of ``size`` bytes from address ``ptr``; 0 unless every row
    and the chunk's first code start on 16 bytes (the kernels then load code
    by code). The last vector may pass ``j0 + mc`` but not the row's end."""
    if ptr % 16 or ldc * size % 16 or j0 * size % 16:
        return 0
    return -(-mc * size // 16)


def prefetch_vectors(nv: int) -> int:
    """Of a row's ``nv`` 16-byte vectors, those a thread loads into
    registers before it sums any: the smallest of ``PREFETCH_VECTORS`` that
    covers them, at most 4 (the rest load during the sum); 0 for the
    code-by-code path."""
    return next((p for p in PREFETCH_VECTORS if p >= nv), 4) if nv else 0


def launch(codes: torch.Tensor, ids: torch.Tensor, luts: torch.Tensor,
           m_eff: int, out: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on checked tensors over the first ``m_eff``
    subspaces; no validation here."""
    global launches, launches_i32
    q, r = ids.shape
    n_rows, m = codes.shape
    k = luts.shape[2]
    if q and r:
        size = codes.element_size()
        pre = prefetch_vectors(row_vectors(codes.data_ptr(), m, 0, m_eff, size))
        err = _entry()(codes.data_ptr(), size, n_rows, m, ids.data_ptr(), q, r,
                       luts.data_ptr(), m * k, k, m_eff, pre, out.data_ptr(),
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
    kernel checks it with a device-side assert (the next synchronization
    raises), not a Python exception. Codes must be below K. ``0 < m_prefix
    < M`` sums the first ``m_prefix`` subspaces only."""
    for name, t, dtypes, ndim in (("codes", codes, CODE_DTYPES, 2),
                                  ("ids", ids, (torch.int32,), 2),
                                  ("luts", luts, (torch.float32,), 3)):
        if not t.is_cuda or t.get_device() != codes.get_device():
            raise ValueError(f"hop_adc: {name} must be on {codes.device} (CUDA)")
        if t.dtype not in dtypes or t.dim() != ndim or not t.is_contiguous():
            raise ValueError(f"hop_adc: {name} must be a contiguous {ndim}-d "
                             f"{' or '.join(map(str, dtypes))} tensor, got "
                             f"{t.dtype} {tuple(t.shape)}")
    q, _ = ids.shape
    m = codes.shape[1]
    if luts.shape[:2] != (q, m):
        raise ValueError(f"hop_adc: luts {tuple(luts.shape)} do not match "
                         f"ids {tuple(ids.shape)} and codes {tuple(codes.shape)}")
    m_eff = m_prefix if 0 < m_prefix < m else m
    out = torch.empty(ids.shape, dtype=torch.float32, device=codes.device)
    return launch(codes, ids, luts, m_eff, out)
