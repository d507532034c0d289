"""The plain reference: what the program derives, worked out again in plain
PyTorch, and the exact neighbours.

Imports nothing of the program. From the program's trained quantizer (the
rotation generator ``theta`` and the codebooks, the state that set-up
trains) it derives the rotation, the base's codes and the queries' lookup
tables itself; from the benchmark's own base and queries it computes exact
squared distances and the exact top-k. Where a window wrote, it replays the
window's log (:func:`replay`) for the rows live at each call.

Every function takes ``tf32``: ``False`` is the reference, full float32
with TF32 off; ``True`` is the control, the same arithmetic with the
inputs of its matrix products rounded to TF32 (10 mantissa bits, as the
tensor cores read them) and summed in f32: the nearest precision below the
float32 that the configurations state, the same on the card and the CPU.
A control that passes the comparisons would show that they cannot tell
float32 from TF32.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

TABLE_ELEMS = 2 ** 27    # terms per block of a direct distance table (512 MB)
QUERY_ROWS = 1024        # queries per block of the exact search
BASE_ROWS = 262144       # base rows per block of the exact search
SHORTLIST = 64           # TF32 candidates per query rescored exactly


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """TF32 on or off for the products inside the block, restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32's 10 mantissa bits (to nearest, ties
    away from zero), still stored as f32."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    """a @ b in full f32, or (control) with both inputs rounded to TF32."""
    if tf32:
        a, b = to_tf32(a), to_tf32(b)
    with matmul_precision(False):
        return a.float() @ b.float()


def rotation(theta: torch.Tensor, dim: int) -> torch.Tensor:
    """R = expm(A), A skew-symmetric with ``theta`` as its strict upper
    triangle in row-major order; the exponential in float64, then f32."""
    rows, cols = torch.triu_indices(dim, dim, offset=1, device=theta.device)
    a = torch.zeros((dim, dim), dtype=torch.float64, device=theta.device)
    a[rows, cols] = theta.double()
    return torch.linalg.matrix_exp(a - a.T).float()


def _rotate(x: torch.Tensor, r: torch.Tensor, m: int, tf32: bool) -> torch.Tensor:
    return matmul(x, r.T, tf32).reshape(x.shape[0], m, -1)


def subspace_table(sub: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """(n, M, dsub) sub-vectors × (M, K, dsub) codebooks → (n, M, K)
    squared distances, summed term by term (no expansion)."""
    return ((sub[:, :, None, :] - codebooks[None]) ** 2).sum(dim=-1)


def _rows(codebooks: torch.Tensor) -> int:
    """Rows per block so that a direct table holds TABLE_ELEMS terms."""
    return max(1, TABLE_ELEMS // codebooks.numel())


def encode(x: torch.Tensor, r: torch.Tensor, codebooks: torch.Tensor, *,
           tf32: bool = False) -> torch.Tensor:
    """(N, D) → (N, M) codes, the nearest codeword per subspace (ties to
    the lower index), as uint8."""
    m, step = codebooks.shape[0], _rows(codebooks)
    out = torch.empty((x.shape[0], m), dtype=torch.uint8, device=x.device)
    for s in range(0, x.shape[0], step):
        sub = _rotate(x[s:s + step], r, m, tf32)
        out[s:s + step] = subspace_table(sub, codebooks).argmin(dim=-1).to(torch.uint8)
    return out


def pack_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """(N, M) codes in [0, 16) → (N, ceil(M/2)) bytes: sub-code 2b in the
    low nibble of byte b, 2b+1 in its high nibble."""
    c = codes.to(torch.uint8)
    if c.shape[1] % 2:
        c = torch.cat([c, torch.zeros_like(c[:, :1])], dim=1)
    return c[:, 0::2] | (c[:, 1::2] << 4)


def unpack_nibbles(packed: torch.Tensor, m: int) -> torch.Tensor:
    """(..., ceil(M/2)) bytes → (..., M) sub-codes, the inverse of
    :func:`pack_nibbles`."""
    c = torch.stack([packed & 0xF, packed >> 4], dim=-1)
    return c.reshape(*packed.shape[:-1], -1)[..., :m]


def luts(q: torch.Tensor, r: torch.Tensor, codebooks: torch.Tensor, *,
         tf32: bool = False) -> torch.Tensor:
    """(Q, D) queries → (Q, M, K) f32 tables of squared sub-distances."""
    step = _rows(codebooks)
    return torch.cat([subspace_table(_rotate(q[s:s + step], r, codebooks.shape[0], tf32),
                                     codebooks) for s in range(0, q.shape[0], step)])


def quantize_u8(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(Q, M, K) f32 → per-query uint8 tables, (scale, bias): one affine
    per query from its smallest and largest entry, rounded half to even,
    K padded to 16 columns with zeros."""
    q = t.shape[0]
    flat = t.reshape(q, -1)
    lo, hi = flat.min(dim=1).values, flat.max(dim=1).values
    scale = torch.where(hi > lo, (hi - lo) / 255.0, torch.ones_like(hi))
    u8 = torch.clamp(torch.round((t - lo[:, None, None]) / scale[:, None, None]),
                     0, 255).to(torch.uint8)
    if u8.shape[2] < 16:
        u8 = torch.nn.functional.pad(u8, (0, 16 - u8.shape[2]))
    return u8, scale, lo


def adc(t: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """(Q, M, K) tables, (Q, R, M) sub-codes → (Q, R) sums of each slot's
    M table entries, in the tables' type (int64 for uint8 tables)."""
    got = t.gather(2, codes.long().permute(0, 2, 1))            # (Q, M, R)
    return got.long().sum(dim=1) if t.dtype == torch.uint8 else got.sum(dim=1)


def pair_distances(q: torch.Tensor, v: torch.Tensor, *, tf32: bool = False) -> torch.Tensor:
    """(Q, D) queries, (Q, k, D) vectors → (Q, k) squared distances: term
    by term for the reference; for the control, ‖q‖² + ‖v‖² − 2 q·v with
    the dot products of TF32 inputs."""
    q, v = q.float(), v.float()
    if not tf32:
        return ((v - q[:, None, :]) ** 2).sum(dim=-1)
    dots = matmul(v, q[:, :, None], True)[:, :, 0]
    return (q * q).sum(dim=1)[:, None] + (v * v).sum(dim=2) - 2.0 * dots


def _tf32_error_bound(qn: torch.Tensor, bn_max: torch.Tensor) -> torch.Tensor:
    """A bound on |d − d̃| for d̃ = ‖q‖² + ‖x‖² − 2·tf32(q·x): TF32 rounds
    each input to 11 significant bits (relative 2⁻¹¹ each) and sums in
    f32, so |q·x − tf32(q·x)| ≤ (2⁻¹⁰ + 2⁻²⁰)·‖q‖·‖x‖; the f32 sums of the
    three terms add a few ulps of their magnitudes. Doubled for room."""
    qnorm, bnorm = qn.sqrt(), bn_max.sqrt()
    dot_err = 2.0 * (2.0 ** -10 + 2.0 ** -20) * qnorm * bnorm
    sum_err = 8.0 * 2.0 ** -24 * (qn + bn_max + 2.0 * qnorm * bnorm)
    return 2.0 * (dot_err + sum_err)


def exact_topk(base: torch.Tensor, queries: torch.Tensor, k: int
               ) -> torch.Tensor:
    """(Q, k) int64 ids of the k nearest base rows by squared L2, exact in
    f32, ties to the lower id.

    A TF32 product shortlists ``SHORTLIST`` rows per query block by block;
    the shortlist is rescored term by term in f32. A query whose k-th exact
    distance is not below the shortlist's last TF32 distance minus the
    TF32 error bound (so a row outside might be nearer) is searched again
    exactly over the whole base, one query at a time."""
    base = base.float()
    bn = (base * base).sum(dim=1)
    bn_max = bn.max()
    out = torch.empty((queries.shape[0], k), dtype=torch.int64, device=base.device)
    s_len = min(SHORTLIST, base.shape[0])
    for qs in range(0, queries.shape[0], QUERY_ROWS):
        q = queries[qs:qs + QUERY_ROWS].float()
        qn = (q * q).sum(dim=1)
        best_d = torch.full((q.shape[0], 0), float("inf"), device=base.device)
        best_i = torch.zeros((q.shape[0], 0), dtype=torch.int64, device=base.device)
        for bs in range(0, base.shape[0], BASE_ROWS):
            with matmul_precision(True):
                dots = q @ base[bs:bs + BASE_ROWS].T
            d = qn[:, None] + bn[None, bs:bs + BASE_ROWS] - 2.0 * dots
            vals, idx = torch.topk(d, min(s_len, d.shape[1]), dim=1, largest=False)
            best_d = torch.cat([best_d, vals], dim=1)
            best_i = torch.cat([best_i, idx + bs], dim=1)
            best_d, sel = torch.topk(best_d, min(s_len, best_d.shape[1]), dim=1,
                                     largest=False)
            best_i = best_i.gather(1, sel)
        exact = pair_distances(q, base[best_i])
        out[qs:qs + q.shape[0]], kth = _ranked(best_i, exact, k)
        unsure = kth >= best_d.max(dim=1).values - _tf32_error_bound(qn, bn_max)
        if s_len == base.shape[0]:
            unsure[:] = False
        for i in torch.nonzero(unsure).flatten().tolist():
            d = ((base - q[i]) ** 2).sum(dim=1)
            ids = torch.arange(base.shape[0], device=base.device)
            out[qs + i], _ = _ranked(ids[None], d[None], k)
    return out


def _ranked(ids: torch.Tensor, d: torch.Tensor, k: int):
    """The k best of each row by (distance, id), and each row's k-th
    distance."""
    by_id = torch.argsort(ids, dim=1)
    ids, d = ids.gather(1, by_id), d.gather(1, by_id)
    order = torch.argsort(d, dim=1, stable=True)[:, :k]
    return ids.gather(1, order), d.gather(1, order)[:, -1]


@dataclasses.dataclass
class Live:
    """The rows live at one point of a write log: ``live`` (n_keys,) bool
    over the keys (``[0, n_base)`` the base rows, then the inserted rows in
    order), and ``id_to_key`` (n_ids,), the engine's map from its ids to
    keys in force there (-1: the id names no row)."""
    live: torch.Tensor
    id_to_key: torch.Tensor

    def __post_init__(self):
        self._on = {}

    def _map(self, device) -> tuple:
        if device not in self._on:
            self._on[device] = (self.id_to_key.to(device), self.live.to(device))
        return self._on[device]

    def keys(self, ids: torch.Tensor) -> torch.Tensor:
        """The keys of the rows that engine ids name; -1 where an id names none."""
        ids = ids.long()
        m = self._map(ids.device)[0]
        ok = (ids >= 0) & (ids < m.shape[0])
        return torch.where(ok, m[torch.where(ok, ids, 0)], -1)

    def alive(self, keys: torch.Tensor) -> torch.Tensor:
        """Whether each key names a live row."""
        return (keys >= 0) & self._map(keys.device)[1][keys.clamp_min(0)]

    def rows(self, vectors: torch.Tensor):
        """(the live rows of ``vectors``, one row a key, and their keys), or
        (``vectors``, None) where every key is live."""
        if bool(self.live.all()):
            return vectors, None
        keys = torch.nonzero(self.live).flatten().to(vectors.device)
        return vectors[keys], keys


def replay(n_base: int, log: list, positions):
    """(p, :class:`Live`) after the first p entries of a write log, for each
    p of ``positions`` (ascending): the base rows, plus each inserted key,
    minus each deleted one; each insert's ids name its keys, and a remap
    replaces the map. Entries: ``("insert", keys, ids)``, ``("delete",
    keys)``, ``("remap", id_to_key)``."""
    n_keys = n_base + sum(len(e[1]) for e in log if e[0] == "insert")
    live = torch.zeros(n_keys, dtype=torch.bool)
    live[:n_base] = True
    id_to_key = torch.arange(n_base)
    done = 0
    for p in positions:
        for entry in log[done:p]:
            keys = torch.as_tensor(entry[1], dtype=torch.int64)
            if entry[0] == "insert":
                ids = torch.as_tensor(entry[2], dtype=torch.int64)
                live[keys] = True
                grow = int(ids.max()) + 1 - id_to_key.shape[0] if ids.numel() else 0
                if grow > 0:
                    id_to_key = torch.cat([id_to_key, torch.full((grow,), -1)])
                id_to_key[ids] = keys
            elif entry[0] == "delete":
                live[keys] = False
            else:
                id_to_key = keys.clone()
        done = p
        yield p, Live(live.clone(), id_to_key.clone())
