"""Mesh-aware sharding rules for every arch family. Port of
``repro/dist/sharding.py``.

Axis semantics follow ``launch/mesh.py``: ``pod`` (DCN data parallel),
``data`` (intra-pod data/FSDP), ``model`` (tensor/expert/table/row
parallel). Every rule is divisibility-guarded: a dim that does not divide
its mesh axes is left unsharded, so the same rule set serves the 16×16
pod, the 2×16×16 multi-pod and one card's (1, n) host mesh.

The port runs on one card and has no partitioner: these rules say where
each tensor's shards would live and, through :meth:`Sharding.shard_shape`,
how many bytes each device would hold (``launch/dryrun.py``). They are
the reference's rules on the port's own trees, held to JAX's spec for
spec in ``tests/test_torch_sharding.py``.

Rules are *path-keyed* (``"table"``, ``"wq"``, ``"embed"`` ...). Paths are
built in JAX's ``keystr`` form (``['attn']['wq']``, ``.inner[0]``), so a
rule hits the same leaves of a parameter tree AND of an optimizer state
whose slots mirror it (``common.optim.OptState``).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable

from repro_torch.launch.mesh import Mesh, data_axes

_LAST_KEY_RE = re.compile(r"[A-Za-z_][A-Za-z_0-9]*")


def _entry(e):
    """One dimension's entry as JAX normalises it: a name, a tuple of two
    or more names, or None (an empty or one-name tuple folds)."""
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        if not e:
            return None
        return e[0] if len(e) == 1 else e
    return e


class P(tuple):
    """A partition spec: one entry per tensor dimension (``None``, an axis
    name, or a tuple of names); missing trailing entries are ``None``."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(_entry(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def axis_size(mesh: Mesh, axes) -> int:
    """Total device count across ``axes`` (str | tuple | None)."""
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


@dataclasses.dataclass(frozen=True)
class Sharding:
    """``spec`` laid over ``mesh``: what each device holds of a tensor."""
    mesh: Mesh
    spec: P

    def shard_shape(self, shape) -> tuple:
        """The per-device block of a ``shape`` tensor; raises on a
        dimension its axes do not divide, as JAX's ``NamedSharding``."""
        shape = tuple(int(d) for d in shape)
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more entries than shape {shape}")
        out = []
        for i, d in enumerate(shape):
            n = axis_size(self.mesh, self.spec[i]) if i < len(self.spec) else 1
            if d % n:
                raise ValueError(f"dimension {i} of shape {shape} ({d}) is not "
                                 f"divisible by {n}, the size of axes {self.spec[i]!r}")
            out.append(d // n)
        return tuple(out)


def named(mesh: Mesh, pspec: P) -> Sharding:
    """The one constructor everybody shares: pspec → Sharding."""
    return Sharding(mesh, pspec)


def _fit(mesh: Mesh, axes, dim: int):
    """``axes`` if they evenly divide ``dim`` (else None → replicate)."""
    if axes is None:
        return None
    return axes if dim % axis_size(mesh, axes) == 0 else None


def row_axes(mesh: Mesh) -> tuple:
    """All mesh axes in canonical (pod, data, model) order — the maximal
    row-sharding for big flat tables / code arrays."""
    axes = tuple(a for a in ("pod", "data", "model") if a in mesh.axis_names)
    return axes if axes else tuple(mesh.axis_names)


def flat_shard_index(mesh: Mesh, axes: tuple, coords: dict) -> int:
    """Row-major linear shard index over ``axes`` of the device at
    ``coords`` ({axis name: index}). The ONE definition of shard ordering:
    shard s of the port's engines owns rows [s·n_local, (s+1)·n_local), the
    block that ``P(axes)`` gives the device of flat index s."""
    idx = 0
    for a in axes:
        idx = idx * mesh.shape[a] + int(coords[a])
    return idx


def _leaf_name(path: str) -> str:
    keys = _LAST_KEY_RE.findall(path)
    return keys[-1] if keys else ""


# --------------------------------------------------------------------------
# Tree helpers
# --------------------------------------------------------------------------

def _map_with_path(fn: Callable[[str, Any], Any], tree, path: str = ""):
    """``fn(path, leaf)`` over a dict / list / tuple / named-tuple tree, the
    structure kept; paths in JAX's ``keystr`` form; ``None`` is an empty
    subtree (no leaf), as in JAX; a :class:`P` is a leaf."""
    if tree is None:
        return None
    if isinstance(tree, P):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{path}[{k!r}]") for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, getattr(tree, f), f"{path}.{f}")
                            for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_with_path(fn, v, f"{path}[{i}]")
                          for i, v in enumerate(tree))
    return fn(path, tree)


def tree_paths(tree) -> dict:
    """{keystr path: leaf} over ``tree``."""
    out: dict = {}
    _map_with_path(lambda p, leaf: out.__setitem__(p, leaf), tree)
    return out


def tree_pspecs(tree: Any, rule: Callable[[str, Any], P]):
    """Map ``rule(path_str, leaf) -> P`` over a tree."""
    return _map_with_path(rule, tree)


def tree_shardings(mesh: Mesh, tree: Any, fn: Callable[[str, Any], P]):
    """Like :func:`tree_pspecs` but returns :class:`Sharding`\\ s on ``mesh``."""
    return _map_with_path(lambda p, leaf: Sharding(mesh, fn(p, leaf)), tree)


# --------------------------------------------------------------------------
# LM family — Megatron TP over `model`, FSDP over `data`, batch over dp axes
# --------------------------------------------------------------------------

def lm_batch_spec(mesh: Mesh) -> P:
    """(B, ...) token batches: batch dim over all data-parallel axes."""
    return P(data_axes(mesh))


def lm_param_rule(mesh: Mesh) -> Callable[[str, Any], P]:
    """Path-keyed rule for stacked (L, ...) LM weights.

    Column-parallel (wq/wk/wv/w1/w3) shard their OUTPUT dim over `model`
    and their input dim over `data` (FSDP); row-parallel (wo/w2) the
    transpose. Embeddings shard the vocab over `model`. MoE expert stacks
    shard experts over `model` (expert parallelism). Everything 1-D
    (norms, scalars) replicates. All subject to divisibility.
    """

    def rule(path: str, leaf) -> P:
        shape = tuple(getattr(leaf, "shape", ()))
        if len(shape) <= 1:
            return P()
        name = _leaf_name(path)
        if "embed" in path:                     # (Vpad, D)
            return P(_fit(mesh, "model", shape[0]),
                     _fit(mesh, "data", shape[1]))
        if "lm_head" in path:                   # (D, Vpad)
            return P(_fit(mesh, "data", shape[0]),
                     _fit(mesh, "model", shape[1]))
        if "router" in path:                    # (L, D, E)
            return P(None, None, _fit(mesh, "model", shape[2]))
        if "moe" in path and len(shape) == 4:   # (L, E, din, dout)
            if name in ("w1", "w3"):
                return P(None, _fit(mesh, "model", shape[1]),
                         _fit(mesh, "data", shape[2]), None)
            return P(None, _fit(mesh, "model", shape[1]), None,
                     _fit(mesh, "data", shape[3]))
        if name in ("wq", "wk", "wv", "w1", "w3") and len(shape) == 3:
            return P(None, _fit(mesh, "data", shape[1]),
                     _fit(mesh, "model", shape[2]))
        if name in ("wo", "w2") and len(shape) == 3:
            return P(None, _fit(mesh, "model", shape[1]),
                     _fit(mesh, "data", shape[2]))
        return P()

    return rule


def lm_shardings(mesh: Mesh, cfg, params_shape, opt_shape):
    """(param shardings, optimizer-state shardings) for one LM config: the
    same path-keyed rule over both trees, so Adam moments co-shard with
    their parameters."""
    del cfg  # rules are shape/path-driven
    rule = lm_param_rule(mesh)
    return (tree_shardings(mesh, params_shape, rule),
            tree_shardings(mesh, opt_shape, rule))


def lm_cache_spec(mesh: Mesh, batch: int, seq_len: int) -> P:
    """(L, B, S, Hkv, dh) KV-cache spec.

    Batched decode/prefill shards B over the dp axes and S over `model`;
    single-sequence long-context decode (B=1) shards S over EVERY axis
    instead — element [2] of the returned spec is the decode attention's
    sequence placement (``LMConfig.act_seq_axis``).
    """
    dp = data_axes(mesh)
    if batch % max(axis_size(mesh, dp), 1) == 0 and batch > 1:
        return P(None, dp, _fit(mesh, "model", seq_len), None, None)
    all_ax = row_axes(mesh)
    seq = _fit(mesh, all_ax, seq_len) or _fit(mesh, "model", seq_len)
    return P(None, None, seq, None, None)


# --------------------------------------------------------------------------
# GNN family — edge lists row-sharded over every axis (degree parallelism)
# --------------------------------------------------------------------------

def gnn_edge_spec(mesh: Mesh) -> P:
    """1-D (E,) src/dst/mask arrays, padded to a device-count multiple,
    sharded over all axes."""
    return P(row_axes(mesh))


# --------------------------------------------------------------------------
# Recsys family — the mega-table is the only big tensor; row-shard it
# --------------------------------------------------------------------------

def _is_table(path: str) -> bool:
    return "table" in path or "item_emb" in path


def recsys_table_rule(mesh: Mesh, table_axes: str = "model"
                      ) -> Callable[[str, Any], P]:
    axes = row_axes(mesh) if table_axes == "all" else ("model",)
    axes = tuple(a for a in axes if a in mesh.axis_names)

    def rule(path: str, leaf) -> P:
        shape = tuple(getattr(leaf, "shape", ()))
        if len(shape) >= 1 and _is_table(path) and _fit(mesh, axes, shape[0]):
            return P(axes, *([None] * (len(shape) - 1)))
        return P()

    return rule


def recsys_shardings(mesh: Mesh, params_shape, opt_shape, *,
                     table_axes: str = "model"):
    """(param, opt) shardings: embedding mega-tables row-sharded over
    ``table_axes`` ("model" = table parallel; "all" = every axis, the DLRM
    layout), dense towers replicated; optimizer slots co-shard with their
    parameters."""
    rule = recsys_table_rule(mesh, table_axes)
    return (tree_shardings(mesh, params_shape, rule),
            tree_shardings(mesh, opt_shape, rule))


# --------------------------------------------------------------------------
# RPQ (the paper's system) — tiny replicated quantizer, row-sharded codes
# --------------------------------------------------------------------------

def rpq_rows_spec(mesh: Mesh) -> P:
    """(N, ...) code/vector arrays row-sharded over every mesh axis — the
    serving layout: device s owns rows [s·N/n, (s+1)·N/n)."""
    return P(row_axes(mesh))


def rpq_shard_stack_spec(mesh: Mesh, ndim: int = 3) -> P:
    """(S, n_local, ...) shard-STACKED arrays (graph-routed serving): the
    leading shard axis over every mesh axis, a shard's local rows and
    columns never split — the layout of ``graphs.partition``'s stacks."""
    return P(row_axes(mesh), *([None] * (ndim - 1)))


def rpq_param_spec(mesh: Mesh, params_shape):
    """RPQ quantizer params are ≤ a few MB — fully replicated."""
    return tree_shardings(mesh, params_shape, lambda p, l: P())
