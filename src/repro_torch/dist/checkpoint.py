"""Atomic, rotating, CRC-verified checkpoints of trees of tensors.

Port of ``repro/dist/checkpoint.py`` with the same on-disk format, byte
for byte, so a checkpoint written by either package restores in the
other. Layout: ``<dir>/step_00000123/`` holds, per saved tree, a
``<name>.json`` structure file and a ``<name>.npz`` of raw leaf buffers
(``a0``, ``a1``, … as ``uint8``), plus ``_meta.json``.

* **atomic** — everything is written into a ``.tmp-*`` staging directory
  and ``os.replace``-renamed into place; a crash mid-save never leaves a
  half-written step visible to ``latest_step``.
* **rotating** — ``save(..., keep=N)`` prunes all but the newest N steps.
* **verified** — every array node of the ``.json`` manifest carries the
  CRC32 of its raw bytes, checked on decode (:class:`ChecksumError`).

Leaves are tensors or numpy arrays; a tensor is saved through
``tensor.detach().cpu().numpy()``, and ``restore`` returns tensors on
``device`` (default ``cuda``). Non-array leaves (str/int/float/bool/None)
round-trip through the JSON structure. NamedTuple nodes restore as plain
field dicts unless a ``like`` template supplies the concrete type (the
port's ``RPQParams`` and ``OptState`` carry the reference's names and
fields). A bfloat16 or float8 leaf, which numpy cannot hold, is written as
its raw bytes under the dtype name ``ml_dtypes`` gives it (``bfloat16``,
``float8_e4m3fn``, …), the bytes the reference writes, and restores as the
torch dtype of that name.
"""

from __future__ import annotations

import json
import os
import shutil
import zlib
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.dist import retry as _retry

_STEP_PREFIX = "step_"


class ChecksumError(ValueError):
    """An array's bytes don't match the CRC32 its manifest recorded."""


class Dropped(NamedTuple):
    """Placeholder for an array skipped via ``restore(drop=...)``: the
    manifest's shape and dtype, without the bytes ever being read."""

    shape: tuple
    dtype: str


# Chaos seam (DESIGN.md §13): drills install a hook that may raise
# TransientIOError before any step-directory read; `restore(retry=...)`
# wraps the read. None in production.
_IO_FAULT_HOOK: Optional[Callable[[str], None]] = None


def set_io_fault_hook(hook: Optional[Callable[[str], None]]) -> None:
    global _IO_FAULT_HOOK
    _IO_FAULT_HOOK = hook


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"{_STEP_PREFIX}{step:08d}")


def _is_array(obj) -> bool:
    return isinstance(obj, (torch.Tensor, np.ndarray, np.generic))


# torch dtypes numpy cannot hold, under the names ml_dtypes gives them in
# the reference's manifests, each with the integer dtype of its bytes
_RAW_DTYPES = {name: (getattr(torch, name), bits)
               for name, bits in (("bfloat16", torch.int16),
                                  ("float8_e4m3fn", torch.uint8),
                                  ("float8_e4m3fnuz", torch.uint8),
                                  ("float8_e5m2", torch.uint8),
                                  ("float8_e5m2fnuz", torch.uint8),
                                  ("float8_e8m0fnu", torch.uint8))
               if hasattr(torch, name)}
_RAW_NAMES = {dtype: name for name, (dtype, _) in _RAW_DTYPES.items()}


def _to_numpy(obj) -> tuple[np.ndarray, str]:
    """A leaf as (numpy array of its bytes' layout, manifest dtype name)."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        name = _RAW_NAMES.get(t.dtype)
        if name is not None:
            return t.contiguous().view(_RAW_DTYPES[name][1]).numpy(), name
        try:
            a = t.numpy()
        except TypeError as e:
            raise TypeError(f"checkpoint: cannot save a {t.dtype} leaf") from e
        return a, str(a.dtype)
    a = np.asarray(obj)
    return a, str(a.dtype)


def _from_raw(raw: bytes, name: str, shape) -> torch.Tensor:
    """A leaf's bytes as the tensor its manifest names (CPU)."""
    if name in _RAW_DTYPES:
        dtype, bits = _RAW_DTYPES[name]
        a = np.frombuffer(raw, torch.empty(0, dtype=bits).numpy().dtype)
        return torch.from_numpy(a.reshape(shape).copy()).view(dtype)
    try:
        a = np.frombuffer(raw, np.dtype(name))
    except TypeError as e:
        raise TypeError(f"checkpoint: leaf dtype {name!r} has no numpy or "
                        f"torch name") from e
    return torch.from_numpy(a.reshape(shape).copy())


def _encode(obj, arrays: list) -> Any:
    if _is_array(obj):
        a, name = _to_numpy(obj)
        raw = a.tobytes()
        arrays.append(np.frombuffer(raw, np.uint8))
        return {"kind": "array", "i": len(arrays) - 1,
                "dtype": name, "shape": list(a.shape),
                "crc32": zlib.crc32(raw)}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):  # NamedTuple
        return {"kind": "namedtuple", "name": type(obj).__name__,
                "fields": {f: _encode(getattr(obj, f), arrays)
                           for f in obj._fields}}
    if isinstance(obj, dict):
        return {"kind": "dict",
                "items": {str(k): _encode(v, arrays) for k, v in obj.items()}}
    if isinstance(obj, (list, tuple)):
        return {"kind": "list" if isinstance(obj, list) else "tuple",
                "items": [_encode(v, arrays) for v in obj]}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return {"kind": "value", "v": obj}
    raise TypeError(f"checkpoint: cannot serialize leaf of type {type(obj)}")


def _decode(node, arrays, device, path: str = "", drop=()) -> Any:
    kind = node["kind"]
    if kind == "array":
        if path in drop:
            return Dropped(shape=tuple(node["shape"]),
                           dtype=str(node["dtype"]))
        raw = arrays[f"a{node['i']}"].tobytes()
        want = node.get("crc32")   # absent in pre-§13 checkpoints
        if want is not None:
            got = zlib.crc32(raw)
            if got != want:
                raise ChecksumError(
                    f"checkpoint array a{node['i']} "
                    f"(dtype={node['dtype']}, shape={node['shape']}): "
                    f"crc32 {got:#010x} != manifest {want:#010x} — "
                    "snapshot bytes are corrupt")
        return _from_raw(raw, node["dtype"], node["shape"]).to(device)
    if kind == "namedtuple":
        return {f: _decode(v, arrays, device, f"{path}/{f}", drop)
                for f, v in node["fields"].items()}
    if kind == "dict":
        return {k: _decode(v, arrays, device, f"{path}/{k}", drop)
                for k, v in node["items"].items()}
    if kind in ("list", "tuple"):
        seq = [_decode(v, arrays, device, f"{path}/{i}", drop)
               for i, v in enumerate(node["items"])]
        return seq if kind == "list" else tuple(seq)
    return node["v"]


def _restore_like(like, decoded) -> Any:
    """Re-impose ``like``'s container types (NamedTuples etc.) on a decoded
    tree; leaf VALUES always come from the checkpoint."""
    if like is None or _is_array(decoded) or not isinstance(
            decoded, (dict, list, tuple)):
        return decoded
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        fields = (decoded["fields"] if isinstance(decoded, dict)
                  and "fields" in decoded else decoded)
        return type(like)(**{f: _restore_like(getattr(like, f), fields[f])
                             for f in like._fields})
    if isinstance(like, dict) and isinstance(decoded, dict):
        return {k: _restore_like(like[k], v) if k in like else v
                for k, v in decoded.items()}
    if isinstance(like, (list, tuple)) and isinstance(decoded, (list, tuple)):
        out = [_restore_like(l, d) for l, d in zip(like, decoded)]
        return type(like)(out) if isinstance(like, list) else tuple(out)
    return decoded


def save(directory: str, step: int, keep: Optional[int] = None,
         **trees) -> str:
    """Atomically write ``trees`` (params=..., opt=..., extra=...) at ``step``.

    Returns the final step directory. With ``keep=N``, prunes to the newest
    N steps afterwards.
    """
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f".tmp-{step:08d}-{os.getpid()}")
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    try:
        for name, tree in trees.items():
            arrays: list = []
            structure = _encode(tree, arrays)
            with open(os.path.join(tmp, f"{name}.json"), "w") as f:
                json.dump(structure, f)
            np.savez(os.path.join(tmp, f"{name}.npz"),
                     **{f"a{i}": a for i, a in enumerate(arrays)})
        with open(os.path.join(tmp, "_meta.json"), "w") as f:
            json.dump({"step": int(step), "trees": sorted(trees)}, f)
        final = _step_dir(directory, step)
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    finally:
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
    if keep is not None:
        for s in all_steps(directory)[:-keep]:
            shutil.rmtree(_step_dir(directory, s))
    return _step_dir(directory, step)


def all_steps(directory: str) -> list[int]:
    """Sorted list of complete checkpoint steps under ``directory``."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for d in os.listdir(directory):
        if d.startswith(_STEP_PREFIX) and os.path.isfile(
                os.path.join(directory, d, "_meta.json")):
            try:
                steps.append(int(d[len(_STEP_PREFIX):]))
            except ValueError:
                continue
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, step: Optional[int] = None,
            like: Optional[dict] = None,
            retry: Optional[_retry.RetryPolicy] = None,
            drop=(), device=None) -> dict:
    """Load a checkpoint: ``{"step": s, "<name>": tree, ...}``, array
    leaves as tensors on ``device`` (default ``cuda``).

    ``step=None`` loads the latest; no checkpoints at all raises
    ``FileNotFoundError("no checkpoints under <dir>")``, and an explicit
    ``step`` that doesn't exist raises one naming the steps that do. Every
    array is CRC32-verified against its manifest (:class:`ChecksumError`,
    never retried). ``like={"<name>": template}`` re-imposes the template's
    container types on the named trees. ``retry`` retries transient read
    failures (``TransientIOError`` and ``OSError``) with backoff seeded by
    the step number. ``drop`` names array leaves to skip, as slash paths
    rooted at the tree name; each comes back as a :class:`Dropped`.
    """
    dev = resolve_device(device)
    steps = all_steps(directory)
    if step is None:
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {directory!r}")
        step = steps[-1]
    elif step not in steps:
        raise FileNotFoundError(
            f"no checkpoint for step {step} under {directory!r} "
            f"(available: {steps if steps else 'none'})")
    sdir = _step_dir(directory, step)

    def _read() -> dict:
        if _IO_FAULT_HOOK is not None:
            _IO_FAULT_HOOK(sdir)
        with open(os.path.join(sdir, "_meta.json")) as f:
            meta = json.load(f)
        out: dict = {"step": meta["step"]}
        for name in meta["trees"]:
            with open(os.path.join(sdir, f"{name}.json")) as f:
                structure = json.load(f)
            with np.load(os.path.join(sdir, f"{name}.npz")) as arrays:
                decoded = _decode(structure, arrays, dev, name,
                                  frozenset(drop))
            if like is not None and name in like:
                decoded = _restore_like(like[name], decoded)
            out[name] = decoded
        return out

    if retry is None:
        return _read()
    out, _ = _retry.call_with_retry(
        _read, policy=retry,
        retry_on=(_retry.TransientIOError, OSError), seed=int(step))
    return out
