"""Dry run of every (arch × input shape) cell on the reference's production
meshes: the check that replaces the reference's compile. Port of
``repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu   # 94 records
    PYTHONPATH=src python -m repro_torch.launch.dryrun                # + the card runs
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch rpq --shape serve_1m \\
        --multi-pod-only --out reports/dryrun_torch.json

The reference lowers and compiles each cell for a 16×16 and a 2×16×16 TPU
mesh and reads XLA's memory and cost analyses. PyTorch has no such
partitioner and the port runs on one card, so each cell is checked here,
in process, for each mesh:

* ``memory.argument_bytes`` / ``memory.output_bytes``: the per-device
  shard bytes of the step's arguments and outputs under the cell's
  shardings (``dist/sharding.py``; an output without a sharding counts
  whole, as if replicated); ``fits``: the argument bytes against the
  card's HBM (``launch/mesh.hbm_capacity_bytes``);
* ``cost.flops_global``: the whole step's matmul-class FLOPs, counted by
  ``torch.utils.flop_counter.FlopCounterMode`` over a run of the step on
  the meta device (an LM train step at one and two layer units, one
  microbatch, and the count scaled: exact for a stack of identical layers
  and microbatches); ``null`` for a step that syncs the host, with the
  reason;
* ``collectives`` and ``memory.temp_bytes`` are ``null``: with no
  partitioner there are no collectives to read, and meta tensors have no
  scratch.

With ``--device cuda`` (the default) the seven ``rpq`` cells also run for
real, at full width, on ``make_host_mesh()`` (one record each, mesh
``host_1xN``): inputs from a seeded ``torch.Generator`` with ids in range
and a random R-regular graph; ``run.step_ms`` is the median of 3 runs
after one warm-up, ``run.peak_bytes`` the peak allocation after a reset,
``run.launches`` the CUDA kernels the runs launched. The exit code is 0
iff every record is ``ok``; nothing falls back.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import time
import traceback

import torch

from repro_torch.device import resolve_device
from repro_torch.dist.sharding import Sharding, tree_paths
from repro_torch.launch import cells as C
from repro_torch.launch.mesh import (PRODUCTION_MESHES, hbm_capacity_bytes,
                                     make_host_mesh, make_production_mesh)

NO_COLLECTIVES = ("no partitioner on one card: the step runs unsharded, so "
                  "there are no collectives to read")
NO_TEMP = "meta tensors allocate no scratch"
CARD_RUNS = 3   # timed runs of each card cell, after one warm-up


def _tensors(tree) -> list:
    return [t for t in tree_paths(tree).values() if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor, sharding) -> int:
    shape = sharding.shard_shape(t.shape) if sharding is not None else tuple(t.shape)
    return math.prod(shape) * t.element_size()


def per_device_bytes(tree, shardings) -> int:
    """Bytes one device holds of ``tree`` under ``shardings``, a prefix of
    the tree: a :class:`Sharding` covers its whole subtree, ``None`` means
    whole (replicated)."""
    if shardings is None or isinstance(shardings, Sharding):
        return sum(_nbytes(t, shardings) for t in _tensors(tree))
    if isinstance(shardings, dict):
        return sum(per_device_bytes(tree[k], v) for k, v in shardings.items())
    if isinstance(shardings, (tuple, list)):
        if len(shardings) != len(tree):
            raise ValueError(f"{len(shardings)} shardings for {len(tree)} subtrees")
        return sum(per_device_bytes(t, s) for t, s in zip(tree, shardings))
    raise TypeError(f"not a sharding tree: {type(shardings).__name__}")


def _count(cell):
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        out = cell.fn(*cell.args)
    return int(fc.get_total_flops()), out


def count_flops(cell) -> tuple:
    """(matmul-class FLOPs of the whole step, its outputs or None, how).

    A non-LM step runs as built. An LM cell runs under its
    ``count_overrides``; an LM train step runs at one and at two layer
    units u (its remat block) on one microbatch, f = microbatches ·
    (f(u) + (L/u − 1)·(f(2u) − f(u))), and its outputs are its declared
    shapes. A host-syncing step is not run."""
    if cell.host_sync:
        return None, None, f"not run on meta: {cell.host_sync}"
    if cell.rebuild is None:
        flops, out = _count(cell)
        return flops, out, "the step as built"
    ov = cell.count_overrides
    if cell.meta.get("mode") != "train":
        flops, out = _count(cell.rebuild(**ov))
        return flops, out, f"the step at full depth, {ov}"
    u, n = cell.layer_unit, cell.n_layers
    f1, _ = _count(cell.rebuild(n_layers=u, microbatches=1, **ov))
    f2, _ = _count(cell.rebuild(n_layers=2 * u, microbatches=1, **ov))
    flops = cell.microbatches * (f1 + (n // u - 1) * (f2 - f1))
    return flops, None, (f"{cell.microbatches} x one microbatch at {u} and {2 * u} "
                         f"layers, extrapolated to {n}, {ov}")


def _shapes(tree) -> list:
    return [[list(t.shape), str(t.dtype).replace("torch.", "")] for t in _tensors(tree)]


def check_cell(cell, hbm: int) -> dict:
    """The record's body for one built cell (see the module doc)."""
    arg_bytes = per_device_bytes(cell.args, cell.in_shardings)
    flops, out, how = count_flops(cell)
    declared = out is None
    if declared:
        out = cell.out_shapes
    return dict(
        meta=cell.meta,
        memory=dict(argument_bytes=arg_bytes,
                    output_bytes=per_device_bytes(out, cell.out_shardings),
                    temp_bytes=None, temp_bytes_reason=NO_TEMP),
        fits=arg_bytes <= hbm,
        cost=dict(flops_global=flops, flops_how=how),
        collectives=None, collectives_reason=NO_COLLECTIVES,
        outputs=dict(shapes=_shapes(out), source="declared" if declared else "meta run"))


def run_cell(arch: str, shape: str, mesh, mesh_name: str, hbm: int) -> dict:
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name}
    t0 = time.perf_counter()
    try:
        rec.update(ok=True, **check_cell(C.build_cell(arch, shape, mesh), hbm))
    except Exception as e:  # a failing cell is a bug — record it loudly
        rec.update(ok=False, error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
    rec["check_s"] = round(time.perf_counter() - t0, 3)
    return rec


# --------------------------------------------------------------------------
# the rpq cells on the card
# --------------------------------------------------------------------------

def card_args(cell, device, generator: torch.Generator) -> tuple:
    """Real inputs of an ``rpq`` cell's shapes on ``device``: codes and ids
    in range, a random R-regular graph, positive LUTs, Gaussian vectors."""
    from repro_torch.common import adam, constant_schedule
    from repro_torch.configs import get_arch
    from repro_torch.core import quantizer as Q
    from repro_torch.pq.pack import QuantizedLUT

    qcfg = get_arch("rpq").make_config().quant
    randn = lambda t: torch.randn(tuple(t.shape), generator=generator, device=device)
    rand = lambda t: torch.rand(tuple(t.shape), generator=generator, device=device)
    ints = lambda t, high: torch.randint(0, high, tuple(t.shape), generator=generator,
                                         device=device, dtype=t.dtype)
    name, a = cell.shape_name, cell.args
    if name in ("quant_train", "encode_bulk"):
        params = Q.init_params(qcfg, torch.randn((qcfg.m, qcfg.k, qcfg.dsub),
                                                 generator=generator, device=device))
        if name == "encode_bulk":
            return params, randn(a[1])
        h = a[4].shape[1]
        return (params, adam(constant_schedule(1e-3)).init(params), randn(a[2]),
                randn(a[3]), randn(a[4]), ints(a[5], h))
    if name == "adc_bulk":
        return ints(a[0], qcfg.k), rand(a[1])
    if name == "serve_1m":
        return ints(a[0], qcfg.k), randn(a[1]), rand(a[2]), randn(a[3])
    # sharded_graph*: (S, n_local, R) random graph, (S,) medoids, codes, LUTs
    n_local = a[0].shape[1]
    luts = a[3]
    if isinstance(luts, QuantizedLUT):
        luts = QuantizedLUT(lut=ints(luts.lut, 256), scale=rand(luts.scale) + 0.01,
                            bias=rand(luts.bias))
    else:
        luts = rand(luts)
    return ints(a[0], n_local), ints(a[1], n_local), ints(a[2], 256), luts


def _synced(fn, args) -> tuple:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def card_run(cell, device, seed: int = 0) -> dict:
    """One ``rpq`` cell for real on the card: a warm-up and
    :data:`CARD_RUNS` timed runs; the outputs finite and of the shapes of
    the meta run (or the declared ones)."""
    from repro_torch.kernels import ops

    gen = torch.Generator(device=device).manual_seed(seed)
    torch.manual_seed(seed)
    args = card_args(cell, device, gen)
    _, want, _ = count_flops(cell)
    want = _shapes(want if want is not None else cell.out_shapes)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    ops.reset_launch_counts()
    _synced(cell.fn, args)
    times = []
    for _ in range(CARD_RUNS):
        out, ms = _synced(cell.fn, args)
        times.append(ms)
    peak = int(torch.cuda.max_memory_allocated(device))
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    got = _shapes(out)
    finite = all(bool(torch.isfinite(t).all()) for t in _tensors(out)
                 if t.is_floating_point())
    if got != want:
        raise AssertionError(f"card outputs {got} != meta outputs {want}")
    if not finite:
        raise AssertionError("card outputs hold a non-finite value")
    return dict(device=torch.cuda.get_device_name(device), step_ms=statistics.median(times),
                step_ms_all=times, peak_bytes=peak, launches=launches)


def card_record(shape: str, device) -> dict:
    mesh = make_host_mesh(device)
    name = f"host_{mesh.shape['data']}x{mesh.shape['model']}"
    rec = run_cell("rpq", shape, mesh, name, hbm_capacity_bytes(device))
    if rec["ok"]:
        try:
            rec["run"] = card_run(C.build_cell("rpq", shape, mesh), device)
        except Exception as e:
            rec.update(ok=False, error=f"card run: {type(e).__name__}: {e}",
                       trace=traceback.format_exc()[-2000:])
    return rec


# --------------------------------------------------------------------------
# the command line
# --------------------------------------------------------------------------

def _line(rec: dict) -> str:
    status = "OK " if rec["ok"] else "FAIL"
    gb = rec.get("memory", {}).get("argument_bytes", 0) / 1e9
    flops = (rec.get("cost") or {}).get("flops_global")
    tail = ""
    if "run" in rec:
        r = rec["run"]
        tail = (f" step={r['step_ms']:.3f}ms peak={r['peak_bytes'] / 2**30:.2f}GiB "
                f"kernels={r['launches']}")
    if not rec["ok"]:
        tail = " " + rec.get("error", "")[:160]
    return (f"[{status}] {rec['mesh']:13s} {rec['arch']:22s} {rec['shape']:18s} "
            f"check={rec['check_s']:7.3f}s perdev={gb:8.3f}GB "
            f"flops={'-' if flops is None else f'{flops:.4g}'}{tail}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--out", default="reports/dryrun_torch.json")
    ap.add_argument("--append", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) also runs the rpq cells on the card; "
                         "without CUDA pass --device cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    todo = C.all_cells()
    if args.arch:
        todo = [c for c in todo if c[0] == args.arch]
    if args.shape:
        todo = [c for c in todo if c[1] == args.shape]
    meshes = [(name, make_production_mesh(multi_pod=multi))
              for name, multi in PRODUCTION_MESHES.items()
              if not (multi and args.single_pod_only or not multi and args.multi_pod_only)]
    hbm = hbm_capacity_bytes(dev)

    results = []
    if args.append and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results if r["ok"]}

    def keep(rec):
        nonlocal results
        results = [r for r in results if (r["arch"], r["shape"], r["mesh"])
                   != (rec["arch"], rec["shape"], rec["mesh"])] + [rec]
        print(_line(rec), flush=True)
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)

    t0 = time.perf_counter()
    for mesh_name, mesh in meshes:
        for arch, shape in todo:
            if (arch, shape, mesh_name) not in done:
                keep(run_cell(arch, shape, mesh, mesh_name, hbm))
    if dev.type == "cuda":
        for arch, shape in todo:
            if arch == "rpq":
                keep(card_record(shape, dev))
    n_ok = sum(r["ok"] for r in results)
    print(f"\n{n_ok}/{len(results)} records ok in {time.perf_counter() - t0:.1f} s; "
          f"report → {args.out}")
    return 0 if n_ok == len(results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
