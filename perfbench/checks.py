"""The comparison that decides ``correct``: what the timed path produced,
held against the plain reference (``reference.py``).

The numbers, each with a limit in the configuration's ``checks``:

- ``id_faults``: answers that are not a valid top-k (an id that names no
  row live at its call, an id twice, distances out of order or not finite,
  or no answer at all). Exact: limit 0.
- ``dist_err``: the largest gap between a returned distance and the
  reference's exact distance of the same query and row, over every answer
  of the window, as a share of the median exact distance.
- ``lut_err`` (u8 layout): the largest gap between an entry of a lookup
  table that the routing read and the reference's, over the kept tables,
  as a share of the median entry.
- ``lut_flips`` (fs4 layout): the share of uint8 table entries that differ
  from the reference's own quantization of its own tables.
- ``code_flips``: the share of base rows whose resident code differs from
  the reference's encoding.
- ``adc_err`` (u8 layout): the largest gap between a distance that the
  routing kernel (``hop_adc``) returned, in launches sampled over the
  window, and the reference's sum of its own tables over the codes the
  kernel was given, as a share of the median sum.
- ``adc_flips`` (fs4 layout): the share of the sampled ``hop_adc_fs``
  slots whose distance is not the reference's: its own uint8 tables
  summed over the packed codes the kernel was given, then dequantized
  (a gap of half a quantization step or more).
- ``recall_loss``: 1 − recall@10 of the window's answers (a sample drawn
  from the seed) against the reference's exact top-10: the search has to
  find the neighbours, not only return valid ones.

The rows live at a call: the base, where the window wrote nothing. A mode
that writes keeps a log (``traffic.Writes``); the reference replays it
(``reference.replay``) and reads each answer's ids as the keys of rows by
the map in force at its call, so a deleted row, a row never inserted and
an id read by a stale map are id faults, and the exact top-k of each
answer is taken over the rows live at its call.

:func:`control` puts the reference, computed at TF32, in the program's
place; its readings set the upper ends of the limits.
"""

from __future__ import annotations

import dataclasses

import torch

from perfbench import reference as ref

BLOCK = 8192   # answers per block of the distance comparison
HOST_BLOCK = 1 << 20   # answers per block of the id comparison, on the host
# the program's routing kernel of each layout: (module, entry point)
ROUTING = {"u8": ("repro_torch.kernels.ops", "hop_adc"),
           "fs4": ("repro_torch.kernels.ops", "hop_adc_fs")}


@dataclasses.dataclass
class Outputs:
    """What the timed path produced, and the inputs it was given."""
    queries: torch.Tensor     # (A, D) answered queries, on the device
    ids: torch.Tensor         # (A, k) returned ids, on the host
    dists: torch.Tensor       # (A, k) returned distances, on the host
    unanswered: int           # queries due in the window with no answer
    lut_queries: torch.Tensor  # (L, D) queries whose tables were kept
    luts: object              # (L, M, K) f32, or (u8 (L, M, 16), scale, bias)
    codes: torch.Tensor       # resident codes: (N, M) u8 or (N, M/2) packed
    adc: list = dataclasses.field(default_factory=list)
    #   sampled routing launches: (queries (Q, D), codes given, ids (Q, R), distances (Q, R))
    pos: torch.Tensor = None  # (A,) entries of the write log made before each answer's call
    writes: object = None     # the windows' traffic.Writes; None: they wrote nothing


def _groups(out: Outputs, n_base: int, rows: torch.Tensor = None, size: int = None):
    """(i, live) for the answers ``rows`` (default: all), grouped by the
    write-log position of their calls in log order and cut into blocks of at
    most ``size``: ``i`` indexes ``rows``, ``live`` (``reference.Live``)
    holds the rows live at those calls and the map of ids to keys."""
    a = out.ids.shape[0] if rows is None else rows.shape[0]
    pos = torch.zeros(a, dtype=torch.int64) if out.pos is None else (
        out.pos if rows is None else out.pos[rows])
    order = torch.argsort(pos, stable=True)
    at, counts = torch.unique_consecutive(pos[order], return_counts=True)
    log = [] if out.writes is None else out.writes.log
    for part, (_, live) in zip(torch.split(order, counts.tolist()),
                               ref.replay(n_base, log, at.tolist())):
        step = size or part.shape[0]
        for s in range(0, part.shape[0], step):
            yield part[s:s + step], live


def _key_vectors(out: Outputs, x: torch.Tensor) -> torch.Tensor:
    """One row a key: the base, then the inserted rows."""
    if out.writes is None or not out.writes.vectors:
        return x
    return torch.cat([x] + [v.to(x.device) for v in out.writes.vectors])


def _id_faults(out: Outputs, n_base: int, k: int) -> int:
    ids, dists = out.ids, out.dists
    if ids.shape[1] != k:
        return ids.shape[0]
    bad = ~torch.isfinite(dists).all(1)
    for i, live in _groups(out, n_base, size=HOST_BLOCK):
        bad[i] |= ~live.alive(live.keys(ids[i])).all(1)
    s, _ = torch.sort(ids.long(), dim=1)
    bad |= (s[:, 1:] == s[:, :-1]).any(1)
    bad |= (dists[:, 1:] < dists[:, :-1]).any(1)
    return int(bad.sum())


def _dist_err(out: Outputs, x: torch.Tensor) -> float:
    vecs = _key_vectors(out, x)
    worst, scales = 0.0, []
    for i, live in _groups(out, x.shape[0], size=BLOCK):
        keys = live.keys(out.ids[i].to(x.device))
        d = out.dists[i].to(x.device).float()
        ok = keys >= 0
        d_ref = ref.pair_distances(out.queries[i.to(x.device)], vecs[torch.where(ok, keys, 0)])
        gap = torch.where(ok & torch.isfinite(d), (d - d_ref).abs(), 0.0)
        worst = max(worst, float(gap.max()) if gap.numel() else 0.0)
        scales.append(d_ref[ok])
    scale = float(torch.cat(scales).median()) if scales else 1.0
    return worst / max(scale, 1e-30)


def neighbours(out: Outputs, x: torch.Tensor, rows: torch.Tensor, k: int) -> tuple:
    """(the answers ``rows`` read as keys (-1: an id that named no row), the
    reference's exact top-k keys of their queries over the rows live at
    each one's call)."""
    vecs = _key_vectors(out, x)
    got = torch.empty((rows.shape[0], out.ids.shape[1]), dtype=torch.int64)
    want = torch.empty((rows.shape[0], k), dtype=torch.int64)
    for i, live in _groups(out, x.shape[0], rows):
        a = rows[i]
        base, keys = live.rows(vecs)
        top = ref.exact_topk(base, out.queries[a.to(x.device)], k)
        want[i] = (top if keys is None else keys[top]).cpu()
        got[i] = live.keys(out.ids[a])
    return got, want


def adc_sums(launch: tuple, r: torch.Tensor, codebooks: torch.Tensor, layout: str,
             tf32: bool = False) -> tuple:
    """(distances, quantization step or None) that the reference gives for
    one sampled routing launch: its own tables of the launch's queries,
    summed over the codes the kernel was given at the launch's ids (fs4:
    its own uint8 tables, dequantized as the program dequantizes)."""
    q, codes, ids, _ = launch
    t = ref.luts(q, r, codebooks, tf32=tf32)
    rows = codes[ids.long()]                                    # (Q, R, M | M/2)
    if layout != "fs4":
        return ref.adc(t, rows), None
    m = t.shape[1]
    u8, scale, lo = ref.quantize_u8(t)
    acc = ref.adc(u8, ref.unpack_nibbles(rows, m))
    return scale[:, None] * acc.float() + m * lo[:, None], scale


def _adc_reading(out: Outputs, r: torch.Tensor, codebooks: torch.Tensor, layout: str):
    if not out.adc:
        return None
    if layout == "fs4":
        flips = total = 0
        for launch in out.adc:
            want, step = adc_sums(launch, r, codebooks, layout)
            flips += int(((launch[3] - want).abs() >= 0.5 * step[:, None]).sum())
            total += want.numel()
        return flips / total
    gaps, sums = [], []
    for launch in out.adc:
        want, _ = adc_sums(launch, r, codebooks, layout)
        gaps.append(float((launch[3] - want).abs().max()))
        sums.append(want.flatten())
    return max(gaps) / max(float(torch.cat(sums).median()), 1e-30)


def readings(out: Outputs, x: torch.Tensor, theta: torch.Tensor,
             codebooks: torch.Tensor, cfg: dict, recall: float) -> dict:
    """The numbers compared, from ``out``, the recall of its answers and
    the reference."""
    r = ref.rotation(theta, cfg["dim"])
    codes = ref.encode(x, r, codebooks)
    if cfg["layout"] == "fs4":
        codes = ref.pack_nibbles(codes)
    got = {"id_faults": out.unanswered + _id_faults(out, x.shape[0], cfg["k"]),
           "dist_err": _dist_err(out, x),
           "code_flips": float((codes != out.codes).any(dim=1).float().mean()),
           "recall_loss": 1.0 - recall,
           ("adc_flips" if cfg["layout"] == "fs4" else "adc_err"):
               _adc_reading(out, r, codebooks, cfg["layout"])}
    want = ref.luts(out.lut_queries, r, codebooks)
    if cfg["layout"] == "fs4":
        got["lut_flips"] = float((ref.quantize_u8(want)[0] != out.luts[0]).float().mean())
    else:
        gap = (out.luts - want).abs().max()
        got["lut_err"] = float(gap / want.median().clamp_min(1e-30))
    return got


def control(out: Outputs, x: torch.Tensor, theta: torch.Tensor,
            codebooks: torch.Tensor, cfg: dict) -> Outputs:
    """The reference at TF32 in the program's place: its codes, its tables
    for the same queries, its routing distances at the sampled launches,
    and the same answers ranked by its distances."""
    r = ref.rotation(theta, cfg["dim"])
    codes = ref.encode(x, r, codebooks, tf32=True)
    t = ref.luts(out.lut_queries, r, codebooks, tf32=True)
    if cfg["layout"] == "fs4":
        codes, t = ref.pack_nibbles(codes), ref.quantize_u8(t)
    ids, dists = out.ids.clone(), torch.empty_like(out.dists)
    vecs = _key_vectors(out, x)
    for i, live in _groups(out, x.shape[0], size=BLOCK):
        blk = out.ids[i].to(x.device).long().clamp(0, live.id_to_key.shape[0] - 1)
        d = ref.pair_distances(out.queries[i.to(x.device)], vecs[live.keys(blk).clamp_min(0)],
                               tf32=True)
        d, order = torch.sort(d, dim=1, stable=True)
        ids[i] = blk.gather(1, order).cpu().to(ids.dtype)
        dists[i] = d.cpu()
    adc = [launch[:3] + (adc_sums(launch, r, codebooks, cfg["layout"], tf32=True)[0],)
           for launch in out.adc]
    return dataclasses.replace(out, ids=ids, dists=dists, luts=t, codes=codes, adc=adc)


def recall(ids: torch.Tensor, truth: torch.Tensor, k: int) -> float:
    """Mean |returned top-k ∩ exact top-k| / k (the exact ids are distinct)."""
    got, want = ids[:, :k].long().cpu(), truth[:, :k].long().cpu()
    return float((want[:, :, None] == got[:, None, :]).any(dim=2).float().mean())


def verdict(got: dict, limits: dict) -> tuple[bool, dict]:
    """(all within limits, {name: {"value", "limit"}}) over the numbers the
    limits name; a number that was not read fails."""
    table = {name: {"value": got.get(name), "limit": lim} for name, lim in limits.items()}
    ok = all(v["value"] is not None and v["value"] <= v["limit"] for v in table.values())
    return ok, table
