"""The port's dist substrate vs the JAX package's, on the CPU: retry
schedules, checkpoints (round trip, rotation, atomicity, errors, CRC, and
restores ACROSS the two packages in both directions), the chaos plan,
supervised restart and quorum resolution. Schedules, plans and decisions
are compared exactly (both sides are the same numpy/Python arithmetic);
restored arrays bit for bit."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.common import adam as j_adam
from repro.common import one_cycle as j_one_cycle
from repro.core.quantizer import RPQParams as JRPQParams
from repro.dist import checkpoint as jckpt
from repro.dist import fault as jfault
from repro.dist import retry as jretry
from repro_torch.common import adam as t_adam
from repro_torch.common import one_cycle as t_one_cycle
from repro_torch.core.quantizer import RPQParams as TRPQParams
from repro_torch.dist import checkpoint as tckpt
from repro_torch.dist import fault as tfault
from repro_torch.dist import retry as tretry

POLICIES = [dict(), dict(max_attempts=5, base_delay_s=0.02, multiplier=3.0,
                         max_delay_s=0.1, jitter=0.3),
            dict(max_attempts=4, jitter=0.0), dict(max_attempts=1)]


@pytest.mark.parametrize("kw", POLICIES, ids=["default", "capped", "nojitter", "one"])
@pytest.mark.parametrize("seed", [None, 0, 7, 12345])
def test_backoff_schedule_equals_jax(kw, seed):
    """Exact: the same numpy draws, float for float."""
    assert (tretry.backoff_schedule(tretry.RetryPolicy(**kw), seed=seed)
            == jretry.backoff_schedule(jretry.RetryPolicy(**kw), seed=seed))


@pytest.mark.parametrize("mod", [tretry, jretry], ids=["port", "jax"])
def test_retry_policy_validates(mod):
    with pytest.raises(ValueError):
        mod.RetryPolicy(max_attempts=0)
    with pytest.raises(ValueError):
        mod.RetryPolicy(jitter=1.0)


def _retry_trace(mod, fails: int, policy_kw: dict, clock_step: float = 0.0):
    """Sleeps, retry callbacks and the outcome of call_with_retry on a call
    that fails ``fails`` times, with a fake sleep and clock."""
    sleeps, retries, t = [], [], [0.0]
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        if calls["n"] <= fails:
            raise mod.TransientIOError("flaky")
        return "ok"

    def clock():
        t[0] += clock_step
        return t[0]

    try:
        out = mod.call_with_retry(fn, policy=mod.RetryPolicy(**policy_kw), seed=3,
                                  sleep=sleeps.append, clock=clock,
                                  on_retry=lambda a, e: retries.append(a))
    except Exception as e:  # the outcome is compared below, not swallowed
        out = type(e).__name__
    return out, sleeps, retries


@pytest.mark.parametrize("fails,kw,step", [
    (2, dict(max_attempts=3), 0.0),          # succeeds on the last try
    (5, dict(max_attempts=3), 0.0),          # exhausts: re-raises
    (1, dict(max_attempts=4, base_delay_s=0.5, deadline_s=0.2), 0.0),  # deadline
    (2, dict(max_attempts=4, base_delay_s=0.01, deadline_s=1.0), 0.3),
])
def test_call_with_retry_equals_jax_with_fake_sleep(fails, kw, step):
    got = _retry_trace(tretry, fails, kw, step)
    want = _retry_trace(jretry, fails, kw, step)
    assert got == want
    if "deadline_s" in kw and kw["base_delay_s"] > kw["deadline_s"]:
        assert got[0] == "DeadlineExceeded" and got[1] == []


def test_call_with_retry_does_not_retry_other_errors():
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        raise KeyError("bug")

    with pytest.raises(KeyError):
        tretry.call_with_retry(fn, policy=tretry.RetryPolicy(), sleep=lambda s: None)
    assert calls["n"] == 1


@pytest.mark.parametrize("p", [0.0, 0.05, 0.5, 1.0])
@pytest.mark.parametrize("kw", POLICIES[:3], ids=["default", "capped", "nojitter"])
def test_expected_retry_time_equals_jax(p, kw):
    assert (tretry.expected_retry_time_s(tretry.RetryPolicy(**kw), 1e-4, p)
            == jretry.expected_retry_time_s(jretry.RetryPolicy(**kw), 1e-4, p))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _numpy_state(seed: int):
    r = np.random.default_rng(seed)
    theta = r.normal(size=(6,)).astype(np.float32)
    cb = r.normal(size=(2, 4, 2)).astype(np.float32)
    la = np.float32(r.normal())
    return theta, cb, la


def _t_state(seed: int):
    theta, cb, la = _numpy_state(seed)
    p = TRPQParams(torch.from_numpy(theta), torch.from_numpy(cb), torch.tensor(la))
    return p, t_adam(t_one_cycle(1e-3, 10)).init(p)


def _j_state(seed: int):
    theta, cb, la = _numpy_state(seed)
    p = JRPQParams(jnp.asarray(theta), jnp.asarray(cb), jnp.asarray(la))
    return p, j_adam(j_one_cycle(1e-3, 10)).init(p)


def _leaves(tree):
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [np.asarray(tree.cpu() if isinstance(tree, torch.Tensor) else tree)]


def test_checkpoint_round_trip_and_like(tmp_path):
    p, o = _t_state(0)
    extra = {"dataset": "unit-test", "m": 2, "flag": True, "none": None,
             "ids": torch.arange(5, dtype=torch.int32), "u8": np.arange(3, dtype=np.uint8)}
    d = tckpt.save(str(tmp_path), 7, params=p, opt=o, extra=extra)
    assert d.endswith("step_00000007")
    out = tckpt.restore(str(tmp_path), like={"params": p, "opt": o}, device="cpu")
    assert out["step"] == 7
    assert isinstance(out["params"], TRPQParams)
    assert isinstance(out["opt"].inner[0], TRPQParams)
    for a, b in zip(_leaves(tuple(out["params"]) + tuple(out["opt"])),
                    _leaves(tuple(p) + tuple(o))):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert out["opt"].step.dtype == torch.int32
    e = out["extra"]
    assert (e["dataset"], e["m"], e["flag"], e["none"]) == ("unit-test", 2, True, None)
    assert torch.equal(e["ids"], extra["ids"]) and e["u8"].dtype == torch.uint8
    # without like=, NamedTuples come back as field dicts
    plain = tckpt.restore(str(tmp_path), device="cpu")
    assert set(plain["params"]) == {"theta", "codebooks", "log_alpha"}


def test_checkpoint_rotation_keeps_newest(tmp_path):
    for s in (1, 2, 3, 4):
        tckpt.save(str(tmp_path), s, keep=2, w={"a": torch.full((2,), float(s))})
    assert tckpt.all_steps(str(tmp_path)) == [3, 4]
    assert tckpt.latest_step(str(tmp_path)) == 4
    assert float(tckpt.restore(str(tmp_path), 3, device="cpu")["w"]["a"][0]) == 3.0


def test_checkpoint_tmp_never_visible(tmp_path):
    """A save that fails half-way leaves no step and no staging directory;
    a good save leaves only the step."""
    tckpt.save(str(tmp_path), 1, w={"a": torch.ones(3)})
    with pytest.raises(TypeError, match="cannot serialize"):
        tckpt.save(str(tmp_path), 2, w={"a": torch.ones(3)}, bad={"x": object()})
    assert sorted(os.listdir(tmp_path)) == ["step_00000001"]
    assert tckpt.latest_step(str(tmp_path)) == 1


def test_checkpoint_clear_errors(tmp_path):
    empty = tmp_path / "nothing"
    empty.mkdir()
    for d in (empty, tmp_path / "never_created"):
        with pytest.raises(FileNotFoundError, match="no checkpoints under"):
            tckpt.restore(str(d), device="cpu")
    tckpt.save(str(tmp_path / "one"), 3, w={"a": torch.ones(1)})
    with pytest.raises(FileNotFoundError, match=r"available: \[3\]"):
        tckpt.restore(str(tmp_path / "one"), step=7, device="cpu")


def test_checkpoint_crc_detects_silent_corruption(tmp_path):
    tckpt.save(str(tmp_path), 5, w={"big": torch.arange(4096, dtype=torch.float32),
                                    "small": torch.ones(2)})
    tckpt.restore(str(tmp_path), device="cpu")         # intact: verifies
    assert tfault.corrupt_snapshot(str(tmp_path), seed=1) == 5
    with pytest.raises(tckpt.ChecksumError, match="crc32"):
        tckpt.restore(str(tmp_path), device="cpu")
    # the reference's verifier agrees about the same bytes
    with pytest.raises(jckpt.ChecksumError):
        jckpt.restore(str(tmp_path))


def test_checkpoint_drop_skips_leaf(tmp_path):
    tckpt.save(str(tmp_path), 1, index={"vectors": torch.ones(4, 3), "ids": torch.arange(4)})
    out = tckpt.restore(str(tmp_path), drop={"index/vectors"}, device="cpu")
    assert out["index"]["vectors"] == tckpt.Dropped((4, 3), "float32")
    assert torch.equal(out["index"]["ids"], torch.arange(4))


def test_checkpoint_bf16_leaf_is_a_clear_type_error(tmp_path):
    """A bfloat16 leaf saves as its raw bytes under the ``ml_dtypes`` name
    and restores as bfloat16 (it raised before fault C3 was repaired); a
    leaf with neither a numpy nor a raw-byte name is still a clear
    TypeError."""
    w = torch.tensor([1.5, -2.25], dtype=torch.bfloat16)
    tckpt.save(str(tmp_path), 1, w={"a": w})
    got = tckpt.restore(str(tmp_path), device="cpu")["w"]["a"]
    assert got.dtype == torch.bfloat16 and torch.equal(got, w)
    with pytest.raises(TypeError, match="cannot save"):
        tckpt.save(str(tmp_path), 2, w={"a": torch.ones(2, dtype=torch.complex32)})


def test_checkpoint_restore_retries_injected_io_faults(tmp_path):
    tckpt.save(str(tmp_path), 2, w={"a": torch.ones(2)})
    fails = {"n": 0}

    def hook(path):
        if fails["n"] < 2:
            fails["n"] += 1
            raise tretry.TransientIOError(path)

    tckpt.set_io_fault_hook(hook)
    try:
        with pytest.raises(tretry.TransientIOError):
            tckpt.restore(str(tmp_path), device="cpu")
        fails["n"] = 0
        out = tckpt.restore(str(tmp_path), retry=tretry.RetryPolicy(base_delay_s=1e-4),
                            device="cpu")
    finally:
        tckpt.set_io_fault_hook(None)
    assert fails["n"] == 2 and torch.equal(out["w"]["a"], torch.ones(2))


def _read_dir(d):
    out = {}
    for name in sorted(os.listdir(d)):
        path = os.path.join(d, name)
        if name.endswith(".json"):
            out[name] = json.load(open(path))
        else:
            with np.load(path) as z:
                out[name] = {k: z[k].copy() for k in z.files}
    return out


def test_checkpoint_manifests_equal_across_packages(tmp_path):
    """The same values saved by either package give the same .json
    manifests and the same .npz members."""
    tp, to = _t_state(3)
    jp, jo = _j_state(3)
    extra = {"dataset": "sift", "m": 2, "k": 4}
    tckpt.save(str(tmp_path / "t"), 9, params=tp, opt=to, extra=extra)
    jckpt.save(str(tmp_path / "j"), 9, params=jp, opt=jo, extra=extra)
    got = _read_dir(tmp_path / "t" / "step_00000009")
    want = _read_dir(tmp_path / "j" / "step_00000009")
    assert got.keys() == want.keys()
    for name in got:
        if name.endswith(".json"):
            assert got[name] == want[name], name
        else:
            assert got[name].keys() == want[name].keys()
            for k in got[name]:
                np.testing.assert_array_equal(got[name][k], want[name][k])


def test_port_restores_a_jax_checkpoint(tmp_path):
    jp, jo = _j_state(4)
    jckpt.save(str(tmp_path), 11, params=jp, opt=jo, extra={"dataset": "sift"})
    tp, to = _t_state(0)                 # template: types only
    out = tckpt.restore(str(tmp_path), like={"params": tp, "opt": to}, device="cpu")
    assert isinstance(out["params"], TRPQParams) and out["step"] == 11
    for a, b in zip(_leaves(tuple(out["params"]) + tuple(out["opt"])),
                    _leaves(tuple(jp) + tuple(jo))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_jax_restores_a_port_checkpoint(tmp_path):
    tp, to = _t_state(5)
    tckpt.save(str(tmp_path), 12, params=tp, opt=to, extra={"m": 2})
    jp, jo = _j_state(0)
    out = jckpt.restore(str(tmp_path), like={"params": jp, "opt": jo})
    assert isinstance(out["params"], JRPQParams) and out["extra"] == {"m": 2}
    for a, b in zip(_leaves(tuple(out["params"]) + tuple(out["opt"])),
                    _leaves(tuple(tp) + tuple(to))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# chaos plan, supervision, quorum
# ---------------------------------------------------------------------------

SPECS = ["dead=0+2, straggler=1; straggler_ms=40,latency_ms=3,io=0.25,corrupt,"
         "crash=consolidate,seed=9", "io=0.05", "", "dead=3,slow_read=5,corrupt_record",
         "crash=refresh;seed=1"]


@pytest.mark.parametrize("spec", SPECS)
def test_chaos_plan_parse_equals_jax(spec):
    t, j = tfault.ChaosPlan.parse(spec), jfault.ChaosPlan.parse(spec)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.alive(4) == j.alive(4)
    np.testing.assert_array_equal(t.latencies(4), j.latencies(4))
    assert (t.io_fault() is None) == (j.io_fault() is None)
    assert (t.consolidate_hook() is None) == (j.consolidate_hook() is None)


@pytest.mark.parametrize("spec", ["crash=sideways", "banana=1"])
def test_chaos_plan_rejects_bad_tokens_like_jax(spec):
    for mod in (tfault, jfault):
        with pytest.raises(ValueError):
            mod.ChaosPlan.parse(spec)


def test_chaos_io_fault_hook_replays_jax_draws():
    def pattern(mod):
        hook = mod.ChaosPlan.parse("io=0.3,seed=4").io_fault()
        out = []
        for i in range(64):
            try:
                hook(f"p{i}")
                out.append(False)
            except OSError:
                out.append(True)
        return out

    got = pattern(tfault)
    assert got == pattern(jfault) and any(got) and not all(got)


@pytest.mark.parametrize("phase", ["consolidate", "refresh"])
def test_chaos_consolidate_hook_crashes_at_jax_phase(phase):
    def crashes(mod):
        hook = mod.ChaosPlan.parse(f"crash={phase}").consolidate_hook()
        out = []
        for ph in ("pre_snapshot", "post_snapshot"):
            try:
                hook(ph)
                out.append(None)
            except mod.InjectedFailure:
                out.append(ph)
        return out

    assert crashes(tfault) == crashes(jfault)


def _supervise_trace(mod, crash_times: int, max_restarts: int, **kw):
    calls, sleeps, restarts = {"n": 0}, [], []

    def run():
        calls["n"] += 1
        inj = mod.FailureInjector(fail_at_step=3 if calls["n"] <= crash_times else None)
        for step in range(6):
            inj.maybe_fail(step)
        return "done"

    try:
        out = mod.supervise(run, max_restarts=max_restarts, sleep=sleeps.append,
                            on_restart=lambda n, e: restarts.append(n), **kw)
    except mod.InjectedFailure:
        out = "raised"
    return out, sleeps, restarts, calls["n"]


@pytest.mark.parametrize("crashes,max_restarts,kw", [
    (1, 2, {}), (2, 3, {"seed": 5}), (3, 2, {}), (1, 1, {"backoff": None})])
def test_supervise_and_failure_injector_equal_jax(crashes, max_restarts, kw):
    got = _supervise_trace(tfault, crashes, max_restarts, **kw)
    assert got == _supervise_trace(jfault, crashes, max_restarts, **kw)
    assert got[0] == (("done", crashes) if crashes <= max_restarts else "raised")


def test_supervise_does_not_retry_real_bugs():
    def run():
        raise KeyError("bug")

    with pytest.raises(KeyError):
        tfault.supervise(run, max_restarts=3, sleep=lambda s: None)


LAT = [0.002, 0.050, 0.002, 0.060]


@pytest.mark.parametrize("alive,lat,deadline,quorum", [
    ([True] * 4, LAT, 0.01, None), ([True] * 4, LAT, 0.01, 3),
    ([False, True, False, True], LAT, 0.001, 3), ([True] * 4, None, None, None),
    ([False] * 4, LAT, 0.01, None), ([True, False, True, True], LAT, 0.055, 2),
    ([True] * 4, LAT, 0.001, None)])
def test_resolve_quorum_equals_jax(alive, lat, deadline, quorum):
    t = tfault.resolve_quorum(alive, lat, deadline, quorum)
    j = jfault.resolve_quorum(alive, lat, deadline, quorum)
    assert tuple(t) == tuple(j)


@pytest.mark.parametrize("dtype", ["bfloat16", "float8_e4m3fn", "float8_e5m2"])
def test_checkpoint_raw_dtype_leaves_round_trip_with_the_reference(tmp_path, dtype):
    """Fault C3, both ways: a port bf16 / float8 leaf restores in the
    reference as the ml_dtypes array of the same bytes, a reference leaf
    restores in the port as the torch dtype of the same bytes, and the two
    packages write the same files byte for byte."""
    import ml_dtypes

    vals = np.array([[1.5, -2.25, 0.125], [3.0, -0.5, 448.0]], np.float32)
    t = torch.from_numpy(vals).to(getattr(torch, dtype))
    tckpt.save(str(tmp_path / "t"), 1, params={"w": t, "n": torch.arange(3)})
    got = jckpt.restore(str(tmp_path / "t"))["params"]["w"]
    assert str(got.dtype) == dtype
    bits, np_bits = ((torch.int16, np.int16) if dtype == "bfloat16"
                     else (torch.uint8, np.uint8))
    np.testing.assert_array_equal(np.asarray(got).view(np_bits), t.view(bits).numpy())
    jckpt.save(str(tmp_path / "j"), 1, params={"w": np.asarray(got), "n": np.arange(3)})
    back = tckpt.restore(str(tmp_path / "j"), device="cpu")["params"]["w"]
    assert back.dtype == t.dtype and torch.equal(back.view(bits), t.view(bits))
    for name in ("params.json", "params.npz"):
        assert ((tmp_path / "t" / "step_00000001" / name).read_bytes()
                == (tmp_path / "j" / "step_00000001" / name).read_bytes()), name
    assert np.dtype(getattr(ml_dtypes, dtype)).name == dtype
