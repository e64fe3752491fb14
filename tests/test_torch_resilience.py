"""The port's failure policies (``runtime/resilience.py``) and fault plans
(``testing/chaos.py``) against the JAX package's.

Both modules are host code that the port keeps as its own copy, so each
check drives the two packages with the same arguments and compares what
comes out exactly: backoff values to the bit (the sha256 jitter), deadline,
breaker and retry transitions under injected clocks (no sleeps), the
stats dicts, fault schedules and their firing order, the env transport,
``corrupt_file``'s offsets for a seed, and ``ChaosSource``'s outages and
NaN poisoning over the same record stream.
"""

import itertools
import os
import threading

import numpy as np
import pytest

pytest.importorskip("torch")

from deeplearning4j_tpu.runtime import resilience as jres  # noqa: E402
from deeplearning4j_tpu.streaming import QueueSource as JQueueSource  # noqa: E402
from deeplearning4j_tpu.telemetry import MetricsRegistry as JRegistry  # noqa: E402
from deeplearning4j_tpu.testing import chaos as jchaos  # noqa: E402

from deeplearning4j_tpu_torch.runtime import resilience as pres  # noqa: E402
from deeplearning4j_tpu_torch.streaming import QueueSource  # noqa: E402
from deeplearning4j_tpu_torch.telemetry import MetricsRegistry  # noqa: E402
from deeplearning4j_tpu_torch.testing import chaos as pchaos  # noqa: E402

PAIRS = [(jres, JRegistry), (pres, MetricsRegistry)]


class Clock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


@pytest.fixture(autouse=True)
def clean_sites(monkeypatch):
    for name in ("DL4JTPU_RETRY_MAX", "DL4JTPU_RETRY_BASE_S", "DL4JTPU_RETRY_CAP_S",
                 "DL4JTPU_RETRY_JITTER", "DL4JTPU_CIRCUIT_FAILURES",
                 "DL4JTPU_CIRCUIT_COOLDOWN_S"):
        monkeypatch.delenv(name, raising=False)
    yield
    jres.clear_sites()
    pres.clear_sites()


@pytest.mark.parametrize("kw", [
    {},
    {"base_s": 0.25, "cap_s": 8.0, "jitter": 0.25},
    {"base_s": 0.05, "cap_s": 1.0, "factor": 3.0},
    {"jitter": 0.0},
    {"base_s": 0.0},
], ids=["defaults", "online_source", "factor3", "no_jitter", "zero_base"])
def test_backoff_sequences_are_bit_equal(kw):
    """``backoff_s`` for attempts 0-11 under several keys, to the bit."""
    got = []
    for mod, reg in PAIRS:
        pol = mod.RetryPolicy("site.a", registry=reg(), register=False, **kw)
        got.append([pol.backoff_s(a, key=k) for k in (None, "", "w1", "worker-17")
                    for a in range(0, 12)])
    assert got[0] == got[1]
    assert len(set(got[1])) > 1 or kw.get("base_s") == 0.0


def test_env_knobs_and_defaults_match(monkeypatch):
    monkeypatch.setenv("DL4JTPU_RETRY_MAX", "7")
    monkeypatch.setenv("DL4JTPU_RETRY_BASE_S", "0.3")
    monkeypatch.setenv("DL4JTPU_RETRY_CAP_S", "bad")  # falls back to the default
    monkeypatch.setenv("DL4JTPU_CIRCUIT_FAILURES", "3")
    monkeypatch.setenv("DL4JTPU_CIRCUIT_COOLDOWN_S", "2.5")
    out = []
    for mod, reg in PAIRS:
        r = mod.RetryPolicy("env", registry=reg(), register=False).stats()
        c = mod.CircuitBreaker("env.c", registry=reg(), register=False).stats()
        out.append((r, c, mod._env_float("DL4JTPU_RETRY_BASE_S", 1.0),
                    mod._env_int("DL4JTPU_RETRY_CAP_S", 4), mod._env_int("NOPE_X", None)))
    assert out[0] == out[1]
    assert out[1][0]["max_attempts"] == 7 and out[1][0]["cap_s"] == 30.0


def _run_flaky(mod, reg, fails, max_attempts, key="k"):
    stop = threading.Event()
    pol = mod.RetryPolicy("flaky", max_attempts=max_attempts, base_s=1e-4, cap_s=1e-3,
                          registry=reg, register=False)
    calls = itertools.count()

    def fn():
        n = next(calls)
        if n < fails:
            raise OSError(f"fail {n}")
        return n

    try:
        res = pol.run(fn, stop=stop, key=key)
    except mod.RetryError as e:
        res = ("gave up", e.attempts, repr(e.last))
    return res, pol.stats()


@pytest.mark.parametrize("fails,max_attempts", [(0, 3), (2, 3), (3, 3), (5, None)])
def test_retry_run_outcomes_and_stats_match(fails, max_attempts):
    (jr, js), (pr, ps) = (_run_flaky(mod, reg(), fails, max_attempts) for mod, reg in PAIRS)
    assert jr == pr
    assert js == ps


def test_retry_only_retries_its_exceptions():
    for mod, reg in PAIRS:
        pol = mod.RetryPolicy("typed", retry_on=(OSError,), registry=reg(), register=False)

        def boom():
            raise ValueError("not retryable")

        with pytest.raises(ValueError):
            pol.run(boom)
        assert pol.stats()["attempts_total"] == 0


def test_deadline_and_policy_transitions_with_an_injected_clock():
    trails = []
    for mod, _ in PAIRS:
        clock = Clock()
        policy = mod.DeadlinePolicy("dl", 2.0, register=False)
        d = mod.Deadline(2.0, clock=clock, policy=policy)
        trail = [d.remaining(), d.expired]
        clock.t += 1.5
        trail += [d.remaining(), d.expired, d.wait_event(_set_event())]
        clock.t += 1.0
        trail += [d.remaining(), d.expired, d.pace(0.5)]
        d.note_expired()  # counted once per deadline
        trail += [policy.stats()]
        trails.append(trail)
    assert trails[0] == trails[1]
    assert trails[1][-1]["expired_total"] == 1


def _set_event():
    ev = threading.Event()
    ev.set()
    return ev


def test_circuit_breaker_transitions_with_an_injected_clock():
    trails = []
    for mod, reg in PAIRS:
        clock = Clock()
        br = mod.CircuitBreaker("cb", failure_threshold=3, cooldown_s=5.0, registry=reg(),
                                register=False, clock=clock)
        trail = []
        for step in ("f", "f", "a", "f", "a", "t2", "a", "t4", "a", "f", "a", "t5", "a",
                     "s", "a", "f"):
            if step == "f":
                br.record_failure()
            elif step == "s":
                br.record_success()
            elif step == "a":
                trail.append(br.allow())
            else:
                clock.t += float(step[1:])
            trail.append((br.state, br.failures, br.cooldown_remaining()))
        trail.append(br.stats())
        trails.append(trail)
    assert trails[0] == trails[1]
    assert "half-open" in {t[0] for t in trails[1] if isinstance(t, tuple)}


def test_breaker_metric_names_match():
    names = []
    for mod, reg in PAIRS:
        r = reg()
        mod.CircuitBreaker("m", registry=r, register=False).record_failure()
        mod.RetryPolicy("m", registry=r, register=False).record_failure()
        names.append(sorted(r.snapshot()))
    assert names[0] == names[1]
    assert "dl4jtpu_circuit_state" in names[1]


def test_site_registry_and_stats_match():
    out = []
    for mod, reg in PAIRS:
        r = reg()
        mod.RetryPolicy("z.retry", registry=r)
        mod.CircuitBreaker("a.circuit", registry=r)
        mod.DeadlinePolicy("m.deadline", 1.5)
        assert mod.get_site("z.retry").name == "z.retry"
        out.append(mod.resilience_stats())
        mod.clear_sites()
        assert mod.get_site("z.retry") is None and mod.resilience_stats() == {"sites": {}}
    assert out[0] == out[1]
    assert list(out[1]["sites"]) == ["a.circuit", "m.deadline", "z.retry"]


# ------------------------------------------------------------------ chaos
SPECS = [
    {"site": "source.poll", "fault": "source-error", "at": [2, 9], "params": {"polls": 2}},
    {"site": "source.poll", "fault": "source-slow", "every": 7, "params": {"seconds": 0.0}},
    {"site": "source.record", "fault": "nan-burst", "at": [3], "params": {"records": 2}},
    {"site": "checkpoint.write", "fault": "corrupt-checkpoint", "every": 2},
    {"site": "worker.healthz", "fault": "hang-worker", "at": [1]},
]


def test_fault_plan_schedule_firing_order_and_env_transport():
    out = []
    for mod in (jchaos, pchaos):
        plan = mod.FaultPlan(42, SPECS)
        fired = [plan.fire(site) for site in ["source.poll"] * 15 + ["source.record"] * 5
                 + ["worker.healthz"] * 2 + ["nothing"]]
        env = plan.to_env()
        back = mod.FaultPlan.from_env({mod.CHAOS_PLAN_ENV: env})
        out.append((plan.schedule(), fired, plan.summary(), env, back.schedule(),
                    mod.FaultPlan.from_env({}), mod.FaultPlan.from_env(
                        {mod.CHAOS_PLAN_ENV: "{not json"})))
    assert out[0] == out[1]
    assert pchaos.CHAOS_PLAN_ENV == jchaos.CHAOS_PLAN_ENV == "DL4JTPU_CHAOS_PLAN"


@pytest.mark.parametrize("bad", [{"site": "x", "fault": "meteor", "at": [1]},
                                 {"site": "x", "fault": "torn-tmp"}])
def test_fault_plan_refuses_bad_specs_alike(bad):
    msgs = []
    for mod in (jchaos, pchaos):
        with pytest.raises(ValueError) as e:
            mod.FaultPlan(0, [bad])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_marker_makes_a_fault_at_most_once_across_plans(tmp_path):
    fired = []
    for mod in (jchaos, pchaos):
        marker = tmp_path / f"{mod.__name__}.marker"
        spec = [{"site": "s", "fault": "kill-worker", "every": 1, "marker": str(marker)}]
        a, b = mod.FaultPlan(1, spec), mod.FaultPlan(1, spec)
        fired.append([a.fire("s") is not None, b.fire("s") is not None, a.fire("s") is not None])
    assert fired[0] == fired[1] == [True, False, False]


def _blob(path, n=4096, seed=5):
    path.write_bytes(np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes())
    return path


@pytest.mark.parametrize("seed,n_bytes", [(0, 64), (7, 1), (123, 300), (2**31 - 1, 4096)])
def test_corrupt_file_offsets_and_bytes_match(tmp_path, seed, n_bytes):
    a, b = _blob(tmp_path / "a.bin"), _blob(tmp_path / "b.bin")
    oa = jchaos.corrupt_file(str(a), seed, n_bytes=n_bytes)
    ob = pchaos.corrupt_file(str(b), seed, n_bytes=n_bytes)
    assert oa == ob and len(ob) >= 1
    assert a.read_bytes() == b.read_bytes()
    empty = tmp_path / "empty.bin"
    empty.write_bytes(b"")
    assert pchaos.corrupt_file(str(empty), seed) == jchaos.corrupt_file(str(empty), seed) == []


def test_truncate_and_plan_file_faults_match(tmp_path):
    for mod in (jchaos, pchaos):
        d = tmp_path / mod.__name__
        d.mkdir()
        f = _blob(d / "model-v00000003.zip")
        plan = mod.FaultPlan(9, [{"site": "checkpoint.write", "fault": "corrupt-checkpoint",
                                  "at": [1], "params": {"bytes": 16}},
                                 {"site": "checkpoint.write", "fault": "torn-tmp", "at": [2]}])
        plan.fire("checkpoint.write", path=str(f), directory=str(d), version=3)
        plan.fire("checkpoint.write", path=str(f), directory=str(d), version=3)
        assert mod.truncate_file(str(_blob(d / "t.bin")), 0.25) == 1024
    ja, pa = tmp_path / jchaos.__name__, tmp_path / pchaos.__name__
    assert sorted(os.listdir(ja)) == sorted(os.listdir(pa))
    for name in os.listdir(pa):
        assert (ja / name).read_bytes() == (pa / name).read_bytes(), name


def test_chaos_source_outages_and_poison_match():
    """The same records through each package's QueueSource and ChaosSource
    under one plan: the same ConnectionErrors, Nones and poisoned records,
    in the same order."""
    rng = np.random.default_rng(3)
    recs = [(rng.normal(size=4).astype(np.float32), np.eye(3, dtype=np.float32)[i % 3])
            for i in range(10)]
    trails = []
    for mod, qcls in ((jchaos, JQueueSource), (pchaos, QueueSource)):
        q = qcls()
        for f, l in recs:
            q.put(f, l)
        src = mod.ChaosSource(q, mod.FaultPlan(11, SPECS[:3]))
        trail = []
        for _ in range(16):
            try:
                rec = src.poll(timeout=0.0)
            except ConnectionError as e:
                trail.append(("down", str(e)))
                continue
            trail.append(None if rec is None else
                         (np.isnan(rec[0]).all(), rec[0][~np.isnan(rec[0])].tolist(),
                          rec[1].tolist()))
        trails.append((trail, src.outages, src.nan_records))
    assert trails[0] == trails[1]
    assert trails[1][1] == 2 and trails[1][2] == 2
