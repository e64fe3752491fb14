"""The port's autotuner (``tune/``: knobs, search, store, the CLI and the
auto-apply hooks) against the JAX package's (the cases of
``tests/test_tune.py`` where the port has the surface).

The registry is JAX's minus the knobs with no surface in the port
(``knobs.LEFT_OUT``), field for field. ``EnvScope`` restores as JAX's
does. ``successive_halving`` and ``run_autotune`` get the same
deterministic ``measure`` in both packages and must return the same winner
and the same trials in the same order. A ``TUNED.json`` written by JAX's
store reads back in the port's, and the same conf has the same
``model_signature`` in both packages. Each auto-apply hook (``fit``,
``warmup``, ``InferenceService.register``, ``OnlineTrainer``) applies a
matching entry and yields to explicit arguments and env; a net with no
entry trains bit for bit as with ``stage_on_device=0``.

Every test points ``DL4JTPU_TUNED_PATH`` into tmp_path and turns the
metric-history sampler off.
"""

import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import deeplearning4j_tpu as dj  # noqa: E402
from deeplearning4j_tpu.tune import knobs as jknobs  # noqa: E402
from deeplearning4j_tpu.tune import search as jsearch  # noqa: E402
from deeplearning4j_tpu.tune import store as jstore  # noqa: E402

import deeplearning4j_tpu_torch as pt  # noqa: E402
from deeplearning4j_tpu_torch.serving import InferenceService  # noqa: E402
from deeplearning4j_tpu_torch.serving.batcher import MAX_BATCH_ENV, MAX_DELAY_ENV  # noqa: E402
from deeplearning4j_tpu_torch.telemetry import (MetricsRegistry, Telemetry,  # noqa: E402
                                                get_registry)
from deeplearning4j_tpu_torch.tune import (EnvScope, TunedStore, all_knobs,  # noqa: E402
                                           get_knob, run_autotune, scoped_env,
                                           successive_halving)
from deeplearning4j_tpu_torch.tune import __main__ as tune_cli  # noqa: E402
from deeplearning4j_tpu_torch.tune import store as tuned_store  # noqa: E402
from deeplearning4j_tpu_torch.tune.knobs import LEFT_OUT, apply_config, validate_config  # noqa: E402
from deeplearning4j_tpu_torch.tune.search import MlpFitWorkload  # noqa: E402

FEATURES, CLASSES = 16, 4


def _conf(pkg, seed=11, dtype="float32"):
    return pkg.MultiLayerConfiguration(
        layers=[pkg.DenseLayer(n_out=24, activation="relu"),
                pkg.OutputLayer(n_out=CLASSES, activation="softmax", loss="mcxent")],
        input_type=pkg.InputType.feed_forward(FEATURES),
        updater=pkg.UpdaterConfig(updater="adam", learning_rate=1e-3),
        dtype=dtype, seed=seed)


def _net(seed=11, dtype="float32"):
    return pt.MultiLayerNetwork(_conf(pt, seed, dtype), device="cpu")


def _batches(n=32, seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(n, FEATURES)).astype(np.float32)
    ys = np.eye(CLASSES, dtype=np.float32)[rng.integers(0, CLASSES, size=n)]
    return xs, ys


def _applied_count(context: str) -> float:
    counter = get_registry().counter(
        "dl4jtpu_tuned_config_applied_total",
        "tuned-config knobs auto-applied at startup, by context",
        labelnames=("context",))
    return counter.labels(context=context).value


@pytest.fixture(autouse=True)
def tuned_file(tmp_path, monkeypatch):
    path = str(tmp_path / "TUNED.json")
    monkeypatch.setenv(tuned_store.TUNED_PATH_ENV, path)
    monkeypatch.setenv("DL4JTPU_HISTORY", "0")
    for name in (MAX_DELAY_ENV, MAX_BATCH_ENV, "DL4JTPU_SERVE_MAX_QUEUE",
                 "DL4JTPU_SERVE_LATENCY_BUDGET_MS", "DL4JTPU_INFER"):
        monkeypatch.delenv(name, raising=False)
    return path


# ------------------------------------------------------------ knob registry
class TestKnobRegistry:
    def test_registry_is_jaxs_minus_the_left_out_knobs(self):
        mine = {k.name: k for k in all_knobs()}
        theirs = {k.name: k for k in jknobs.all_knobs()}
        assert set(mine) == set(theirs) - set(LEFT_OUT)
        assert set(LEFT_OUT) <= set(theirs)
        for name, k in mine.items():
            j = theirs[name]
            assert (k.domain, k.default, k.kind, k.env, k.cost_hint, k.contexts) == (
                j.domain, j.default, j.kind, j.env, j.cost_hint, j.contexts), name

    def test_every_knob_is_well_formed(self):
        for k in all_knobs():
            assert k.default in k.domain, k.name
            assert k.kind in ("env", "call"), k.name
            if k.kind == "env":
                assert k.env and k.env.startswith("DL4JTPU_"), k.name
            assert k.cost_hint in (
                "compute", "memory", "latency", "host", "neutral"), k.name

    @pytest.mark.parametrize("name", ("no_such_knob",) + LEFT_OUT)
    def test_unknown_knob_is_loud(self, name):
        with pytest.raises(KeyError, match=name):
            get_knob(name)
        with pytest.raises(KeyError):
            validate_config({"stage_window": 4, name: 1})


# ---------------------------------------------------------------- env scope
class TestEnvScope:
    def test_restores_unset_and_overwritten_vars(self, monkeypatch):
        for scoped in (scoped_env, jknobs.scoped_env):
            monkeypatch.delenv("DL4JTPU_TUNE_T1", raising=False)
            monkeypatch.setenv("DL4JTPU_TUNE_T2", "orig")
            with scoped(DL4JTPU_TUNE_T1="a", DL4JTPU_TUNE_T2="b") as scope:
                assert os.environ["DL4JTPU_TUNE_T1"] == "a"
                assert os.environ["DL4JTPU_TUNE_T2"] == "b"
                scope.set("DL4JTPU_TUNE_T2", "c")  # nested write, same var
            assert "DL4JTPU_TUNE_T1" not in os.environ
            assert os.environ["DL4JTPU_TUNE_T2"] == "orig"  # first write wins

    def test_restores_on_exception(self, monkeypatch):
        monkeypatch.delenv("DL4JTPU_TUNE_T3", raising=False)
        monkeypatch.setenv("DL4JTPU_TUNE_T4", "kept")
        with pytest.raises(RuntimeError):
            with EnvScope() as scope:
                scope.set("DL4JTPU_TUNE_T3", "x")
                scope.set("DL4JTPU_TUNE_T4", "y")
                raise RuntimeError("trial crashed")
        assert "DL4JTPU_TUNE_T3" not in os.environ
        assert os.environ["DL4JTPU_TUNE_T4"] == "kept"

    def test_none_unsets_for_the_scope(self, monkeypatch):
        monkeypatch.setenv("DL4JTPU_TUNE_T5", "keepme")
        with scoped_env(DL4JTPU_TUNE_T5=None):
            assert "DL4JTPU_TUNE_T5" not in os.environ
        assert os.environ["DL4JTPU_TUNE_T5"] == "keepme"

    def test_apply_config_sets_env_knobs_and_returns_call_knobs(self, monkeypatch):
        monkeypatch.setenv(MAX_DELAY_ENV, "7.0")
        config = {"serve_max_delay_ms": 0.5, "serve_max_batch": 32,
                  "stage_window": 8, "train_batch": 256}
        with EnvScope() as scope:
            residue = apply_config(config, scope)
            with EnvScope() as jscope:
                assert residue == jknobs.apply_config(config, jscope)
            assert residue == {"stage_window": 8, "train_batch": 256}
            assert os.environ[MAX_DELAY_ENV] == "0.5"
            assert os.environ[MAX_BATCH_ENV] == "32"
        assert os.environ[MAX_DELAY_ENV] == "7.0"
        assert MAX_BATCH_ENV not in os.environ
        with EnvScope() as scope, pytest.raises(KeyError):
            apply_config({"kernel_lrn": "fused"}, scope)


# ------------------------------------------------------- search engine
def _bowl(c):
    return 100.0 - (c["stage_window"] - 8) ** 2 - abs(c["train_batch"] - 512) / 64.0


def _trials(trials):
    return [(t.config, t.measured, t.rung, t.pruned, t.predicted) for t in trials]


class TestSuccessiveHalving:
    def test_finds_known_optimum_as_jax_does(self):
        candidates = [{"stage_window": w, "train_batch": b}
                      for w in (2, 4, 8, 16) for b in (128, 512)]
        calls = {"port": [], "jax": []}

        def measure(who):
            return lambda config, fidelity: (calls[who].append((dict(config), fidelity))
                                             or _bowl(config))

        best, trials = successive_halving(
            candidates, measure("port"), rungs=3, keep=0.5, fidelities=(1, 2, 4))
        jbest, jtrials = jsearch.successive_halving(
            candidates, measure("jax"), rungs=3, keep=0.5, fidelities=(1, 2, 4))
        assert best.config == jbest.config == {"stage_window": 8, "train_batch": 512}
        assert best.measured == pytest.approx(100.0) and best.rung == 2
        assert calls["port"] == calls["jax"]  # the same trials, in the same order
        assert _trials(trials) == _trials(jtrials)
        assert sum(1 for _, f in calls["port"] if f == 1) == 8
        assert sum(1 for _, f in calls["port"] if f == 2) <= 4

    def test_prior_prunes_predicted_bad_without_measuring(self):
        candidates = [{"train_batch": 512}, {"train_batch": 32}, {"train_batch": 256}]
        runs = []
        for halving in (successive_halving, jsearch.successive_halving):
            measured = []
            best, trials = halving(
                candidates, lambda c, f: measured.append(c["train_batch"])
                or float(c["train_batch"]),
                prior=lambda c: float(c["train_batch"]), prune_factor=2.0, rungs=1)
            assert 32 not in measured
            assert {t.config["train_batch"] for t in trials if t.pruned} == {32}
            runs.append((best.config, measured, _trials(trials)))
        assert runs[0] == runs[1]

    def test_incumbent_is_measured_even_past_deadline(self):
        candidates = [{"stage_window": 4}, {"stage_window": 8}]
        measured = []
        best, _ = successive_halving(
            candidates, lambda c, f: measured.append(c["stage_window"]) or 1.0,
            rungs=2, deadline=time.monotonic() - 1.0)  # already expired
        assert measured == [4]  # incumbent only
        assert best.config == {"stage_window": 4}

    def test_rich_measure_dict_fills_trial_evidence(self):
        def measure(config, fidelity):
            return {"value": 5.0, "p99_ms": 1.25, "compiles": 0,
                    "telemetry": {"warm_compiles": 2}}

        best, _ = successive_halving([{"stage_window": 4}], measure, rungs=1)
        jbest, _ = jsearch.successive_halving([{"stage_window": 4}], measure, rungs=1)
        assert best.as_dict() == jbest.as_dict()
        assert (best.measured, best.p99_ms, best.compiles_measured) == (5.0, 1.25, 0)
        assert best.telemetry == {"warm_compiles": 2}

    def test_grid_and_budget_parse_as_jax(self):
        space = {"stage_window": (2, 4), "train_batch": (32, 512)}
        from deeplearning4j_tpu_torch.tune.search import grid, parse_budget

        assert grid(space) == jsearch.grid(space)
        for text in ("60s", "2m", "1h", 5, "7.5"):
            assert parse_budget(text) == jsearch.parse_budget(text)
        with pytest.raises(KeyError):
            grid({"kernel_lrn": ("fused",)})


class _SyntheticWorkload:
    """An in-memory workload with a known optimum; each trial writes an env
    knob through an ``EnvScope``, so the search must leave ``os.environ``
    bit-identical. ``pkg`` picks whose key, ``EnvScope`` and apply_config."""

    objective = "fit"
    metric = "synthetic_score"

    def __init__(self, key, knobs_mod):
        self._key = key
        self._knobs = knobs_mod

    def default_config(self):
        return {"stage_window": 4}

    def space(self):
        return {"stage_window": (2, 4, 8), "train_batch": (32, 512)}

    def key(self):
        return self._key

    def prior(self, config):
        return None

    def measure(self, config, fidelity):
        with self._knobs.EnvScope() as scope:
            self._knobs.apply_config({"serve_max_batch": 16}, scope)
            assert os.environ[MAX_BATCH_ENV] == "16"
            return 10.0 + config["stage_window"] - config.get("train_batch", 512) / 1e4


class TestRunAutotune:
    def test_search_persists_winner_and_keeps_env_clean(self, tuned_file):
        net = _net()
        key = tuned_store.key_for(net)
        env_before = dict(os.environ)
        result = run_autotune(workload=_SyntheticWorkload(key, pt.tune.knobs),
                              budget_s=30.0, rungs=2, fidelities=(1, 2))
        jresult = jsearch.run_autotune(workload=_SyntheticWorkload(key, jknobs),
                                       budget_s=30.0, rungs=2, fidelities=(1, 2),
                                       persist=False)
        assert dict(os.environ) == env_before
        assert result.env_ok and result.pruned == []
        assert result.best.config == jresult.best.config == {
            "stage_window": 8, "train_batch": 32}
        assert _trials(result.trials) == _trials(jresult.trials)
        assert result.store_path == tuned_file
        entry = TunedStore(tuned_file).get(key)
        assert entry["config"] == result.best.config
        assert entry["metric"] == "synthetic_score"
        assert entry["value"] == pytest.approx(result.best.measured)

    def test_unknown_workload_is_loud(self):
        with pytest.raises(ValueError, match="no workload"):
            run_autotune(model="transformer", objective="fit")

    def test_leaked_env_raises(self, monkeypatch):
        monkeypatch.delenv("DL4JTPU_TUNE_LEAK", raising=False)

        class Leaky(_SyntheticWorkload):
            def measure(self, config, fidelity):
                os.environ["DL4JTPU_TUNE_LEAK"] = "1"
                return 1.0

        with pytest.raises(RuntimeError, match="DL4JTPU_TUNE_LEAK"):
            run_autotune(workload=Leaky("k/cpu/d1", pt.tune.knobs), budget_s=5.0,
                         rungs=1, persist=False)


# ------------------------------------------------------------- tuned store
class TestTunedStore:
    def test_roundtrip_and_merge(self, tuned_file):
        store = TunedStore(tuned_file)
        key = "abc123def456/cuda/d1"
        store.put(key, {"stage_window": 8}, objective="fit",
                  metric="train_samples_per_sec", value=6000.0, trials=5)
        store.put(key, {"serve_max_batch": 128}, objective="serve")
        entry = TunedStore(tuned_file).get(key)
        assert entry["config"] == {"stage_window": 8, "serve_max_batch": 128}
        assert entry["value"] == 6000.0
        raw = json.load(open(tuned_file))
        assert raw["version"] == 1 and key in raw["configs"]
        # the JAX store reads the port's file as its own
        assert jstore.TunedStore(tuned_file).get(key) == entry

    def test_jax_written_tuned_json_reads_back(self, tuned_file):
        key = tuned_store.key_for(_net())
        jstore.TunedStore(tuned_file).put(
            key, {"stage_window": 2, "telemetry_fetch_every": 20, "kernel_lrn": "fused"},
            objective="fit", metric="train_samples_per_sec", value=123.5, trials=3)
        entry = TunedStore(tuned_file).get(key)
        assert entry["config"]["stage_window"] == 2 and entry["value"] == 123.5
        # the JAX-only knob is skipped, the rest applies
        net = _net()
        net.set_telemetry(Telemetry(registry=MetricsRegistry()))
        assert tuned_store.auto_apply(net, "fit") == {
            "stage_window": 2, "telemetry_fetch_every": 20}

    def test_malformed_file_reads_as_empty(self, tuned_file):
        with open(tuned_file, "w") as f:
            f.write("{not json")
        store = TunedStore(tuned_file)
        assert store.get("any/key/here") is None
        store.put("k/cpu/d1", {"stage_window": 2})  # and is recoverable
        assert store.get("k/cpu/d1")["config"] == {"stage_window": 2}
        assert tuned_store.auto_apply(_net(), "fit") == {}

    def test_put_rejects_unknown_knobs(self, tuned_file):
        for bogus in ("bogus_knob", "kernel_lrn", "donation"):
            with pytest.raises(KeyError):
                TunedStore(tuned_file).put("k/cpu/d1", {bogus: 1})

    def test_key_is_stable_per_architecture(self, tuned_file):
        a, b = _net(seed=1), _net(seed=1)
        assert tuned_store.key_for(a) == tuned_store.key_for(b)
        sig, backend, topo = tuned_store.key_for(a).split("/")
        assert len(sig) == 12 and backend == "cpu" and topo == "d1"
        assert tuned_store.key_for(_net(seed=2)) != tuned_store.key_for(a)

    @pytest.mark.parametrize("which", ["small", "bench_mlp"])
    def test_model_signature_equal_in_both_packages(self, which):
        if which == "small":
            mine, theirs = _conf(pt), _conf(dj)
        else:
            mine = MlpFitWorkload(device="cpu").conf("bfloat16")
            theirs = jsearch.MlpFitWorkload()._build_net("bfloat16").conf
        assert mine.to_json() == theirs.to_json()
        assert tuned_store.model_signature(mine) == jstore.model_signature(theirs)
        assert tuned_store.model_signature(pt.MultiLayerNetwork(mine, device="cpu")) == \
            jstore.model_signature(theirs)

    def test_cli_show_lists_entries(self, tuned_file, capsys):
        TunedStore(tuned_file).put("k/cpu/d1", {"stage_window": 2})
        assert tune_cli.main(["--show", "--store", tuned_file]) == 0
        lines = capsys.readouterr().out.splitlines()
        assert lines[0] == f"# {tuned_file}"
        assert json.loads(lines[1])["config"] == {"stage_window": 2}


# -------------------------------------------------------------- auto-apply
class TestAutoApply:
    def test_no_entry_is_a_noop(self, tuned_file):
        assert tuned_store.auto_apply(_net(), "fit") == {}

    def test_register_applies_tuned_batcher_knobs(self, tuned_file):
        net = _net()
        TunedStore(tuned_file).put(
            tuned_store.key_for(net),
            {"serve_max_delay_ms": 0.5, "serve_max_batch": 32,
             "serve_max_queue_depth": 64, "serve_latency_budget_ms": 250.0},
            objective="serve")
        before = _applied_count("serve")
        service = InferenceService(registry=MetricsRegistry())
        try:
            service.register("m", net)
            st = service.stats()["models"]["m"]
            assert st["batcher"]["max_delay_ms"] == pytest.approx(0.5)
            assert st["batcher"]["max_batch"] == 32
            assert st["admission"]["max_queue_depth"] == 64
            assert st["admission"]["latency_budget_ms"] == 250.0
            assert _applied_count("serve") == before + 4
        finally:
            service.stop()

    def test_explicit_ctor_arg_beats_tuned(self, tuned_file):
        net = _net()
        TunedStore(tuned_file).put(
            tuned_store.key_for(net),
            {"serve_max_delay_ms": 0.5, "serve_max_batch": 32,
             "serve_max_queue_depth": 64}, objective="serve")
        service = InferenceService(registry=MetricsRegistry(), max_delay_ms=5.0)
        try:
            service.register("m", net, max_queue_depth=3)
            st = service.stats()["models"]["m"]
            assert st["batcher"]["max_delay_ms"] == pytest.approx(5.0)  # user wins
            assert st["batcher"]["max_batch"] == 32                     # tuned fills
            assert st["admission"]["max_queue_depth"] == 3
        finally:
            service.stop()

    def test_user_env_setting_beats_tuned(self, tuned_file, monkeypatch):
        monkeypatch.setenv(MAX_DELAY_ENV, "3.0")
        monkeypatch.setenv("DL4JTPU_SERVE_MAX_QUEUE", "9")
        net = _net()
        TunedStore(tuned_file).put(
            tuned_store.key_for(net),
            {"serve_max_delay_ms": 0.5, "serve_max_queue_depth": 64}, objective="serve")
        service = InferenceService(registry=MetricsRegistry())
        try:
            service.register("m", net)
            st = service.stats()["models"]["m"]
            assert st["batcher"]["max_delay_ms"] == pytest.approx(3.0)
            assert st["admission"]["max_queue_depth"] == 9
        finally:
            service.stop()

    def test_fit_applies_stage_window_and_telemetry_cadence(self, tuned_file):
        net = _net()
        TunedStore(tuned_file).put(
            tuned_store.key_for(net),
            {"stage_window": 2, "telemetry_fetch_every": 25}, objective="fit")
        net.set_telemetry(Telemetry(registry=MetricsRegistry()))
        assert tuned_store.auto_apply(net, "fit") == {
            "stage_window": 2, "telemetry_fetch_every": 25}
        assert net.telemetry.fetch_every == 25

    def test_explicit_telemetry_cadence_is_not_retargeted(self, tuned_file):
        net = _net()
        TunedStore(tuned_file).put(
            tuned_store.key_for(net), {"telemetry_fetch_every": 25}, objective="fit")
        net.set_telemetry(Telemetry(registry=MetricsRegistry(), fetch_every=7))
        assert "telemetry_fetch_every" not in tuned_store.auto_apply(net, "fit")
        assert net.telemetry.fetch_every == 7

    def test_explicit_list_masks_knobs(self, tuned_file):
        net = _net()
        TunedStore(tuned_file).put(tuned_store.key_for(net), {"stage_window": 2})
        assert tuned_store.auto_apply(net, "fit", explicit=("stage_window",)) == {}

    def test_fit_uses_tuned_stage_window(self, tuned_file):
        """A TUNED entry makes ``fit`` stage (the staged loop's step count
        moves), an explicit ``stage_on_device=0`` does not, and without an
        entry ``fit`` trains bit for bit as with ``stage_on_device=0``."""
        xs, ys = _batches()
        it = lambda: pt.ListDataSetIterator(  # noqa: E731
            [pt.DataSet(xs[i:i + 8], ys[i:i + 8]) for i in range(0, 32, 8)])
        plain, default = _net().init(), _net().init()
        plain.fit(it(), stage_on_device=0)
        default.fit(it())
        for a, b in zip(plain._leaves(), default._leaves()):
            for k in a:
                assert torch.equal(a[k], b[k])
        net = _net().init()
        TunedStore(tuned_file).put(tuned_store.key_for(net), {"stage_window": 2})
        before = _applied_count("fit")
        net.fit(it())
        assert net.staged_steps_total == 4
        assert _applied_count("fit") == before + 1
        explicit = _net().init()
        explicit.fit(it(), stage_on_device=0)
        assert explicit.staged_steps_total == 0

    def test_warmup_applies_telemetry_cadence(self, tuned_file):
        net = _net().init()
        net.set_telemetry(Telemetry(registry=MetricsRegistry()))
        TunedStore(tuned_file).put(tuned_store.key_for(net), {"telemetry_fetch_every": 5})
        xs, ys = _batches(16)
        net.warmup(xs.reshape(2, 8, FEATURES), ys.reshape(2, 8, CLASSES))
        assert net.telemetry.fetch_every == 5

    def test_graph_fit_uses_tuned_stage_window(self, tuned_file):
        conf = (pt.ComputationGraphConfiguration.builder()
                .add_inputs("in").set_input_types(pt.InputType.feed_forward(FEATURES))
                .add_layer("d", pt.DenseLayer(n_out=8, activation="tanh"), "in")
                .add_layer("out", pt.OutputLayer(n_out=CLASSES, activation="softmax"), "d")
                .set_outputs("out").updater(pt.UpdaterConfig(updater="sgd", learning_rate=0.1))
                .seed(3).build())
        net = pt.ComputationGraph(conf, device="cpu").init()
        TunedStore(tuned_file).put(tuned_store.key_for(net), {"stage_window": 2})
        xs, ys = _batches()
        net.fit(pt.ListDataSetIterator(
            [pt.DataSet(xs[i:i + 8], ys[i:i + 8]) for i in range(0, 32, 8)]))
        assert net.staged_steps_total == 4

    def test_online_trainer_takes_tuned_stage_and_buckets(self, tuned_file):
        from deeplearning4j_tpu_torch.runtime.online import OnlineTrainer

        net = _net().init()
        TunedStore(tuned_file).put(
            tuned_store.key_for(net), {"stage_window": 8, "bucket_boundaries": [16, 32]})
        kw = dict(registry=MetricsRegistry(), watchdog=None)
        trainer = OnlineTrainer(net, source=None, **kw)
        assert trainer.stage == 8 and trainer.time_boundaries == (16, 32)
        explicit = OnlineTrainer(net, source=None, stage=2, time_boundaries=(64,), **kw)
        assert explicit.stage == 2 and explicit.time_boundaries == (64,)


# ------------------------------------------------- real workload (tiny MLP)
@pytest.mark.slow
def test_mlp_fit_workload_end_to_end(tuned_file):
    """A real (but tiny) search on the CPU: measured trials through the
    staged warmup/fit_on_device path, zero captures in timed regions, env
    bit-identical, winner persisted."""
    wl = MlpFitWorkload(hidden=32, features=FEATURES, classes=CLASSES, device="cpu")
    env_before = dict(os.environ)
    result = run_autotune(
        workload=wl, budget_s=90.0, rungs=1, fidelities=(1,),
        space={"train_batch": (16, 64), "stage_window": (2,)})
    assert dict(os.environ) == env_before
    assert result.best.measured is not None and result.best.measured > 0
    assert all(t.compiles_measured == 0 for t in result.trials if t.measured is not None)
    entry = TunedStore(tuned_file).get(wl.key())
    assert entry is not None and "train_batch" in entry["config"]
