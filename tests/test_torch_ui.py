"""The port's training UI (``ui/``: storage, StatsListener,
ConvolutionalIterationListener, post_tsne, i18n, UIServer with every page
and ``/api/*`` endpoint, the serving endpoints) against the JAX package's:
the cases of ``tests/test_ui.py``, ``tests/test_ui_i18n.py`` and
``tests/test_serving.py::TestServingHTTP``.

Files and databases written by one package's storage are read back by the
other's. StatsListener records are held against JAX's listener: bins and
counts exactly (and every mean magnitude exactly) when both read the same
arrays, mean magnitudes at ``MM_RTOL`` after the same training from the
same params (``load_jax_params``; f32 on both sides, JAX with x64 off).
Endpoints answer with JAX's keys (``/api/fleet`` with JAX's answer);
``/api/ircost`` answers 501. Served outputs are held at ``ATOL`` against
JAX's unbucketed ``output`` of the same params. HTTP runs on 127.0.0.1, port 0.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deeplearning4j_tpu as dj  # noqa: E402
from deeplearning4j_tpu import serving as jserving  # noqa: E402
from deeplearning4j_tpu import ui as jui  # noqa: E402
from deeplearning4j_tpu.runtime import inference as jax_inference  # noqa: E402
from deeplearning4j_tpu.ui import i18n as ji18n  # noqa: E402
from deeplearning4j_tpu.ui import stats_listener as jstats  # noqa: E402

import deeplearning4j_tpu_torch as pt  # noqa: E402
from deeplearning4j_tpu_torch import serving  # noqa: E402
from deeplearning4j_tpu_torch import ui  # noqa: E402
from deeplearning4j_tpu_torch.runtime import inference as inf  # noqa: E402
from deeplearning4j_tpu_torch.ui import i18n as pi18n  # noqa: E402
from deeplearning4j_tpu_torch.ui import server as pserver  # noqa: E402
from deeplearning4j_tpu_torch.ui import stats_listener as pstats  # noqa: E402

ATOL = 1e-5
MM_RTOL = 1e-6
PAGES = ("overview", "model", "system", "flow", "activations", "tsne")
LANGS = ("en", "ja", "ko", "de", "ru", "zh")


@pytest.fixture(autouse=True)
def env(monkeypatch, tmp_path):
    monkeypatch.setattr(jax_inference, "fast_path_enabled", lambda: False)
    monkeypatch.delenv(inf.INFER_ENV, raising=False)
    monkeypatch.setenv("DL4JTPU_HISTORY", "0")
    monkeypatch.setenv("DL4JTPU_TUNED_PATH", str(tmp_path / "TUNED.json"))


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), tree)


def _get(base, path):
    return urllib.request.urlopen(base + path, timeout=30).read()


def _json(base, path):
    return json.loads(_get(base, path))


def _status(base, path, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    try:
        with urllib.request.urlopen(urllib.request.Request(base + path, data), timeout=30) as r:
            return r.status, json.loads(r.read() or b"null")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


def _post(base, path, payload):
    req = urllib.request.Request(base + path, json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
    return json.loads(urllib.request.urlopen(req, timeout=30).read())


@pytest.fixture
def servers():
    """(port base URL, JAX base URL), each server with an in-memory storage."""
    mine, theirs = ui.UIServer(port=0), jui.UIServer(port=0)
    stores = ui.InMemoryStatsStorage(), jui.InMemoryStatsStorage()
    mine.attach(stores[0])
    theirs.attach(stores[1])
    try:
        yield (f"http://127.0.0.1:{mine.port}", f"http://127.0.0.1:{theirs.port}", stores)
    finally:
        mine.stop()
        theirs.stop()


def _mlp_conf(pkg, updater="sgd", lr=0.1):
    u = pkg.UpdaterConfig(updater=updater, learning_rate=lr)
    return pkg.MultiLayerConfiguration(
        layers=[pkg.DenseLayer(n_out=8, activation="tanh"),
                pkg.OutputLayer(n_out=3, activation="softmax")],
        input_type=pkg.InputType.feed_forward(4),
        updater=u if pkg is dj else u.to_dict(), seed=1)


def _pair(conf_fn, **kw):
    jnet = dj.MultiLayerNetwork(conf_fn(dj, **kw)).init()
    jnet.init(params=_f32(jnet.params), force=True)
    pnet = pt.MultiLayerNetwork(pt.MultiLayerConfiguration.from_json(jnet.conf.to_json()),
                                device="cpu")
    return jnet, pt.load_jax_params(pnet, jax.tree_util.tree_map(np.asarray, jnet.params))


def _toy(n=32, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 4)).astype(np.float32),
            np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)])


# ---------------------------------------------------------------- storage
def _storage(mod, kind, path):
    if kind == "memory":
        return mod.InMemoryStatsStorage()
    if kind == "file":
        return mod.FileStatsStorage(str(path / "stats.jsonl"))
    return mod.SqliteStatsStorage(str(path / "stats.db"))


def _fill(st):
    st.put_static_info({"session_id": "s1", "worker_id": "0", "timestamp": 1.0,
                        "model_class": "X", "nested": {"a": [1, 2.5]}})
    for i in range(5):
        st.put_update({"session_id": "s1", "worker_id": "0", "timestamp": float(i + 2),
                       "iteration": i, "score": 1.0 / (i + 1)})
    st.put_update({"session_id": "s2", "worker_id": "1", "timestamp": 99.0,
                   "iteration": 0, "score": 0.5})


def _read(st):
    return (st.list_session_ids(), st.list_worker_ids("s1"), st.list_update_worker_ids("s1"),
            st.get_all_updates("s1"), st.get_latest_update("s1"),
            st.get_updates_after("s1", 4.0), st.get_static_info("s1"),
            st.get_all_updates("s2", "1"))


@pytest.mark.parametrize("kind", ["memory", "file", "sqlite"])
def test_storage_round_trip_and_notification(kind, tmp_path):
    st = _storage(ui, kind, tmp_path)
    events = []
    st.register_listener(events.append)
    _fill(st)
    sessions, workers, _, ups, latest, after, static, _ = _read(st)
    assert sessions == ["s1", "s2"] and workers == ["0"]
    assert [u["iteration"] for u in ups] == list(range(5)) and latest["iteration"] == 4
    assert len(after) == 2 and static[0]["model_class"] == "X"
    assert [e["type"] for e in events] == ["static"] + ["update"] * 6
    st.close()


@pytest.mark.parametrize("kind", ["file", "sqlite"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_storage_written_by_one_package_reads_back_in_the_other(kind, writer, tmp_path):
    mods = {"port": ui, "jax": jui}
    st = _storage(mods[writer], kind, tmp_path)
    _fill(st)
    want = _read(st)
    st.close()
    reader = _storage(mods["jax" if writer == "port" else "port"], kind, tmp_path)
    assert _read(reader) == want
    reader.close()


def test_remote_router_posts_to_the_first_storage(servers):
    base, _, (st, _) = servers
    router = ui.RemoteStatsStorageRouter(base)
    router.put_update({"session_id": "remote", "worker_id": "3", "timestamp": 5.0,
                       "iteration": 0, "score": 0.1})
    router.put_static_info({"session_id": "remote", "worker_id": "3", "timestamp": 4.0})
    assert st.list_session_ids() == ["remote"] and st.get_static_info("remote")
    assert _status(base, "/remote/nowhere", {})[0] == 404


# ----------------------------------------------------------- StatsListener
def test_histogram_and_mean_magnitude_are_jaxs():
    rng = np.random.default_rng(3)
    for a in (rng.normal(size=(7, 5)).astype(np.float32), np.zeros(0, np.float32),
              np.array([1.0, np.inf, -2.0, np.nan], np.float32),
              rng.normal(size=1000).astype(np.float32) * 1e-3):
        assert pstats._histogram(a) == jstats._histogram(a)
        assert pstats._histogram(a, 7) == jstats._histogram(a, 7)
        if np.isfinite(a).all():
            assert pstats._mean_magnitude(a) == jstats._mean_magnitude(a)


def test_records_equal_jaxs_on_the_same_arrays():
    """Both listeners read the same params, gradients and updates: every
    bin, count and mean magnitude exactly, the static report's keys and
    values but the clock's and the process's."""
    jnet, pnet = _pair(_mlp_conf)
    rng = np.random.default_rng(4)
    trees = {}
    for kind in ("grads", "updates"):
        host = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in p.items()}
                for p in jnet.params]
        trees[kind] = host
    jnet._last_grads = tuple({k: jnp.asarray(v) for k, v in p.items()} for p in trees["grads"])
    jnet._last_updates = tuple({k: jnp.asarray(v) for k, v in p.items()}
                               for p in trees["updates"])
    pnet._last_grads = [{k: torch.from_numpy(v) for k, v in p.items()} for p in trees["grads"]]
    pnet._last_updates = [{k: torch.from_numpy(v) for k, v in p.items()}
                          for p in trees["updates"]]
    stores = ui.InMemoryStatsStorage(), jui.InMemoryStatsStorage()
    ui.StatsListener(stores[0], session_id="s").iteration_done(pnet, 1, torch.tensor(0.5))
    jui.StatsListener(stores[1], session_id="s").iteration_done(jnet, 1, jnp.asarray(0.5))
    (mine,), (theirs,) = (st.get_all_updates("s") for st in stores)
    assert set(mine) == set(theirs)
    for key in mine:
        if key.endswith(("_histograms", "_mean_magnitudes")) or key in ("iteration", "score"):
            assert mine[key] == theirs[key], key
    (smine,), (stheirs,) = (st.get_static_info("s") for st in stores)
    assert set(smine) == set(stheirs)
    for key in ("model_class", "layers", "graph", "param_counts", "num_params", "backend"):
        assert smine[key] == stheirs[key], key
    assert json.loads(json.dumps(mine)) == mine  # JSON-ready as it is stored


def test_records_after_training_match_jax():
    """Five SGD updates from the same params in each package, a report
    each: the same keys, iterations and histogram sizes, the scores at
    1e-5 and every mean magnitude at MM_RTOL."""
    x, y = _toy()
    with jax.enable_x64(False):
        jnet, pnet = _pair(_mlp_conf)
        stores = ui.InMemoryStatsStorage(), jui.InMemoryStatsStorage()
        pnet.add_listener(ui.StatsListener(stores[0], session_id="t"))
        jnet.add_listener(jui.StatsListener(stores[1], session_id="t"))
        pnet.fit(pt.DataSet(x, y), epochs=5)
        jnet.fit(dj.DataSet(x, y), epochs=5)
    mine, theirs = (st.get_all_updates("t") for st in stores)
    assert [r["iteration"] for r in mine] == [r["iteration"] for r in theirs] == [1, 2, 3, 4, 5]
    for a, b in zip(mine, theirs):
        assert set(a) == set(b)
        assert a["score"] == pytest.approx(b["score"], rel=ATOL)
        for kind in ("param", "gradient", "update"):
            ma, mb = a[f"{kind}_mean_magnitudes"], b[f"{kind}_mean_magnitudes"]
            assert set(ma) == set(mb) == {"0_W", "0_b", "1_W", "1_b"}
            for k in ma:
                assert ma[k] == pytest.approx(mb[k], rel=MM_RTOL), (kind, k)
            for k, h in a[f"{kind}_histograms"].items():
                assert len(h["bins"]) == 21 and sum(h["counts"]) == \
                    sum(b[f"{kind}_histograms"][k]["counts"])
    # SGD: update = -lr * grad
    u = mine[-1]
    assert u["update_mean_magnitudes"]["0_W"] == pytest.approx(
        0.1 * u["gradient_mean_magnitudes"]["0_W"], rel=1e-4)


def test_listener_frequency_and_gradient_opt_out():
    x, y = _toy()
    st = ui.InMemoryStatsStorage()
    net = pt.MultiLayerNetwork(_mlp_conf(pt), device="cpu").init()
    seen = []
    net.add_listener(ui.StatsListener(st, session_id="f", frequency=2))

    class Peek:
        def iteration_done(self, model, iteration, score):
            seen.append(model._last_grads is not None)

    net.add_listener(Peek())
    net.fit(pt.DataSet(x, y), epochs=4)
    assert [r["iteration"] for r in st.get_all_updates("f")] == [2, 4]
    assert seen == [False, True, False, True]  # kept only on the listener's iterations
    st2 = ui.InMemoryStatsStorage()
    net2 = pt.MultiLayerNetwork(_mlp_conf(pt), device="cpu").init()
    lst = ui.StatsListener(st2, session_id="g", collect_gradients=False)
    assert lst.needs_gradients is False
    net2.add_listener(lst)
    net2.add_listener(Peek())
    seen.clear()
    net2.fit(pt.DataSet(x, y), epochs=2)
    u = st2.get_all_updates("g")[-1]
    assert "gradient_mean_magnitudes" not in u and "param_histograms" in u
    assert seen == [False, False]


def test_graph_records_name_vertices_as_jax():
    def conf(pkg):
        b = (pkg.GraphBuilder().add_inputs("in")
             .set_input_types(pkg.InputType.feed_forward(4))
             .add_layer("hidden", pkg.DenseLayer(n_out=5, activation="tanh"), "in")
             .add_layer("out", pkg.OutputLayer(n_out=3, activation="softmax"), "hidden")
             .set_outputs("out"))
        return b.build()

    jnet = dj.ComputationGraph(conf(dj)).init()
    pnet = pt.ComputationGraph(conf(pt), device="cpu")
    pt.load_jax_params(pnet, jax.tree_util.tree_map(np.asarray, _f32(jnet.params)))
    stores = ui.InMemoryStatsStorage(), jui.InMemoryStatsStorage()
    ui.StatsListener(stores[0], session_id="g", collect_gradients=False).iteration_done(
        pnet, 1, torch.tensor(1.0))
    jui.StatsListener(stores[1], session_id="g", collect_gradients=False).iteration_done(
        jnet, 1, jnp.asarray(1.0))
    (a,), (b,) = (st.get_all_updates("g") for st in stores)
    assert set(a["param_mean_magnitudes"]) == set(b["param_mean_magnitudes"]) == {
        "hidden_W", "hidden_b", "out_W", "out_b"}
    for k, v in a["param_mean_magnitudes"].items():
        assert v == pytest.approx(b["param_mean_magnitudes"][k], rel=MM_RTOL)
    (sa,), (sb,) = (st.get_static_info("g") for st in stores)
    assert sa["graph"] == sb["graph"] and sa["param_counts"] == sb["param_counts"]


def test_host_arrays_keeps_shapes_and_values():
    ts = [torch.arange(6.0).reshape(2, 3), torch.ones(4, dtype=torch.bfloat16),
          torch.zeros(0), torch.tensor(2.5)]
    got = pstats.host_arrays(ts)
    assert [g.shape for g in got] == [(2, 3), (4,), (0,), ()]
    assert got[1].dtype == np.float32 and float(got[3]) == 2.5
    np.testing.assert_array_equal(got[0], np.arange(6.0).reshape(2, 3))


# ------------------------------------------------- conv listener and t-SNE
def _conv_conf(pkg):
    u = pkg.UpdaterConfig(updater="adam", learning_rate=1e-3)
    return pkg.MultiLayerConfiguration(
        layers=[pkg.ConvolutionLayer(n_out=6, kernel=(3, 3), activation="relu"),
                pkg.SubsamplingLayer(pooling_type="max", kernel=(2, 2), stride=(2, 2)),
                pkg.DenseLayer(n_out=16, activation="relu"),
                pkg.OutputLayer(n_out=3, activation="softmax")],
        input_type=pkg.InputType.convolutional(10, 10, 1),
        updater=u if pkg is dj else u.to_dict(), seed=2)


def test_conv_listener_records_jaxs_feature_maps(servers):
    base, _, (st, _) = servers
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 10, 10, 1)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
    with jax.enable_x64(False):
        jnet, pnet = _pair(_conv_conf)
        jst = jui.InMemoryStatsStorage()
        pnet.add_listener(ui.ConvolutionalIterationListener(
            st, frequency=2, session_id="conv", max_maps=4, max_px=8))
        jnet.add_listener(jui.ConvolutionalIterationListener(
            jst, frequency=2, session_id="conv", max_maps=4, max_px=8))
        pnet.fit(pt.DataSet(x, y), epochs=4)
        jnet.fit(dj.DataSet(x, y), epochs=4)
    mine, theirs = st.get_all_updates("conv"), jst.get_all_updates("conv")
    assert [u["iteration"] for u in mine] == [u["iteration"] for u in theirs] == [2, 4]
    for a, b in zip(mine, theirs):
        ca, cb = a["conv_activations"], b["conv_activations"]
        assert ca["layer"] == cb["layer"] == 0 and len(ca["maps"]) == 4
        np.testing.assert_allclose(ca["maps"], cb["maps"], atol=2e-3)  # rounded to 3 places
    rec = _json(base, "/api/activations?session=conv")
    assert rec["conv_activations"]["maps"] == mine[-1]["conv_activations"]["maps"]
    assert "feature maps" in _get(base, "/train/activations").decode()


def test_tsne_page_round_trip(servers):
    base, jbase, (st, jst) = servers
    coords = np.random.default_rng(0).normal(size=(50, 3))
    labels = [str(i % 5) for i in range(50)]
    ui.post_tsne(st, "ts", coords, labels)
    jui.post_tsne(jst, "ts", coords, labels)
    got = _json(base, "/api/tsne?session=ts")
    assert got == _json(jbase, "/api/tsne?session=ts")
    assert len(got["coords"]) == 50 and got["labels"][:5] == ["0", "1", "2", "3", "4"]
    assert "t-SNE embedding" in _get(base, "/train/tsne").decode()
    assert _json(base, "/api/workers?session=ts") == []  # static-only pseudo-worker
    with pytest.raises(ValueError):
        ui.post_tsne(st, "s", np.zeros((5,)))


# ------------------------------------------------------------- endpoints
def test_dashboard_pages_and_training_endpoints_match_jax(servers):
    """The same five SGD updates recorded in each package's storage; each
    server's training endpoints answer with the same keys and rows."""
    base, jbase, (st, jst) = servers
    x, y = _toy()
    with jax.enable_x64(False):
        jnet, pnet = _pair(_mlp_conf)
        pnet.add_listener(ui.StatsListener(st, session_id="d"))
        jnet.add_listener(jui.StatsListener(jst, session_id="d"))
        pnet.fit(pt.DataSet(x, y), epochs=5)
        jnet.fit(dj.DataSet(x, y), epochs=5)
    for page, marker in [("overview", "Score vs iteration"), ("model", "Latest histogram"),
                         ("system", "Device memory"), ("flow", "Network graph"),
                         ("activations", "feature maps"), ("tsne", "t-SNE embedding"),
                         ("history", "Metric history")]:
        html = _get(base, f"/train/{page}").decode()
        assert marker in html and "@@" not in html, page
    assert "Training overview" in _get(base, "/train").decode()
    assert _json(base, "/api/sessions") == _json(jbase, "/api/sessions") == ["d"]
    assert _json(base, "/api/workers?session=d") == ["0"]
    for path in ("/api/updates?session=d", "/api/system?session=d",
                 "/api/histograms?session=d", "/api/histograms?session=d&iteration=3",
                 "/api/meanmag?session=d", "/api/static?session=d",
                 "/api/activations?session=d", "/api/tsne?session=d"):
        a, b = _json(base, path), _json(jbase, path)
        assert type(a) is type(b), path
        if isinstance(a, list):
            assert len(a) == len(b) and all(set(r) == set(s) for r, s in zip(a, b)), path
        else:
            assert set(a) == set(b), path
    ups = _json(base, "/api/updates?session=d")
    assert [u["iteration"] for u in ups] == [1, 2, 3, 4, 5]
    assert "param_histograms" not in ups[0] and "param_mean_magnitudes" not in ups[0]
    mm = _json(base, "/api/meanmag?session=d")
    assert mm["iterations"] == [1, 2, 3, 4, 5] and len(mm["gradient"]["1_b"]) == 5
    recs = st.get_all_updates("d")
    assert mm["param"]["0_W"] == [r["param_mean_magnitudes"]["0_W"] for r in recs]
    h = _json(base, "/api/histograms?session=d")
    assert h["iteration"] == 5 and h["update_histograms"] == recs[-1]["update_histograms"]
    assert _json(base, "/api/histograms?session=d&iteration=3")["iteration"] == 3
    sysrows = _json(base, "/api/system?session=d")
    assert sysrows[-1]["memory_rss_bytes"] > 0 and "param_mean_magnitudes" not in sysrows[-1]
    assert _json(base, "/api/static?session=d")[0]["graph"]["nodes"]
    assert _status(base, "/api/nothing")[0] == 404


def test_worker_filter(servers):
    base, _, (st, _) = servers
    for w, score in (("0", 0.5), ("1", 0.9)):
        st.put_update({"session_id": "mw", "worker_id": w, "timestamp": float(w) + 1,
                       "iteration": 1, "score": score, "param_mean_magnitudes": {"0_W": score}})
    assert _json(base, "/api/workers?session=mw") == ["0", "1"]
    assert _json(base, "/api/meanmag?session=mw&worker=1")["param"]["0_W"] == [0.9]
    assert [u["score"] for u in _json(base, "/api/updates?session=mw&worker=0")] == [0.5]
    assert 'id="worker"' in _get(base, "/train/model").decode()


def test_observability_endpoints_answer_with_jaxs_keys(servers):
    base, jbase, _ = servers
    for path in ("/api/telemetry", "/api/memory", "/api/flightrecorder?last=4",
                 "/api/serving", "/api/online", "/api/resilience", "/api/slo",
                 "/api/history?range_s=60", "/api/i18n"):
        a, b = _json(base, path), _json(jbase, path)
        assert set(a) == set(b), path
    assert set(_json(base, "/api/telemetry")["system"]) <= set(
        _json(jbase, "/api/telemetry")["system"]) | {"device_memory"}
    text = _get(base, "/metrics").decode()
    assert text == "" or "# TYPE" in text
    assert _status(base, "/api/history?range_s=-1")[0] == \
        _status(jbase, "/api/history?range_s=-1")[0]


def test_fleet_view_answers_as_jaxs(servers):
    """``/api/fleet``, ported with ``fleet/``, answers as JAX's server does
    (no router in either process)."""
    base, jbase, _ = servers
    assert _status(base, "/api/fleet") == _status(jbase, "/api/fleet") == (200, {"routers": []})


@pytest.mark.parametrize("path", ["/api/ircost"])
def test_unported_views_answer_501_with_a_reason(servers, path):
    base, _, _ = servers
    code, body = _status(base, path)
    assert code == 501 and "not implemented in the port" in body["error"]


def test_pages_render_in_every_language_and_setlang(servers):
    base, _, _ = servers
    try:
        for page in PAGES:
            for lang in LANGS:
                html = _get(base, f"/train/{page}?lang={lang}").decode()
                assert "@@" not in html, (page, lang)
        assert "スコア対反復" in _get(base, "/train/overview?lang=ja").decode()
        assert "スコア対反復" in _get(base, "/setlang/ja").decode()
        api = _json(base, "/api/i18n")
        assert api["default_language"] == "ja" and api["messages"]["train.nav.overview"] == "概要"
        assert _status(base, "/setlang/xx")[0] == 404
    finally:
        pi18n.get_instance().set_default_language("en")


def test_i18n_catalogs_are_jaxs(tmp_path):
    mine, theirs = pi18n.I18N(), ji18n.I18N()
    assert list(mine.languages()) == list(theirs.languages())
    for lang in mine.languages():
        assert mine.catalog(lang) == theirs.catalog(lang)
    assert mine.get_message("train.overview.chart.itertime", "ko") == "Iteration time (ms)"
    assert mine.get_message("no.such.key", "ja") == "no.such.key"
    assert mine.render("a @@oops") == "a @@oops"
    p = tmp_path / "train.custom.fr"
    p.write_text("# c\ntrain.nav.overview=Aperçu\n", encoding="utf-8")
    assert mine.load_properties(str(p), "fr") == theirs.load_properties(str(p), "fr") == 1
    assert pi18n.get_instance() is pi18n.get_instance()


def test_cli_main_serves_a_sqlite_storage_jax_wrote(tmp_path):
    db = str(tmp_path / "stats.db")
    st = jui.SqliteStatsStorage(db)
    st.put_static_info({"session_id": "cli", "worker_id": "0", "timestamp": 1.0,
                        "model_class": "MLN"})
    st.put_update({"session_id": "cli", "worker_id": "0", "timestamp": 2.0,
                   "iteration": 1, "score": 0.5})
    pserver.UIServer._instance = None
    server = pserver.main(["--port", "0", "--storage", db])
    try:
        base = f"http://127.0.0.1:{server.port}"
        assert _json(base, "/api/sessions") == ["cli"]
        assert _json(base, "/api/updates?session=cli")[0]["score"] == 0.5
        assert pserver.UIServer.get_instance() is server
    finally:
        server.stop()
    assert pserver.UIServer._instance is None


# --------------------------------------------------------------- serving
def _rnn_conf(pkg):
    return pkg.MultiLayerConfiguration(
        layers=[pkg.GravesLSTM(n_out=10),
                pkg.RnnOutputLayer(n_out=4, activation="softmax", loss="mcxent")],
        input_type=pkg.InputType.recurrent(6), seed=3)


def _mlp5_conf(pkg):
    return pkg.MultiLayerConfiguration(
        layers=[pkg.DenseLayer(n_out=16, activation="relu"),
                pkg.OutputLayer(n_out=3, activation="softmax", loss="mcxent")],
        input_type=pkg.InputType.feed_forward(5), seed=7)


@pytest.fixture
def served():
    pairs = {"mlp": _pair(_mlp5_conf), "rnn": _pair(_rnn_conf)}
    svc = serving.InferenceService(max_delay_ms=5)
    serving.set_service(svc)
    for name, (_, pnet) in pairs.items():
        svc.register(name, pnet)
    server = ui.UIServer(port=0)
    try:
        yield f"http://127.0.0.1:{server.port}", svc, pairs
    finally:
        server.stop()
        svc.stop()
        serving.set_service(None)


def test_predict_endpoint_matches_jax_output(served):
    base, _, pairs = served
    jnet, pnet = pairs["mlp"]
    x = np.random.default_rng(0).normal(size=(3, 5)).astype(np.float32)
    out = np.asarray(_post(base, "/serving/predict", {"model": "mlp", "features": x.tolist()})
                     ["output"])
    assert out.shape == (3, 3)
    np.testing.assert_allclose(out, np.asarray(jnet.output(jnp.asarray(x))), atol=ATOL)
    cls = _post(base, "/serving/predict", {"model": "mlp", "features": x.tolist(),
                                          "argmax": True})
    assert cls["model"] == "mlp" and cls["classes"] == out.argmax(-1).tolist()


def test_predict_unknown_model_404_and_malformed_400(served):
    base, _, _ = served
    code, body = _status(base, "/serving/predict", {"model": "nope", "features": [[0.0]]})
    assert code == 404 and "nope" in body["error"]
    assert _status(base, "/serving/predict", {"model": "mlp"})[0] == 400
    req = urllib.request.Request(base + "/serving/predict", b"{not json")
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(req, timeout=30)
    assert err.value.code == 400
    assert _status(base, "/serving/rnn", {"op": "open"})[0] == 400


def test_rnn_session_endpoints_match_jax_steps(served):
    base, _, pairs = served
    jnet, _ = pairs["rnn"]
    frames = np.random.default_rng(1).normal(size=(3, 6)).astype(np.float32)
    sid = _post(base, "/serving/rnn", {"model": "rnn", "op": "open"})["session"]
    got = [_post(base, "/serving/rnn", {"model": "rnn", "session": sid,
                                        "features": f.tolist()})["output"] for f in frames]
    want = np.asarray(jnet.output(jnp.asarray(frames[None])))[0]
    np.testing.assert_allclose(np.asarray(got), want, atol=ATOL)
    code, _ = _status(base, "/serving/rnn", {"model": "rnn", "op": "spin", "session": sid})
    assert code == 400
    assert _post(base, "/serving/rnn", {"model": "rnn", "op": "close",
                                        "session": sid})["closed"] == sid
    assert _status(base, "/serving/rnn", {"model": "rnn", "session": sid,
                                          "features": frames[0].tolist()})[0] in (404, 500)


def test_api_serving_and_metrics(served):
    base, svc, _ = served
    svc.predict("mlp", np.random.default_rng(2).normal(size=(2, 5)).astype(np.float32))
    stats = _json(base, "/api/serving")
    assert "mlp" in stats["models"] and stats["models"]["mlp"]["requests_total"] >= 1
    theirs = jserving.InferenceService(max_delay_ms=5)
    try:
        assert set(stats) == set(theirs.stats())
    finally:
        theirs.stop()
    metrics = _get(base, "/metrics").decode()
    assert "dl4jtpu_serve_requests_total" in metrics
    assert "dl4jtpu_serve_batch_fill_ratio" in metrics
