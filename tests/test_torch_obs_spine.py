"""The port's live telemetry spine (`obs/registry.py`, `obs/exporter.py`,
the loop's health, the supervisor's shared journal): every case of the
reference's `tests/test_obs_spine.py` against the port, and the parts
held against the reference on the CPU — the Prometheus text for the same
seeded registry contents, the serve metrics' tags, and the serve and
decode journals' event kinds and fields."""

from __future__ import annotations

import collections
import contextlib
import io
import itertools
import json
import re
import socket
import sys
import tempfile
import textwrap
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from dist_mnist_tpu_torch.obs import events
from dist_mnist_tpu_torch.obs import exporter as obs_exporter
from dist_mnist_tpu_torch.obs.events import RunJournal, read_journal
from dist_mnist_tpu_torch.obs.exporter import (
    HealthState,
    MetricsExporter,
    _prom_name,
    render_prometheus,
)
from dist_mnist_tpu_torch.obs.hist import StreamingHistogram
from dist_mnist_tpu_torch.obs.registry import MetricRegistry, RegistryWriter
from dist_mnist_tpu_torch.obs.writers import make_default_writer
from dist_mnist_tpu_torch.train.loop import PreemptionError, TrainLoop
from dist_mnist_tpu_torch.train.state import TrainState

#: the repo-wide tag convention: lowercase namespaced paths, so the
#: Prometheus mangling is lossless modulo '/' and '.'
TAG_RE = re.compile(r"^[a-z0-9_/.]+$")


@pytest.fixture(scope="module", autouse=True)
def _own_temp_root(tmp_path_factory):
    """A temp root of this module's own, set before the suite's
    per-test leak check reads it: that check looks for stray temp dirs,
    and tests that run at the same time in other processes make such dirs
    under the shared root. What these tests leak still lands where the
    check looks."""
    shared = tempfile.tempdir
    tempfile.tempdir = str(tmp_path_factory.mktemp("temp_root"))
    yield
    tempfile.tempdir = shared


@pytest.fixture(autouse=True)
def _no_ambient_journal_and_no_leaks():
    """No journal leaks into a test or out of it, and every port exporter
    and fleet scraper a test starts is closed by its end (the suite's own
    check reads the reference's exporter list only)."""
    prev = events.set_journal(None)
    yield
    events.set_journal(prev)
    assert not obs_exporter._LIVE_EXPORTERS
    assert not [t for t in threading.enumerate()
                if t.name == "ObsExporter-fleet"]


def _get(url, timeout=10):
    """(status, body) for a GET, without raising on 4xx/5xx."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _state(step=0):
    return TrainState(
        step=torch.tensor(step, dtype=torch.int32), params={},
        model_state={}, opt_state={}, rng=torch.Generator().manual_seed(0))


def _fake_step(state, batch):
    return (
        TrainState(step=state.step + 1, params=state.params,
                   model_state=state.model_state, opt_state=state.opt_state,
                   rng=state.rng),
        {"loss": torch.tensor(batch, dtype=torch.float32)},
    )


# -- registry -----------------------------------------------------------------

def test_registry_writer_feeds_registry():
    reg = MetricRegistry()
    w = RegistryWriter(reg)
    w.scalar("goodput/fraction", 0.9, step=10)
    w.scalars({"input/stall_ms": 1.5, "steps_per_sec": 120.0}, step=20)
    w.histogram("serve/batch_size", [1, 2, 4, 8], step=20)
    w.flush()
    scalars = reg.scalars()
    assert scalars["goodput/fraction"][:2] == (pytest.approx(0.9), 10)
    assert scalars["input/stall_ms"][0] == 1.5
    assert scalars["steps_per_sec"][1] == 20
    assert reg.histograms()["serve/batch_size"].count == 4
    snap = reg.snapshot()
    assert snap["scalars"]["steps_per_sec"] == 120.0
    assert snap["histograms"]["serve/batch_size"]["count"] == 4
    assert reg.tags() == sorted(
        ["goodput/fraction", "input/stall_ms", "steps_per_sec",
         "serve/batch_size"])


def test_registry_attach_histogram_live_reference():
    reg = MetricRegistry()
    h = StreamingHistogram()
    reg.attach_histogram("train/step_time_ms", h)
    h.observe(5.0)  # owner writes AFTER attach; registry sees it (by ref)
    assert reg.histograms()["train/step_time_ms"].count == 1


def test_make_default_writer_registry_every_process(tmp_path):
    # chief: the registry rides alongside the disk sinks
    reg = MetricRegistry()
    w = make_default_writer(str(tmp_path), chief=True, registry=reg)
    w.scalar("loss", 1.25, step=1)
    w.flush()
    w.close()
    assert reg.scalars()["loss"][0] == 1.25
    assert (tmp_path / "metrics.csv").exists()
    # non-chief: NO files, but the local registry still fills (each
    # process's /metrics serves its own numbers)
    reg2 = MetricRegistry()
    out2 = tmp_path / "nonchief"
    out2.mkdir()
    w2 = make_default_writer(str(out2), chief=False, registry=reg2)
    w2.scalar("loss", 2.5, step=1)
    w2.flush()
    w2.close()
    assert reg2.scalars()["loss"][0] == 2.5
    assert not list(out2.iterdir())


# -- prometheus rendering -----------------------------------------------------

#: valid exposition lines: HELP/TYPE comments, or `name[{labels}] value`
_PROM_LINE = re.compile(
    r"^(# (TYPE|HELP) [a-zA-Z_:][a-zA-Z0-9_:]* .*"
    r"|[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? \S+)$")


def test_render_prometheus_is_valid_text():
    reg = MetricRegistry()
    reg.set_scalar("goodput/fraction", 0.875, step=5)
    reg.set_scalar("serve/queue_depth", 3, step=5)
    h = StreamingHistogram()
    h.observe_many([0.5, 1.0, 5.0, 1e12])  # incl. an overflow-bucket value
    reg.attach_histogram("train/step_time_ms", h)
    body = render_prometheus(reg, HealthState("training"))
    lines = body.strip().splitlines()
    for line in lines:
        assert _PROM_LINE.match(line), f"invalid exposition line: {line!r}"
    assert "goodput_fraction 0.875" in lines
    # histogram: cumulative buckets, exactly one +Inf, sum+count present
    bucket_lines = [ln for ln in lines
                    if ln.startswith("train_step_time_ms_bucket")]
    cums = [int(ln.rsplit(" ", 1)[1]) for ln in bucket_lines]
    assert cums == sorted(cums), "bucket counts must be cumulative"
    assert cums[-1] == h.count
    assert sum('le="+Inf"' in ln for ln in bucket_lines) == 1
    assert any(ln.startswith("train_step_time_ms_sum ") for ln in lines)
    assert "train_step_time_ms_count 4" in lines
    # health gauges
    assert "process_healthy 1" in lines
    assert 'process_state{state="training"} 1' in lines
    assert 'process_state{state="failed"} 0' in lines


def test_render_prometheus_equals_the_reference():
    """The same seeded registry contents (scalars, a histogram over four
    decades with an overflow, the health state and the identity labels)
    render to the same text in both packages."""
    from dist_mnist_tpu.obs import exporter as jexporter
    from dist_mnist_tpu.obs import registry as jregistry

    rng = np.random.default_rng(21)
    regs = (MetricRegistry(), jregistry.MetricRegistry())
    tags = ["goodput/fraction", "serve/queue_depth", "a.b-c d",
            "step_time/p99_ms", "9lives"]
    values = rng.normal(size=len(tags)) * 10.0 ** rng.integers(-3, 6,
                                                             len(tags))
    samples = np.concatenate([rng.lognormal(1.0, 2.0, 500), [1e13]])
    for reg in regs:
        for i, (tag, v) in enumerate(zip(tags, values)):
            reg.set_scalar(tag, float(v), step=i)
        reg.set_scalar("nan/gauge", float("nan"), step=0)
        reg.record_values("train/step_time_ms", samples)
        reg.observe("serve/latency_ms", 3.25)
    info = {"host_id": "2", "generation": "1", "role": "train"}
    for state in ("training", "degraded", "draining"):
        ours = render_prometheus(regs[0], HealthState(state), info=info)
        theirs = jexporter.render_prometheus(
            regs[1], jexporter.HealthState(state), info=info)
        assert ours == theirs


def test_prom_name_mangling_is_total():
    for ugly in ("serve/latency_ms", "a.b-c d", "9starts_with_digit", "", "é"):
        name = _prom_name(ugly)
        assert re.match(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$", name), (ugly, name)


# -- health state machine -----------------------------------------------------

def test_health_state_machine():
    h = HealthState()
    assert h.state == "starting" and h.healthy
    h.set("training")
    assert h.healthy
    h.set("draining", "shutdown requested")
    assert not h.healthy
    snap = h.snapshot()
    assert snap["state"] == "draining"
    assert snap["detail"] == "shutdown requested"
    assert snap["since_s"] >= 0
    with pytest.raises(ValueError):
        h.set("confused")


# -- exporter http endpoints --------------------------------------------------

def test_exporter_endpoints(tmp_path):
    reg = MetricRegistry()
    reg.set_scalar("goodput/fraction", 1.0, step=1)
    health = HealthState("training", generation=2)
    jpath = tmp_path / "j.jsonl"
    with RunJournal(jpath) as j:
        for i in range(5):
            j.emit("checkpoint_save", step=i)
    with MetricsExporter(reg, health=health, journal_path=str(jpath),
                         port=0) as exp:
        assert exp.port > 0  # ephemeral port was resolved
        assert exp._thread.name == f"ObsExporter-{exp.port}"
        code, body = _get(exp.url("/metrics"))
        assert code == 200
        assert "goodput_fraction 1.0" in body
        code, body = _get(exp.url("/healthz"))
        assert code == 200
        snap = json.loads(body)
        assert snap["state"] == "training" and snap["generation"] == 2
        # unhealthy states flip to 503 so a router can react
        health.set("draining")
        code, body = _get(exp.url("/healthz"))
        assert code == 503
        assert json.loads(body)["state"] == "draining"
        # journal tail as NDJSON, bounded by ?n=
        code, body = _get(exp.url("/events?n=2"))
        assert code == 200
        recs = [json.loads(ln) for ln in body.strip().splitlines()]
        assert [r["step"] for r in recs] == [3, 4]
        code, _ = _get(exp.url("/nope"))
        assert code == 404
        code, _ = _get(exp.url("/fleet"))
        assert code == 404  # no fleet scraper attached
    assert exp not in obs_exporter._LIVE_EXPORTERS


def test_exporter_events_without_journal():
    with MetricsExporter(MetricRegistry(), port=0) as exp:
        code, body = _get(exp.url("/events"))
        assert code == 404
        assert "no journal" in body
        # /healthz without a HealthState: 200 "unknown" (exposition-only
        # processes still answer liveness probes)
        code, body = _get(exp.url("/healthz"))
        assert code == 200
        assert json.loads(body)["state"] == "unknown"


def test_exporter_bind_conflict_raises_oserror():
    with MetricsExporter(MetricRegistry(), port=0) as exp:
        with pytest.raises(OSError):
            MetricsExporter(MetricRegistry(), port=exp.port).start()


def test_exporter_post_routes_answer_404_without_a_replica():
    """The copied serve data plane: without `predict_fn`/`swap_fn` (the
    replica mode joins with ROADMAP §1 item 15) POST /predict and /swap
    answer 404 as the reference's do; wired, a typed admission error maps
    to its status (504 deadline, 429 queue full, 503 shutting down)."""
    from dist_mnist_tpu_torch.serve.admission import (
        DeadlineExceededError,
        QueueFullError,
        ShuttingDownError,
    )

    def post(url):
        req = urllib.request.Request(url, data=b"", method="POST")
        try:
            with urllib.request.urlopen(req, timeout=10) as resp:
                return resp.status, resp.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode()

    with MetricsExporter(MetricRegistry(), port=0) as exp:
        assert post(exp.url("/predict"))[0] == 404
        assert post(exp.url("/swap?step=3"))[0] == 404
        for err, code in ((DeadlineExceededError("late"), 504),
                          (QueueFullError("full"), 429),
                          (ShuttingDownError("bye"), 503),
                          (RuntimeError("boom"), 500)):
            def swap(step, err=err):
                raise err

            exp.swap_fn = swap
            got, body = post(exp.url("/swap?step=3"))
            assert got == code
            assert json.loads(body)["error"] == type(err).__name__


# -- train loop wiring --------------------------------------------------------

def test_loop_health_transitions_clean_run():
    from dist_mnist_tpu_torch.hooks import StopAtStepHook

    health = HealthState()
    seen = []

    class Watch:
        def begin(self, loop):
            pass

        def before_step(self, step):
            pass

        def after_step(self, step, state, outputs):
            seen.append(health.state)

        def end(self, state):
            pass

    loop = TrainLoop(_fake_step, _state(), itertools.repeat(1.0),
                     [Watch(), StopAtStepHook(last_step=3)], health=health)
    loop.run()
    assert seen == ["training"] * 3
    assert health.state == "stopped"
    assert health.snapshot()["detail"] == "reached last step"


def test_loop_health_failed_on_error():
    def bad_step(state, batch):
        raise RuntimeError("boom")

    health = HealthState()
    loop = TrainLoop(bad_step, _state(), itertools.repeat(1.0), [],
                     health=health)
    with pytest.raises(RuntimeError):
        loop.run()
    assert health.state == "failed"


def test_loop_health_preempted_and_journal(tmp_path):
    from dist_mnist_tpu_torch.hooks import StopAtStepHook

    class Notice:
        reason = "spot reclaim"
        _hits = 0

        def requested(self):
            Notice._hits += 1
            return Notice._hits > 3  # preempt before the 4th step

    class MemCkpt:
        saved = None

        def save(self, state):
            MemCkpt.saved = state

        def wait(self):
            pass

        def restore(self, target):
            return MemCkpt.saved

    health = HealthState()
    jpath = tmp_path / "j.jsonl"
    prev = events.set_journal(RunJournal(jpath))
    try:
        loop = TrainLoop(_fake_step, _state(), itertools.repeat(1.0),
                         [StopAtStepHook(last_step=100)],
                         checkpoint_manager=MemCkpt(), preemption=Notice(),
                         health=health)
        final = loop.run()
    finally:
        events.set_journal(prev).close()
    assert health.state == "preempted"
    assert loop.preempted_at == final.step_int == 3
    recs = read_journal(jpath)
    pre = [r for r in recs if r["event"] == "preemption"]
    assert len(pre) == 1
    assert pre[0]["step"] == 3
    assert pre[0]["reason"] == "spot reclaim"
    assert pre[0]["checkpoint_saved"] is True


def test_loop_journal_restore_events(tmp_path):
    """A recovered failure leaves a `restore` record matching goodput."""
    from dist_mnist_tpu_torch.hooks import StopAtStepHook

    class Flaky:
        calls = 0

        def __call__(self, state, batch):
            Flaky.calls += 1
            if Flaky.calls == 3:
                raise PreemptionError("fake")
            return _fake_step(state, batch)

    class MemCkpt:
        saved = None

        def save(self, state):
            MemCkpt.saved = state

        def restore(self, target):
            return MemCkpt.saved

    mgr = MemCkpt()
    mgr.save(_state())
    jpath = tmp_path / "j.jsonl"
    prev = events.set_journal(RunJournal(jpath))
    try:
        loop = TrainLoop(Flaky(), _state(), itertools.repeat(1.0),
                         [StopAtStepHook(last_step=5)],
                         checkpoint_manager=mgr, max_recoveries=2)
        loop.run()
    finally:
        events.set_journal(prev).close()
    restores = [r for r in read_journal(jpath) if r["event"] == "restore"]
    assert len(restores) == loop.goodput.snapshot()["recoveries"] == 1
    assert restores[0]["failed_at_step"] == 2
    assert restores[0]["restored_step"] == 0


def test_loop_step_time_histogram_fills():
    from dist_mnist_tpu_torch.hooks import StopAtStepHook

    loop = TrainLoop(_fake_step, _state(), itertools.repeat(1.0),
                     [StopAtStepHook(last_step=10)])
    loop.run()
    assert loop.step_time_hist.count == 10
    assert loop.step_time_hist.snapshot()["p50"] > 0


def test_step_time_hook_publishes_percentiles():
    from dist_mnist_tpu_torch.hooks import StepTimeHook, StopAtStepHook

    reg = MetricRegistry()
    hook = StepTimeHook(RegistryWriter(reg), every_steps=4)
    loop = TrainLoop(_fake_step, _state(), itertools.repeat(1.0),
                     [hook, StopAtStepHook(last_step=8)])
    loop.run()
    scalars = reg.scalars()
    for tag in ("step_time/p50_ms", "step_time/p95_ms", "step_time/p99_ms",
                "step_time/mean_ms"):
        assert tag in scalars, sorted(scalars)
        assert scalars[tag][0] > 0


# -- live scrape during a (fake) run ------------------------------------------

def test_metrics_scrape_mid_run():
    """/metrics serves the live step-time histogram and /healthz says
    `training` WHILE the loop runs."""
    from dist_mnist_tpu_torch.hooks import StopAtStepHook

    reg = MetricRegistry()
    health = HealthState()
    scraped = {}

    with MetricsExporter(reg, health=health, port=0) as exp:
        class Scrape:
            def begin(self, loop):
                reg.attach_histogram("train/step_time_ms",
                                     loop.step_time_hist)

            def before_step(self, step):
                pass

            def after_step(self, step, state, outputs):
                if step == 5 and not scraped:
                    scraped["metrics"] = _get(exp.url("/metrics"))
                    scraped["healthz"] = _get(exp.url("/healthz"))

            def end(self, state):
                pass

        loop = TrainLoop(_fake_step, _state(), itertools.repeat(1.0),
                         [Scrape(), StopAtStepHook(last_step=8)],
                         health=health)
        loop.run()

    code, body = scraped["metrics"]
    assert code == 200
    assert "# TYPE train_step_time_ms histogram" in body
    count_line = [ln for ln in body.splitlines()
                  if ln.startswith("train_step_time_ms_count")][0]
    # step 5's own timing lands AFTER the after_step hooks, so the live
    # scrape sees the 4 already-completed steps
    assert int(count_line.split()[1]) == 4
    code, body = scraped["healthz"]
    assert code == 200
    assert json.loads(body)["state"] == "training"
    assert health.state == "stopped"


# -- tag hygiene --------------------------------------------------------------

class _TagRecorder:
    """Writer that records every tag it is asked to publish."""

    def __init__(self):
        self.tags = set()

    def scalar(self, tag, value, step):
        self.tags.add(tag)

    def scalars(self, values, step):
        self.tags.update(values)

    def histogram(self, tag, values, step):
        self.tags.add(tag)

    def flush(self):
        pass


def test_serve_metrics_tags_are_hygienic():
    from dist_mnist_tpu_torch.serve.metrics import ServeMetrics

    m = ServeMetrics()
    m.record_latency(3.0)
    m.record_batch(4, 8)
    rec = _TagRecorder()
    m.emit(rec, step=1, queue_depth=2,
           cache={"hits": 1, "misses": 0})
    assert rec.tags, "emit published nothing"
    for tag in rec.tags:
        assert TAG_RE.match(tag), f"non-hygienic serve tag {tag!r}"


def test_serve_and_decode_metric_tags_equal_the_reference():
    """`emit` and `attach_to` publish the reference's tag names, for the
    classifier server's metrics (with an int8 report, a seq grid's and an
    MoE's ladders) and the decode scheduler's (with the KV gauges)."""
    from dist_mnist_tpu.serve import metrics as jmetrics
    from dist_mnist_tpu_torch.serve import metrics as tmetrics

    report = {"leaves": {"fc1/w": {"max_abs_err": 0.01},
                         "fc2/w": {"max_abs_err": 0.02}},
              "max_abs_err": 0.02}
    kv = {"kv_pages_pinned": 3, "kv_bytes_pinned": 96,
          "kv_bytes_pool": 512}
    got = []
    for mod in (tmetrics, jmetrics):
        serve, decode = mod.ServeMetrics(), mod.DecodeMetrics()
        serve.record_quant_report(report)
        serve.record_latency(3.0)
        serve.record_batch(4, 8, seq_occupancy=0.5, moe_drop_fraction=0.1)
        decode.record_submitted("best_effort")
        decode.record_admitted(2.5, "best_effort")
        decode.record_step(3)
        decode.record_completed(9.0, 4, 400.0)
        rec, reg = _TagRecorder(), MetricRegistry()
        serve.emit(rec, step=1, queue_depth=2,
                   cache={"hits": 1, "misses": 2})
        decode.emit(rec, step=1, queue_depth=0, kv=kv)
        serve.attach_to(reg)
        decode.attach_to(reg)
        got.append((sorted(rec.tags), reg.tags(),
                    serve.quant_error.count))
    assert got[0] == got[1]
    assert got[0][2] == 2  # one quant_error observation a leaf


def test_step_time_hook_tags_are_hygienic():
    from dist_mnist_tpu_torch.hooks import StepTimeHook, StopAtStepHook

    rec = _TagRecorder()
    loop = TrainLoop(_fake_step, _state(), itertools.repeat(1.0),
                     [StepTimeHook(rec, every_steps=2),
                      StopAtStepHook(last_step=4)])
    loop.run()
    for tag in rec.tags:
        assert TAG_RE.match(tag), f"non-hygienic step-time tag {tag!r}"


# -- the serve and decode journals, against the reference's ------------------

def _journal_of(fn, path):
    """Run `fn` with a journal at `path` installed; the records."""
    prev = events.set_journal(RunJournal(path))
    jprev = None
    try:
        from dist_mnist_tpu.obs import events as jevents

        jprev = jevents.set_journal(jevents.RunJournal(str(path) + ".ref"))
        fn()
    finally:
        events.set_journal(prev).close()
        jevents.set_journal(jprev).close()
    return read_journal(path), read_journal(str(path) + ".ref")


def _kinds_and_fields(recs) -> dict:
    """event -> (count, the record keys past the journal's own)."""
    own = {"seq", "ts", "pid", "gen", "event", "host"}
    out: dict = {}
    for r in recs:
        n, keys = out.get(r["event"], (0, set()))
        out[r["event"]] = (n + 1, keys | (set(r) - own))
    return {k: (n, sorted(keys)) for k, (n, keys) in out.items()}


def test_serve_journal_equals_the_reference(tmp_path, mesh1):
    """The classifier server journals what the reference's does — one
    ``serve_start`` and ``serve_stop`` with the same fields, and a
    ``compile_cache`` ``compile`` at each cell's first run — and its
    health goes serving -> draining -> stopped."""
    import jax

    from dist_mnist_tpu.models.registry import get_model as jget_model
    from dist_mnist_tpu.serve import InferenceServer as JServer
    from dist_mnist_tpu.serve import ServeConfig as JConfig
    from dist_mnist_tpu.serve.engine import InferenceEngine as JEngine
    from dist_mnist_tpu.obs import exporter as jexporter
    from dist_mnist_tpu_torch.convert import params_from_jax
    from dist_mnist_tpu_torch.models.registry import get_model
    from dist_mnist_tpu_torch.serve import InferenceServer, ServeConfig
    from dist_mnist_tpu_torch.serve.engine import InferenceEngine
    from dist_mnist_tpu_torch.serve.loadgen import make_images

    shape = (28, 28, 1)
    jmodel = jget_model("mlp")
    jparams, _ = jmodel.init(jax.random.PRNGKey(0),
                             np.zeros((1, *shape), np.float32))
    images = make_images(shape, seed=3, n=10)
    states = {}

    def serve(server, tag):
        seen = []
        with server:
            seen.append(server.health.state)
            for f in [server.submit(im) for im in images]:
                f.result(timeout=60)
        states[tag] = seen + [server.health.state]

    def ours():
        eng = InferenceEngine(get_model("mlp"),
                              params_from_jax(jax.device_get(jparams)), {},
                              device="cpu", image_shape=shape, max_bucket=4)
        serve(InferenceServer(eng, ServeConfig(max_batch=4),
                              health=HealthState()), "ours")

    def theirs():
        eng = JEngine(jmodel, jparams, {}, mesh1, model_name="mlp",
                      image_shape=shape, max_bucket=4)
        serve(JServer(eng, JConfig(max_batch=4),
                      health=jexporter.HealthState()), "theirs")

    got, _ = _journal_of(ours, tmp_path / "t.jsonl")
    _, want = _journal_of(theirs, tmp_path / "j.jsonl")
    assert _kinds_and_fields(got) == _kinds_and_fields(want)
    assert _kinds_and_fields(got)["compile_cache"][0] == 3  # buckets 1,2,4
    stop = [r for r in got if r["event"] == "serve_stop"][0]
    assert stop["drained"] is True and stop["completed"] == 10
    assert states["ours"] == states["theirs"] == ["serving", "stopped"]


def test_decode_journal_equals_the_reference(tmp_path, mesh1):
    """Decode on the paged int8 cache journals the reference's events
    with its fields: one ``decode_prewarm``/``decode_start``/
    ``decode_stop``, and a ``decode_admit``, ``kv_page_alloc``,
    ``kv_page_reclaim`` and ``decode_evict`` a request, with the same
    prompt lengths, page counts and token counts."""
    from dist_mnist_tpu.serve import DecodeScheduler as JScheduler
    from dist_mnist_tpu.serve import build_decode_engine as jbuild
    from dist_mnist_tpu.serve import run_decode_loadgen as jloadgen
    from dist_mnist_tpu_torch.serve import (
        DecodeScheduler,
        build_decode_engine,
        run_decode_loadgen,
    )

    kw = dict(vocab_size=64, dim=32, depth=1, heads=2, max_seq=16,
              cache_layout="paged", kv_page_tokens=8, kv_quant="int8")
    load = dict(n_requests=6, concurrency=2, seed=5)

    def ours():
        eng = build_decode_engine("cpu", max_slots=2, **kw)
        eng.prewarm()
        with DecodeScheduler(eng) as sched:
            run_decode_loadgen(sched, **load)

    def theirs():
        eng = jbuild(mesh1, max_slots=2, **kw)
        eng.prewarm()
        with JScheduler(eng) as sched:
            jloadgen(sched, **load)

    got, _ = _journal_of(ours, tmp_path / "t.jsonl")
    _, want = _journal_of(theirs, tmp_path / "j.jsonl")
    # the reference's decode grid compiles through its CompiledModelCache
    # (``compile_cache`` events); the port's decode runs its cells eagerly
    # and has no such cache (serve/decode.py's docstring)
    want = [r for r in want if r["event"] != "compile_cache"]
    assert _kinds_and_fields(got) == _kinds_and_fields(want)
    kinds = _kinds_and_fields(got)
    for name in ("decode_admit", "kv_page_alloc", "kv_page_reclaim",
                 "decode_evict"):
        assert kinds[name][0] == load["n_requests"], name

    def values(recs, name, field):
        return sorted(r[field] for r in recs if r["event"] == name)

    for name, field in (("decode_admit", "prompt_len"),
                        ("decode_admit", "slo_target"),
                        ("kv_page_alloc", "pages"),
                        ("kv_page_reclaim", "pages"),
                        ("decode_evict", "tokens")):
        assert values(got, name, field) == values(want, name, field), name
    # the port's grid prefills at one row bucket (the reference's at each
    # power of two up to the slots), so the cell counts differ; every
    # cell runs once at the prewarm
    pre = [r for r in got if r["event"] == "decode_prewarm"][0]
    assert pre["programs"] == pre["compiled"] > 0


# -- supervisor journal -------------------------------------------------------

_ENV_STUB = textwrap.dedent("""\
    import json, os, sys
    args = dict(a.split("=", 1) for a in sys.argv[1:]
                if a.startswith("--") and "=" in a)
    pid = int(args.get("--process_id", "0"))
    out = args["--envlog"] + f".p{pid}"
    with open(out, "a") as fh:
        fh.write(json.dumps({
            "journal": os.environ.get("DIST_MNIST_TPU_JOURNAL"),
            "generation": os.environ.get("DIST_MNIST_TPU_GENERATION"),
        }) + "\\n")
    if pid == 1 and args.get("--stub_mode") == "fail_once":
        marker = args["--stub_marker"]
        if not os.path.exists(marker):
            open(marker, "w").close()
            sys.exit(3)
    sys.exit(0)
""")


def _supervise(tmp_path, train_args, **kw):
    from dist_mnist_tpu_torch.cli.launch import launch

    stub = tmp_path / "env_stub.py"
    stub.write_text(_ENV_STUB)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = launch(2, train_args, platform="cpu",
                    child_command=[sys.executable, str(stub)],
                    restart_backoff_s=0.05, **kw)
    return rc, buf.getvalue()


def test_supervisor_owns_one_journal_across_generations(tmp_path):
    jpath = tmp_path / "journal.jsonl"
    rc, log = _supervise(
        tmp_path,
        [f"--envlog={tmp_path / 'env'}", "--stub_mode=fail_once",
         f"--stub_marker={tmp_path / 'marker'}"],
        max_restarts=2, journal=str(jpath),
    )
    assert rc == 0, log
    recs = read_journal(jpath)
    evs = [r["event"] for r in recs]
    # the complete lifecycle, in order, in ONE file
    assert evs == [
        "supervisor_start",
        "generation_start", "generation_end",
        "supervisor_restart",
        "generation_start", "generation_end",
        "supervisor_stop",
    ], evs
    by_ev = {e: [r for r in recs if r["event"] == e] for e in set(evs)}
    assert by_ev["supervisor_start"][0]["max_restarts"] == 2
    assert [r["gen"] for r in by_ev["generation_start"]] == [0, 1]
    assert by_ev["generation_end"][0]["rc"] == 3
    assert by_ev["generation_end"][0]["first_dead"] == 1
    assert by_ev["generation_end"][1]["rc"] == 0
    assert by_ev["supervisor_restart"][0]["attempt"] == 1
    assert by_ev["supervisor_stop"][0] == {
        **by_ev["supervisor_stop"][0], "rc": 0, "restarts": 1}
    # children of BOTH generations were pointed at the same journal with
    # their generation number (the env injection contract)
    for pid in (0, 1):
        lines = (tmp_path / f"env.p{pid}").read_text().strip().splitlines()
        envs = [json.loads(ln) for ln in lines]
        assert [e["generation"] for e in envs] == ["0", "1"]
        assert all(e["journal"] == str(jpath) for e in envs)


_SLEEP_STUB = textwrap.dedent("""\
    import sys, time
    args = dict(a.split("=", 1) for a in sys.argv[1:]
                if a.startswith("--") and "=" in a)
    time.sleep(2.0 if int(args.get("--process_id", "0")) == 1 else 0.8)
    sys.exit(0)
""")


def test_supervisor_journals_chaos_kill(tmp_path):
    from dist_mnist_tpu_torch.cli.launch import launch

    jpath = tmp_path / "journal.jsonl"
    stub = tmp_path / "sleep_stub.py"
    stub.write_text(_SLEEP_STUB)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launch(2, [], platform="cpu",
               child_command=[sys.executable, str(stub)],
               restart_backoff_s=0.05, max_restarts=1,
               journal=str(jpath), kill_spec=(1, 0.2))
    log = buf.getvalue()
    assert "fault injected: SIGKILL p1" in log, log
    kills = [r for r in read_journal(jpath)
             if r["event"] == "fault_injected"]
    assert len(kills) == 1
    assert kills[0]["kind"] == "kill_process"
    assert kills[0]["process"] == 1
    assert kills[0]["gen"] == 0


# -- end to end through run_config ------------------------------------------

def test_run_config_obs_spine_end_to_end(tmp_path):
    """run_config wires the whole spine: the journal, the registry in the
    default writer, /metrics + /healthz live during training, hygienic
    tags."""
    from dist_mnist_tpu_torch.cli.train import run_config
    from dist_mnist_tpu_torch.configs import get_config
    from dist_mnist_tpu_torch.data import datasets

    data = tmp_path / "data"
    datasets._write_synth_cache(data, "mnist",
                                datasets._synth("mnist", 512, 128, 0))
    cfg = get_config("mlp_mnist", train_steps=6, eval_every=0, log_every=2)
    port = _free_port()
    scraped = {}

    class Scrape:
        def begin(self, loop):
            pass

        def before_step(self, step):
            pass

        def after_step(self, step, state, outputs):
            if step >= 2 and not scraped:
                scraped["metrics"] = _get(f"http://127.0.0.1:{port}/metrics")
                scraped["healthz"] = _get(f"http://127.0.0.1:{port}/healthz")

        def end(self, state):
            pass

    state, final, ctx = run_config(
        cfg, device="cpu", data_dir=str(data), logdir=str(tmp_path / "logs"),
        metrics_port=port, extra_hooks=[Scrape()],
    )
    assert state.step_int == 6
    # the live scrape saw the training state and the step-time histogram
    code, body = scraped["metrics"]
    assert code == 200
    assert "# TYPE train_step_time_ms histogram" in body
    assert 'process_info{generation="0",host_id="0",role="train"} 1' in body
    code, body = scraped["healthz"]
    assert code == 200 and json.loads(body)["state"] == "training"
    # the registry rides in ctx, fully hygienic
    assert ctx["health"].state == "stopped"
    assert ctx["metrics_url"] == f"http://127.0.0.1:{port}/metrics"
    tags = ctx["registry"].tags()
    assert "train/step_time_ms" in tags
    for tag in tags:
        assert TAG_RE.match(tag), f"non-hygienic tag {tag!r}"
    # the journal landed in the logdir with the run lifecycle
    recs = read_journal(tmp_path / "logs" / "events.jsonl")
    evs = [r["event"] for r in recs]
    assert evs[0] == "run_start" and evs[-1] == "run_stop"
    assert recs[-1]["ok"] is True
    assert ctx["journal"] == str(tmp_path / "logs" / "events.jsonl")


def test_run_config_with_a_taken_port_warns_and_trains(tmp_path, caplog):
    """A metrics port already bound logs a warning and the run goes on
    without exposition (the reference's behaviour)."""
    import logging

    from dist_mnist_tpu_torch.cli.train import run_config
    from dist_mnist_tpu_torch.configs import get_config
    from dist_mnist_tpu_torch.data import datasets

    data = tmp_path / "data"
    datasets._write_synth_cache(data, "mnist",
                                datasets._synth("mnist", 512, 128, 0))
    cfg = get_config("mlp_mnist", train_steps=2, eval_every=0)
    with socket.socket() as taken:
        taken.bind(("127.0.0.1", 0))
        taken.listen(1)
        port = taken.getsockname()[1]
        with caplog.at_level(logging.WARNING):
            state, _, ctx = run_config(cfg, device="cpu", data_dir=str(data),
                                       metrics_port=port)
    assert state.step_int == 2 and ctx["metrics_url"] is None
    assert "could not bind port" in caplog.text
    kinds = collections.Counter(r.levelname for r in caplog.records)
    assert kinds["ERROR"] == 0
