"""Fleet observability in the port (`obs/fleet.py`, `obs/anomaly.py`, the
loop's spans, the supervisor's fleet view): every case of the reference's
`tests/test_fleet_obs.py` against the port; each package's
`parse_prometheus` reading the other's exposition exactly; the detectors
flagging the same points as the reference's on seeded series; and the
`--supervisor_port` fleet view over two gloo ranks of `cli.train`, one
supervised spawn for the file."""

from __future__ import annotations

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
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from dist_mnist_tpu_torch.hooks import StopAtStepHook
from dist_mnist_tpu_torch.obs import events
from dist_mnist_tpu_torch.obs import exporter as obs_exporter
from dist_mnist_tpu_torch.obs.anomaly import AnomalyHook, RobustDetector
from dist_mnist_tpu_torch.obs.events import RunJournal, read_journal
from dist_mnist_tpu_torch.obs.exporter import (
    HealthState,
    MetricsExporter,
    render_prometheus,
)
from dist_mnist_tpu_torch.obs.fleet import FleetScraper, parse_prometheus
from dist_mnist_tpu_torch.obs.hist import StreamingHistogram
from dist_mnist_tpu_torch.obs.registry import MetricRegistry
from dist_mnist_tpu_torch.train.loop import TrainLoop
from dist_mnist_tpu_torch.train.state import TrainState

REPO = Path(__file__).resolve().parents[1]


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


# -- Prometheus text round-trip ------------------------------------------------

def test_histogram_prometheus_round_trip_is_exact():
    """render_prometheus -> parse_prometheus reconstructs the histogram
    bucket-for-bucket: the fleet merge path loses nothing."""
    h = StreamingHistogram()
    for v in [0.5, 1.0, 2.5, 2.5, 40.0, 900.0, 1e9]:
        h.observe(v)
    reg = MetricRegistry()
    reg.attach_histogram("train/step_time_ms", h)
    text = render_prometheus(reg)
    _, hists, _ = parse_prometheus(text)
    back = hists["train_step_time_ms"]
    assert back._counts == h._counts
    assert back.count == h.count
    assert back.sum == pytest.approx(h.sum)
    assert back.percentiles()["p50"] == h.percentiles()["p50"]
    # merging two parsed copies doubles every bucket
    back.merge(hists["train_step_time_ms"])
    assert back.count == 2 * h.count


def test_each_parse_prometheus_reads_the_others_exposition_exactly():
    """The port's parser reads the reference's exposition, and the
    reference's parser the port's, to the same scalars, identity and
    bucket-exact histograms (a seeded ladder with an overflow)."""
    from dist_mnist_tpu.obs import exporter as jexporter
    from dist_mnist_tpu.obs import fleet as jfleet
    from dist_mnist_tpu.obs import registry as jregistry

    rng = np.random.default_rng(14)
    samples = np.concatenate([rng.lognormal(2.0, 1.5, 300), [5e12]])
    regs = (MetricRegistry(), jregistry.MetricRegistry())
    for reg in regs:
        reg.record_values("train/step_time_ms", samples)
        reg.set_scalar("goodput/fraction", 0.8125, 3)
    info = {"host_id": "1", "generation": "2", "role": "train"}
    ours = render_prometheus(regs[0], HealthState("degraded"), info=info)
    theirs = jexporter.render_prometheus(
        regs[1], jexporter.HealthState("degraded"), info=info)
    for parse_a, parse_b in ((parse_prometheus, jfleet.parse_prometheus),
                             (jfleet.parse_prometheus, parse_prometheus)):
        for text in (ours, theirs):
            sa, ha, ia = parse_a(text)
            sb, hb, ib = parse_b(text)
            assert sa == sb and ia == ib
            assert ia["state"] == "degraded" and ia["host_id"] == "1"
            a, b = ha["train_step_time_ms"], hb["train_step_time_ms"]
            assert a._counts == b._counts and a.count == b.count == 301
            assert a.sum == b.sum
    src = regs[0].histograms()["train/step_time_ms"]
    _, back, _ = parse_prometheus(theirs)
    assert back["train_step_time_ms"]._counts == src._counts


def test_parse_prometheus_scalars_info_and_state():
    reg = MetricRegistry()
    reg.set_scalar("goodput/fraction", 0.875, 7)
    health = HealthState()
    health.set("degraded", "anomaly: loss")
    text = render_prometheus(
        reg, health, info={"host_id": "3", "role": "train"})
    scalars, _, info = parse_prometheus(text)
    assert scalars["goodput_fraction"] == pytest.approx(0.875)
    assert info["host_id"] == "3" and info["role"] == "train"
    assert info["state"] == "degraded"


def test_healthz_degraded_is_200_but_flagged():
    health = HealthState()
    health.set("training")
    health.set("degraded", "anomaly: loss")
    assert health.healthy  # degraded serves 200: still doing useful work
    snap = health.snapshot()
    assert snap["state"] == "degraded" and snap["detail"] == "anomaly: loss"
    text = render_prometheus(None, health)
    assert 'process_state{state="degraded"} 1' in text
    assert "process_healthy 1" in text


# -- exporter under concurrent scrape ------------------------------------------

def test_concurrent_scrapes_against_live_exporter():
    """N scrape threads against one exporter while the owner keeps
    writing: every response parses, no tearing, no 500s."""
    reg = MetricRegistry()
    hist = StreamingHistogram()
    reg.attach_histogram("train/step_time_ms", hist)
    health = HealthState()
    health.set("training")
    with MetricsExporter(reg, health=health, port=0,
                         info={"host_id": "0", "role": "train"}) as exp:
        stop = threading.Event()

        def writer():
            i = 0
            while not stop.is_set():
                hist.observe(1.0 + (i % 50))
                reg.set_scalar("train/loss", 1.0 / (i + 1), i)
                i += 1

        wt = threading.Thread(target=writer, daemon=True)
        wt.start()
        errors = []

        def scrape():
            for _ in range(20):
                code, body = _get(exp.url("/metrics"))
                if code != 200:
                    errors.append(code)
                    continue
                _, hists, info = parse_prometheus(body)
                if info.get("host_id") != "0":
                    errors.append("info lost")
                h = hists.get("train_step_time_ms")
                # cumulative buckets must reconstruct self-consistently
                if h is not None and h.count != sum(h._counts):
                    errors.append("torn histogram")

        threads = [threading.Thread(target=scrape) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        stop.set()
        wt.join()
    assert not errors


# -- fleet scraper -------------------------------------------------------------

def _child_exporter(host_id, mean_ms, n=20):
    reg = MetricRegistry()
    hist = StreamingHistogram()
    for _ in range(n):
        hist.observe(mean_ms)
    reg.attach_histogram("train/step_time_ms", hist)
    health = HealthState()
    health.set("training")
    exp = MetricsExporter(
        reg, health=health, port=0,
        info={"host_id": str(host_id), "generation": "0", "role": "train"},
    ).start()
    return exp, hist


def test_fleet_scraper_merges_two_children(tmp_path):
    exp0, hist0 = _child_exporter(0, 5.0)
    exp1, hist1 = _child_exporter(1, 8.0)
    scraper = FleetScraper(interval_s=60)
    sup = None
    try:
        scraper.set_targets({0: f"http://127.0.0.1:{exp0.port}",
                             1: f"http://127.0.0.1:{exp1.port}"})
        snap = scraper.scrape_once()
        assert [h["reachable"] for h in snap["hosts"]] == [True, True]
        assert snap["hosts"][0]["info"]["host_id"] == "0"
        merged = scraper.merged_histograms()["train_step_time_ms"]
        assert merged.count == hist0.count + hist1.count
        scalars = scraper.registry.scalars()
        assert scalars["fleet/hosts"][0] == 2
        assert scalars["fleet/reachable_hosts"][0] == 2
        assert scalars["fleet/healthy_hosts"][0] == 2
        # the supervisor exporter serves the merged fleet view + /fleet
        sup = MetricsExporter(
            registry=scraper.registry, port=0,
            info={"role": "supervisor", "generation": 0},
            fleet=scraper,
        ).start()
        code, body = _get(sup.url("/metrics"))
        assert code == 200
        assert "# TYPE fleet_train_step_time_ms histogram" in body
        assert 'fleet_host_up{host="0"} 1' in body
        assert 'fleet_host_up{host="1"} 1' in body
        assert 'process_info{generation="0",role="supervisor"} 1' in body
        _, hists, _ = parse_prometheus(body)
        assert hists["fleet_train_step_time_ms"].count == merged.count
        code, body = _get(sup.url("/fleet"))
        assert code == 200
        fleet = json.loads(body)
        assert len(fleet["hosts"]) == 2 and fleet["scrapes"] == 1
        # a vanished child is data, not an error: the scrape keeps going
        exp1.close()
        snap = scraper.scrape_once()
        assert [h["reachable"] for h in snap["hosts"]] == [True, False]
        assert scraper.registry.scalars()["fleet/reachable_hosts"][0] == 1
    finally:
        if sup is not None:
            sup.close()
        scraper.close()
        exp0.close()
        exp1.close()


def test_straggler_detection_names_the_host(tmp_path):
    exp0, hist0 = _child_exporter(0, 5.0)
    exp1, hist1 = _child_exporter(1, 50.0)
    jrnl = RunJournal(tmp_path / "j.jsonl")
    scraper = FleetScraper(journal=jrnl, interval_s=60,
                           straggler_ratio=2.0, straggler_window=3)
    try:
        scraper.set_targets({0: f"http://127.0.0.1:{exp0.port}",
                             1: f"http://127.0.0.1:{exp1.port}"})
        for _ in range(3):
            # both hosts keep stepping at their characteristic speed
            hist0.observe(5.0)
            hist1.observe(50.0)
            snap = scraper.scrape_once()
        assert snap["straggler"]["host"] == 1
        assert snap["straggler"]["ratio"] == pytest.approx(10.0)
        assert snap["straggler"]["detected"] == 1
        scalars = scraper.registry.scalars()
        assert scalars["fleet/straggler_host"][0] == 1
        assert scalars["fleet/straggler_ratio"][0] == pytest.approx(10.0)
        assert scalars["fleet/stragglers_detected"][0] == 1
    finally:
        scraper.close()
        exp0.close()
        exp1.close()
        jrnl.close()
    recs = [r for r in read_journal(tmp_path / "j.jsonl")
            if r["event"] == "straggler_detected"]
    assert len(recs) == 1  # sustained skew fires ONCE, not per scrape
    assert recs[0]["host"] == 1
    assert recs[0]["ratio"] == pytest.approx(10.0)
    assert recs[0]["window"] == 3
    # tail_run renders it with the host in the head
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        from tail_run import format_record
    finally:
        sys.path.pop(0)
    line = format_record(recs[0])
    assert "straggler_detected" in line and "host=1" in line
    assert "10.00x median" in line


def test_fleet_tags_are_hygienic():
    """The fleet/* namespace follows the repo's tag convention."""
    tag_re = re.compile(r"^[a-z0-9_/.]+$")
    scraper = FleetScraper(interval_s=60)
    try:
        scraper.scrape_once()  # zero targets still publishes the gauges
        tags = scraper.registry.tags()
        assert "fleet/hosts" in tags and "fleet/straggler_ratio" in tags
        for tag in tags:
            assert tag.startswith("fleet/"), tag
            assert tag_re.match(tag), f"non-hygienic fleet tag {tag!r}"
    finally:
        scraper.close()


# -- anomaly detection ---------------------------------------------------------

def test_robust_detector_flags_spike_not_drift():
    det = RobustDetector(window=16, threshold=6.0, warmup=4)
    verdicts = [det.check(1.0 + 0.01 * (i % 3)) for i in range(10)]
    assert all(v is None or not v["anomaly"] for v in verdicts)
    v = det.check(50.0)
    assert v is not None and v["anomaly"] and v["z"] >= 6.0
    # the spike entered the window but cannot poison the median
    v = det.check(1.0)
    assert not v["anomaly"]


def test_robust_detector_flat_window_still_fires():
    det = RobustDetector(window=8, threshold=6.0, warmup=4)
    for _ in range(6):
        det.check(2.0)  # MAD == 0: the relative-change fallback engages
    v = det.check(3.0)
    assert v is not None and v["anomaly"]


def _spiky_series(seed: int, n: int = 400) -> np.ndarray:
    """A seeded noisy series with a slow drift and a few spikes."""
    rng = np.random.default_rng(seed)
    x = 1.0 + 0.002 * np.arange(n) + rng.normal(0, 0.02, n)
    for i in rng.choice(np.arange(20, n), 6, replace=False):
        x[i] += rng.choice([-1, 1]) * rng.uniform(0.5, 5.0)
    return x


def test_robust_detector_flags_the_references_points():
    """On seeded series with spikes and drift, the port's detector flags
    the same indices as the reference's, with the same verdicts."""
    from dist_mnist_tpu.obs import anomaly as janomaly

    for seed in range(3):
        series = _spiky_series(seed)
        ours = RobustDetector(window=32, threshold=6.0, warmup=8)
        theirs = janomaly.RobustDetector(window=32, threshold=6.0, warmup=8)
        got = [ours.check(float(x)) for x in series]
        want = [theirs.check(float(x)) for x in series]
        assert got == want
        flagged = [i for i, v in enumerate(got) if v and v["anomaly"]]
        assert 3 <= len(flagged) <= 12, flagged


def test_anomaly_hook_flags_the_references_steps(tmp_path):
    """The same loss series through both packages' AnomalyHook (a fetch
    every 3 steps): the same steps flagged with the same records, the
    same health shading, and the same journal kinds."""
    import jax.numpy as jnp

    from dist_mnist_tpu.obs import anomaly as janomaly
    from dist_mnist_tpu.obs import events as jevents
    from dist_mnist_tpu.obs import exporter as jexporter

    series = _spiky_series(7, n=240).astype(np.float32)

    class _Loop:
        initial_step = 0
        step_time_hist = None

    out = []
    for hook_cls, health, tensor, emod in (
            (AnomalyHook, HealthState(), torch.tensor, events),
            (janomaly.AnomalyHook, jexporter.HealthState(), jnp.asarray,
             jevents)):
        jpath = tmp_path / f"{len(out)}.jsonl"
        prev = emod.set_journal(emod.RunJournal(jpath))
        health.set("training")
        hook = hook_cls(every_steps=3, health=health, window=24, warmup=6,
                        recovery_cadences=2)
        hook.begin(_Loop())
        states = []
        try:
            for step, x in enumerate(series, start=1):
                hook.after_step(step, None, {"loss": tensor(x)})
                states.append(health.state)
        finally:
            emod.set_journal(prev).close()
        out.append((hook.anomalies, states,
                    [r["event"] for r in emod.read_journal(jpath)]))
    assert out[0] == out[1]
    anomalies, states, _ = out[0]
    assert anomalies and {a["kind"] for a in anomalies} == {"loss"}
    assert "degraded" in states and states[-1] == "training"


def test_anomaly_hook_degraded_flip_and_recovery(tmp_path):
    jrnl = RunJournal(tmp_path / "j.jsonl")
    events.set_journal(jrnl)
    health = HealthState()
    health.set("training")
    hook = AnomalyHook(every_steps=1, health=health, threshold=5.0,
                       window=8, warmup=3, recovery_cadences=2)

    class _Loop:
        initial_step = 0
        step_time_hist = StreamingHistogram()

    hook.begin(_Loop())
    step = 0
    for _ in range(6):
        step += 1
        hook.after_step(step, None, {"loss": torch.tensor(1.0)})
    assert health.state == "training" and not hook.anomalies
    step += 1
    hook.after_step(step, None, {"loss": torch.tensor(500.0)})
    assert hook.anomalies and hook.anomalies[0]["kind"] == "loss"
    assert health.state == "degraded"
    assert health.healthy  # degraded is 200-but-flagged, not an outage
    for _ in range(2):
        step += 1
        hook.after_step(step, None, {"loss": torch.tensor(1.0)})
    assert health.state == "training"  # recovery_cadences clean -> restored
    jrnl.close()
    evs = [r["event"] for r in read_journal(tmp_path / "j.jsonl")]
    assert "anomaly" in evs and "anomaly_cleared" in evs


def test_anomaly_hook_never_perturbs_the_trajectory(tmp_path):
    """The bit-identical pin: the same loop with and without the hook
    (plus a spiky loss that FIRES it) produces the same trajectory."""
    batches = [1.0, 1.0, 1.0, 1.0, 1.0, 400.0, 1.0, 1.0, 1.0, 1.0]

    def run(with_hook):
        seen = []

        class _Watch:
            def begin(self, loop):
                pass

            def before_step(self, step):
                pass

            def after_step(self, step, state, outputs):
                seen.append(outputs["loss"].numpy().tobytes())

            def end(self, state):
                pass

        hooks = [_Watch(), StopAtStepHook(last_step=len(batches))]
        anomaly = None
        if with_hook:
            anomaly = AnomalyHook(every_steps=1, threshold=5.0,
                                  window=8, warmup=3)
            hooks.append(anomaly)
        loop = TrainLoop(_fake_step, _state(), iter(batches), hooks)
        loop.run()
        return seen, anomaly

    clean, _ = run(False)
    instrumented, anomaly = run(True)
    assert anomaly.anomalies, "the seeded spike must actually fire"
    assert clean == instrumented


# -- correlated step tracing ---------------------------------------------------

def test_loop_emits_spans_and_journal_host_stamp(tmp_path, monkeypatch):
    monkeypatch.setenv(events.ENV_HOST_ID, "3")
    jrnl = RunJournal(tmp_path / "j.jsonl", generation=2)
    events.set_journal(jrnl)
    loop = TrainLoop(_fake_step, _state(), itertools.repeat(1.0),
                     [StopAtStepHook(last_step=6)], span_steps=2)
    loop.run()
    jrnl.close()
    recs = read_journal(tmp_path / "j.jsonl")
    spans = [r for r in recs if r["event"] == "span"]
    assert spans, "span cadence never fired"
    names = {r["name"] for r in spans}
    assert {"input_wait", "dispatch"} <= names
    for r in spans:
        # the correlated-tracing triple rides on every record
        assert (r["host"], r["gen"]) == (3, 2)
        assert isinstance(r["step"], int)
        if r["name"] in ("input_wait", "dispatch"):
            assert r["dur_ms"] >= 0


def test_fleet_trace_builds_per_host_tracks(tmp_path):
    jpath = tmp_path / "j.jsonl"
    with RunJournal(jpath, generation=0, host_id=0) as j:
        j.emit("span", name="dispatch", step=10, dur_ms=4.0)
    with RunJournal(jpath, generation=0, host_id=1) as j:
        j.emit("span", name="dispatch", step=10, dur_ms=5.0)
        j.emit("span", name="h2d", step=10, bytes=4096)
    with RunJournal(jpath, generation=0) as j:
        j.host_id = None  # a supervisor-side record
        j.emit("generation_resize", kind="shrink", old_world=2,
               new_world=1, host=1)
    with RunJournal(jpath, generation=1, host_id=0) as j:
        j.emit("span", name="dispatch", step=20, dur_ms=4.5)

    sys.path.insert(0, str(REPO / "scripts"))
    try:
        from fleet_trace import build_fleet_trace, main
    finally:
        sys.path.pop(0)
    doc = build_fleet_trace(jpath)
    evs = doc["traceEvents"]
    names = {(e["pid"], e["args"]["name"]) for e in evs
             if e["ph"] == "M" and e["name"] == "process_name"}
    assert {(1, "host 0"), (2, "host 1")} <= names
    complete = [e for e in evs if e["ph"] == "X"]
    assert {(e["pid"], e["tid"]) for e in complete} == {(1, 0), (2, 0),
                                                        (1, 1)}
    assert all(e["dur"] > 0 and e["ts"] >= 0 for e in complete)
    # h2d has no duration -> instant, not a zero-width bar
    h2d = [e for e in evs if e.get("name") == "h2d"]
    assert h2d and h2d[0]["ph"] == "i"
    resize = [e for e in evs if e.get("name") == "generation_resize"]
    assert resize and resize[0]["ph"] == "i"
    # the CLI writes the same document
    out = tmp_path / "trace.json"
    assert main([str(jpath), "-o", str(out)]) == 0
    assert json.loads(out.read_text())["traceEvents"]
    # the bench's counts of the same trace (bench.fleet_trace_stats)
    from dist_mnist_tpu_torch.bench import fleet_trace_stats

    assert fleet_trace_stats(str(jpath)) == {
        "events": len(evs), "host_tracks": 2, "span_generations": [0, 1],
        "resize_markers": 1}


# -- the fleet ladder under an elastic supervisor ------------------------------

# A stub child with no torch that behaves like an instrumented trainer:
# serves /metrics (a growing train_step_time_ms histogram at a per-host
# mean) and /healthz on metrics_port+rank, traps SIGTERM, sleeps per
# generation.
FLEET_STUB = textwrap.dedent("""\
    import json, os, signal, sys, threading, time
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    signal.signal(signal.SIGTERM, lambda *a: sys.exit(0))
    args = dict(a.split("=", 1) for a in sys.argv[1:]
                if a.startswith("--") and "=" in a)
    gen = os.environ.get("DIST_MNIST_TPU_GENERATION", "0")
    host = os.environ.get("DIST_MNIST_TPU_HOST_ID", "?")
    rank = int(args["--process_id"])
    port = int(args["--metrics_port"]) + rank
    mean_ms = 50.0 if host == args.get("--stub_straggler") else 5.0
    state = {"count": 0}

    class H(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path == "/healthz":
                body = json.dumps({"state": "training", "healthy": True,
                                   "generation": int(gen)})
            else:
                state["count"] += 10
                c = state["count"]
                body = (
                    "# TYPE train_step_time_ms histogram\\n"
                    f'train_step_time_ms_bucket{{le="+Inf"}} {c}\\n'
                    f"train_step_time_ms_sum {mean_ms * c}\\n"
                    f"train_step_time_ms_count {c}\\n"
                    f'process_info{{generation="{gen}",host_id="{host}",'
                    'role="train"} 1\\n'
                )
            data = body.encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *a):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", port), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    time.sleep(float(args.get(f"--stub_sleep_g{gen}", "0")))
    srv.shutdown()
    sys.exit(0)
""")


def _free_port_block(n):
    from dist_mnist_tpu_torch.bench import _free_port_block as block

    base = block(n)
    if base is None:
        pytest.skip("no contiguous port block available")
    return base


def _wait_for(sup, pred, timeout, what):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            code, body = _get(f"{sup}/fleet", timeout=2)
            if code == 200 and pred(json.loads(body)):
                return json.loads(body)
        except OSError:
            pass
        time.sleep(0.05)
    pytest.fail(f"fleet never reached: {what}")


def test_elastic_fleet_ladder_straggler_and_shrink(tmp_path):
    """An elastic supervisor over 3 stub children serving /metrics. The
    supervisor's FleetScraper merges them (fleet histograms and per-host
    gauges on the supervisor's /metrics, JSON on /fleet), names the seeded
    straggler in the journal, and survives a mid-scrape shrink without
    wedging."""
    from dist_mnist_tpu_torch.cli.launch import launch

    stub = tmp_path / "fleet_stub.py"
    stub.write_text(FLEET_STUB)
    jpath = tmp_path / "journal.jsonl"
    metrics_base = _free_port_block(3)
    sup_port = _free_port()
    result = {}

    def supervise():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            result["rc"] = launch(
                3,
                [f"--metrics_port={metrics_base}", "--stub_straggler=2",
                 "--stub_sleep_g0=20", "--stub_sleep_g1=4"],
                platform="cpu",
                child_command=[sys.executable, str(stub)],
                restart_backoff_s=0.05, elastic=True, journal=str(jpath),
                kill_spec=(1, 2.0), supervisor_port=sup_port,
                fleet_interval_s=0.1,
            )
        result["log"] = buf.getvalue()

    t = threading.Thread(target=supervise)
    t.start()
    try:
        sup = f"http://127.0.0.1:{sup_port}"
        # generation 0: all three hosts scraped and merged
        _wait_for(sup, lambda f: len(f["hosts"]) == 3
                  and all(h["reachable"] for h in f["hosts"]), 15.0,
                  "3 reachable hosts")
        # the seeded straggler (host 2, 10x the median) gets named
        fleet = _wait_for(sup, lambda f: f["straggler"]["detected"] >= 1,
                          15.0, "straggler detection")
        assert fleet["straggler"]["host"] == 2
        assert fleet["straggler"]["ratio"] >= 2.0
        # the supervisor's /metrics serves the merged fleet view live
        code, body = _get(f"{sup}/metrics")
        assert code == 200
        assert "# TYPE fleet_train_step_time_ms histogram" in body
        assert "fleet_straggler_ratio" in body
        assert 'fleet_host_step_time_mean_ms{host="2"}' in body
        assert 'process_info{generation="0",role="supervisor"} 1' in body
        _, hists, _ = parse_prometheus(body)
        assert hists["fleet_train_step_time_ms"].count > 0
        # the kill at t=2s shrinks 3 -> 2 mid-scrape: the scraper must
        # re-point at the survivors (host 1 stays listed as "gone") and
        # keep serving, not wedge
        fleet = _wait_for(
            sup, lambda f: len(f["targets"]) == 2
            and sorted(h["host"] for h in f["hosts"]
                       if h["reachable"]) == [0, 2],
            25.0, "post-shrink fleet of 2")
        gone = [h for h in fleet["hosts"] if h["host"] == 1]
        assert gone and gone[0]["state"] == "gone"
        code, body = _get(f"{sup}/metrics")
        assert 'process_info{generation="1",role="supervisor"} 1' in body
    finally:
        t.join(timeout=60)
    assert not t.is_alive(), "supervised run wedged"
    assert result["rc"] == 0, result["log"]

    recs = read_journal(jpath)
    straggler = [r for r in recs if r["event"] == "straggler_detected"]
    assert straggler and straggler[0]["host"] == 2
    resize = [r for r in recs if r["event"] == "generation_resize"]
    assert [(r["kind"], r["old_world"], r["new_world"], r["host"])
            for r in resize] == [("shrink", 3, 2, 1)]


def test_supervisor_port_fleet_view_over_two_gloo_ranks(tmp_path):
    """`cli.launch --elastic --supervisor_port` over two gloo ranks of
    `cli.train --metrics_port`: the supervisor's scraper reaches both
    hosts' exporters in generation 0, and after host 1's planned loss
    (a kill_host fault) it re-targets the shrunken generation: one
    target, host 1 ``gone``; the run ends at its last step."""
    from dist_mnist_tpu_torch.cli.launch import main as launch_main
    from dist_mnist_tpu_torch.data import datasets
    from dist_mnist_tpu_torch.faults.plan import Fault, FaultPlan

    data = tmp_path / "data"
    datasets._write_synth_cache(data, "mnist",
                                datasets._synth("mnist", 2048, 256, 0))
    plan = FaultPlan([Fault.kill_host(1, step=35)])
    metrics_base = _free_port_block(2)
    sup_port = _free_port()
    jpath = tmp_path / "journal.jsonl"
    result, seen = {}, {"gen0": set(), "gen1_targets": None, "gone": False}

    def supervise():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            try:
                result["rc"] = launch_main([
                    "--num_processes=2", "--platform=cpu", "--elastic",
                    f"--supervisor_port={sup_port}", f"--journal={jpath}",
                    f"--fault_plan={plan.to_json()}", "--",
                    "--config=mlp_mnist", f"--data_dir={data}",
                    f"--checkpoint_dir={tmp_path / 'ckpt'}",
                    "--checkpoint_every_steps=10", "--train_steps=60",
                    "--batch_size=64", "--eval_every=0", "--log_every=10",
                    f"--metrics_port={metrics_base}"])
            except SystemExit as exc:
                result["rc"] = exc.code
        result["log"] = buf.getvalue()

    t = threading.Thread(target=supervise)
    t.start()
    try:
        sup = f"http://127.0.0.1:{sup_port}"
        deadline = time.monotonic() + 240
        while t.is_alive() and time.monotonic() < deadline:
            try:
                code, body = _get(f"{sup}/fleet", timeout=2)
            except OSError:
                time.sleep(0.05)
                continue
            if code == 200:
                fleet = json.loads(body)
                for h in fleet["hosts"]:
                    if h["reachable"] and h["info"].get("generation") == "0":
                        seen["gen0"].add(h["host"])
                if fleet["targets"] and len(fleet["targets"]) == 1:
                    seen["gen1_targets"] = sorted(fleet["targets"])
                    seen["gone"] = any(h["host"] == 1
                                       and h["state"] == "gone"
                                       for h in fleet["hosts"])
            time.sleep(0.05)
    finally:
        t.join(timeout=240)
    assert not t.is_alive(), "supervised run wedged"
    assert result["rc"] == 0, result.get("log", "")[-3000:]
    assert seen["gen0"] == {0, 1}, result["log"][-3000:]
    assert seen["gen1_targets"] == ["0"] and seen["gone"]
    recs = read_journal(jpath)
    resize = [r for r in recs if r["event"] == "generation_resize"]
    assert [(r["kind"], r["old_world"], r["new_world"], r["host"])
            for r in resize] == [("shrink", 2, 1, 1)]
    finals = [r for r in recs if r["event"] == "run_stop" and r.get("ok")]
    assert [r["step"] for r in finals if r["gen"] == 1] == [60]
