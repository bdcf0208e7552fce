"""Chrome-trace export of the port (`obs/timeline.py` over the
`ProfilerHook`'s `torch.profiler` traces): every case of the reference's
`tests/test_timeline.py`, and `summarize_trace` held against the
reference's on one trace file."""

from __future__ import annotations

import gzip
import json
import tempfile

import pytest
import torch

from dist_mnist_tpu.obs import timeline as jtimeline
from dist_mnist_tpu_torch.obs import exporter as obs_exporter
from dist_mnist_tpu_torch.obs import (
    export_chrome_trace,
    latest_trace,
    summarize_trace,
)
from dist_mnist_tpu_torch.obs import fleet as obs_fleet


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


@pytest.fixture(scope="module", autouse=True)
def _no_leaked_exporters():
    """The port's exporters and fleet scrapers are closed by every test
    (the suite's own check reads the reference's list only)."""
    yield
    assert not obs_exporter._LIVE_EXPORTERS
    import threading

    assert not [t for t in threading.enumerate()
                if t.name == "ObsExporter-fleet"], obs_fleet.__name__


def _matmul(n: int) -> torch.Tensor:
    x = torch.ones(n, n)
    return x @ x


@pytest.fixture(scope="module")
def profile_dir(tmp_path_factory):
    """A logdir holding one trace in the profiler hook's layout."""
    d = tmp_path_factory.mktemp("prof")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _matmul(256)
    prof.export_chrome_trace(str(d / "trace-steps0-1.json"))
    return d


class FakeLoop:
    initial_step = 0
    state = None


def test_latest_trace_found(profile_dir):
    assert latest_trace(profile_dir) == profile_dir / "trace-steps0-1.json"


def test_export_chrome_trace(profile_dir, tmp_path):
    out = export_chrome_trace(profile_dir)
    assert out is not None and out.name.startswith("timeline-")
    assert out.name.endswith("steps0-1.json")
    data = json.loads(out.read_text())
    assert "traceEvents" in data and len(data["traceEvents"]) > 0


def test_export_no_trace_returns_none(tmp_path):
    assert export_chrome_trace(tmp_path) is None
    assert latest_trace(tmp_path) is None


def test_summarize_trace(profile_dir):
    rows = summarize_trace(latest_trace(profile_dir))
    assert rows, "profiler produced no complete events"
    assert rows == sorted(rows, key=lambda r: -r["total_us"])
    for r in rows:
        # total is rounded to 1 dp, avg to 2 dp — allow the rounding gap
        assert r["count"] >= 1 and r["avg_us"] <= r["total_us"] + 0.06
    assert any("mm" in r["name"] for r in rows)


def test_summarize_trace_equals_the_reference_on_one_file(profile_dir,
                                                          tmp_path):
    """Both packages' `summarize_trace` give the same rows on one trace,
    raw and gzipped."""
    src = latest_trace(profile_dir)
    assert summarize_trace(src, top=50) == jtimeline.summarize_trace(
        src, top=50)
    gz = tmp_path / "t.trace.json.gz"
    gz.write_bytes(gzip.compress(src.read_bytes()))
    assert summarize_trace(gz) == jtimeline.summarize_trace(gz)


def test_profiler_hook_end_exports(tmp_path):
    """A run shorter than the trace window still gets the chrome-trace
    export on end() — same path as the cadence stop."""
    from dist_mnist_tpu_torch.hooks.builtin import ProfilerHook

    hook = ProfilerHook(str(tmp_path), start_step=0, num_steps=100)
    hook.begin(FakeLoop())
    hook.before_step(0)  # trace window opens
    x = _matmul(128)
    hook.after_step(1, None, {"loss": x[0, 0]})  # window unfinished
    hook.end(None)  # early end: must stop the trace AND export
    assert latest_trace(tmp_path) is not None
    assert list(tmp_path.rglob("timeline-*.json"))


def test_profiler_hook_chunked_loop_still_traces(tmp_path):
    """A chunked loop strides past the exact start step; the hook must
    still capture a window (and not restart after it completed)."""
    from dist_mnist_tpu_torch.hooks.builtin import ProfilerHook

    hook = ProfilerHook(str(tmp_path), start_step=10, num_steps=3)
    hook.begin(FakeLoop())
    hook.before_step(0)
    assert not hook._active  # window not reached yet
    hook.before_step(100)  # strides past start=10 -> trace opens
    assert hook._active
    x = _matmul(64)
    hook.after_step(200, None, {"loss": x[0, 0]})  # past stop -> closes
    assert not hook._active
    hook.before_step(300)  # completed window must NOT restart
    assert not hook._active
    assert latest_trace(tmp_path) is not None


def test_profiler_hook_single_chunk_run_traces(tmp_path):
    """When the whole run is ONE chunk, the window start aligns down to
    the chunk boundary so the (only) chunk is the one traced."""
    from dist_mnist_tpu_torch.hooks.builtin import ProfilerHook

    class ChunkedLoop(FakeLoop):
        steps_per_call = 200

    hook = ProfilerHook(str(tmp_path), start_step=10, num_steps=3)
    hook.begin(ChunkedLoop())
    hook.before_step(0)
    assert hook._active  # window aligned to chunk boundary 0
    x = _matmul(64)
    hook.after_step(200, None, {"loss": x[0, 0]})
    assert not hook._active
    assert latest_trace(tmp_path) is not None


def test_summarize_synthetic_trace(tmp_path):
    """Deterministic check of aggregation math on a hand-written trace."""
    trace = {
        "traceEvents": [
            {"ph": "X", "name": "matmul", "dur": 10.0},
            {"ph": "X", "name": "matmul", "dur": 30.0, "pid": 7, "tid": 2},
            {"ph": "X", "name": "relu", "dur": 5.0},
            {"ph": "M", "name": "meta-only"},
        ]
    }
    p = tmp_path / "t.trace.json.gz"
    p.write_bytes(gzip.compress(json.dumps(trace).encode()))
    rows = summarize_trace(p)
    # events missing pid/tid aggregate under the (0, 0) default track
    assert rows[0] == {"name": "matmul", "total_us": 40.0, "count": 2,
                       "avg_us": 20.0, "tracks": 2}
    assert rows[1]["name"] == "relu" and rows[1]["tracks"] == 1


def test_summarize_trace_without_trace_events(tmp_path):
    """A trace with no `traceEvents` key (or an empty list) summarizes to
    no rows — not a KeyError mid-triage."""
    p1 = tmp_path / "empty.json"
    p1.write_text("{}")
    assert summarize_trace(p1) == []
    p2 = tmp_path / "no_complete.json"
    p2.write_text(json.dumps({"traceEvents": []}))
    assert summarize_trace(p2) == []
    # metadata-only events (no ph=X / no dur) likewise aggregate to nothing
    p3 = tmp_path / "meta.json"
    p3.write_text(json.dumps({"traceEvents": [
        {"ph": "M", "name": "process_name"},
        {"ph": "X", "name": "no-dur"},
    ]}))
    assert summarize_trace(p3) == []
    # sparse producers: non-dict events and non-numeric durs are skipped
    p4 = tmp_path / "sparse.json"
    p4.write_text(json.dumps({"traceEvents": [
        "not-a-dict",
        {"ph": "X", "name": "bad", "dur": "fast"},
        {"ph": "X", "dur": 3.0},  # nameless -> aggregates under "?"
    ]}))
    rows = summarize_trace(p4)
    assert [r["name"] for r in rows] == ["?"]


def test_export_chrome_trace_is_host_stamped(profile_dir, monkeypatch):
    """On a shared logdir each host's export carries its host id in the
    filename, so concurrent exports never shadow each other and
    scripts/fleet_trace.py maps files back to hosts (its `_TIMELINE_RE`)."""
    import importlib.util

    from pathlib import Path

    monkeypatch.setenv("DIST_MNIST_TPU_HOST_ID", "3")
    out = export_chrome_trace(profile_dir)
    assert out is not None and out.name == "timeline-h3-steps0-1.json"
    spec = importlib.util.spec_from_file_location(
        "fleet_trace", Path(__file__).resolve().parents[1] / "scripts"
        / "fleet_trace.py")
    fleet_trace = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fleet_trace)
    assert fleet_trace._TIMELINE_RE.match(out.name).group(1) == "3"
    monkeypatch.delenv("DIST_MNIST_TPU_HOST_ID")
    # explicit host id beats the (absent) environment
    out = export_chrome_trace(profile_dir, host_id=5)
    assert out.name.startswith("timeline-h5-")
    # no identity at all: the single-process name
    out = export_chrome_trace(profile_dir)
    assert out.name == "timeline-steps0-1.json"


def test_profiler_hook_survives_export_failure(tmp_path, monkeypatch, caplog):
    """export_chrome_trace raising must not take the run down: the hook
    logs and the trace window still closes cleanly."""
    import logging

    from dist_mnist_tpu_torch.hooks.builtin import ProfilerHook
    from dist_mnist_tpu_torch.obs import timeline

    def boom(logdir, out_path=None):
        raise OSError("disk full")

    monkeypatch.setattr(timeline, "export_chrome_trace", boom)
    hook = ProfilerHook(str(tmp_path), start_step=0, num_steps=1)
    hook.begin(FakeLoop())
    hook.before_step(0)
    x = _matmul(32)
    with caplog.at_level(logging.ERROR, "dist_mnist_tpu_torch.hooks.builtin"):
        hook.after_step(1, None, {"loss": x[0, 0]})  # closes + export fails
    assert not hook._active and hook._done
    assert "chrome trace export failed" in caplog.text
    # the window itself was captured; only the convenience export failed
    assert latest_trace(tmp_path) is not None
    assert not list(tmp_path.glob("timeline-*.json"))
    hook.end(None)  # and end() after a completed window is a no-op
