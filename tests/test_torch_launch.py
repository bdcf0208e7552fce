"""The port's multi-process launcher (`cli/launch.py`) on the CPU: real
OS processes of `cli.train`, each a rank of a gloo group
(`--platform=cpu`), as the reference's tests/test_launch.py drives its
own: two ranks train to the same result, a failing child's exit status
propagates and no child outlives the launch, and a two-rank checkpoint
(FSDP: the chief gathers and writes) resumes on both ranks.

The dataset's synthetic twin is written once into the module's data
directory, so the children load it instead of each synthesizing it.
"""

from __future__ import annotations

import contextlib
import io
import re
import tempfile

import pytest

from dist_mnist_tpu_torch.cli import launch as launch_mod
from dist_mnist_tpu_torch.cli import train as train_cli


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
def _no_live_children():
    """No child of the port's launcher outlives a test."""
    yield
    live = [p.pid for p in launch_mod._LIVE_CHILDREN if p.poll() is None]
    assert live == [], f"launch left children running: {live}"


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("data"))
    assert train_cli.main(["--download_only", f"--data_dir={d}",
                           "--config=mlp_mnist", "--device=cpu"]) is None
    return d


def _launch(*train_args, n=2) -> tuple[int, str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = launch_mod.launch(n, list(train_args), platform="cpu")
    return rc, buf.getvalue()


def test_two_process_training(data_dir):
    rc, log = _launch("--config=mlp_mnist", f"--data_dir={data_dir}",
                      "--train_steps=6", "--batch_size=32",
                      "--eval_every=0", "--log_every=2")
    assert rc == 0, log
    for p in ("p0", "p1"):
        assert re.search(rf"\[{p}\].*process {p[1]}/2, 1 local / 2 global "
                         r"devices, backend gloo \(cpu platform\)", log), log
    finals = re.findall(r"\[p(\d)\].*done: step=(\d+) test_acc=([0-9.]+)",
                        log)
    assert sorted(f[0] for f in finals) == ["0", "1"], log
    assert all(f[1] == "6" for f in finals), finals
    assert finals[0][2] == finals[1][2], finals
    # one all-reduce of the flat gradient (and the two metrics) a step
    assert re.search(r'collectives per step: \{"all_reduce_bytes": '
                     r'318048\.0, "all_reduce_calls": 1\.0\}', log), log


def test_launch_propagates_child_failure():
    rc, log = _launch("--config=does_not_exist")
    assert rc != 0
    assert "[launcher]" in log or "error" in log


def test_two_process_fsdp_checkpoint_resume(data_dir, tmp_path):
    """Run 1 saves (the chief gathers the FSDP slices and writes); run 2
    logs restored=True on both ranks and continues to the longer step
    count."""
    common = ["--config=mlp_mnist", f"--data_dir={data_dir}",
              f"--checkpoint_dir={tmp_path / 'ckpt'}", "--batch_size=32",
              "--eval_every=0", "--log_every=2", "--sharding=fsdp",
              "--checkpoint_every_steps=2"]
    rc1, log1 = _launch(*common, "--train_steps=4")
    assert rc1 == 0, log1
    assert re.search(r"\[p0\].*restored=False", log1), log1
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()
                  if p.name.isdigit()) == ["0", "2", "4"]
    rc2, log2 = _launch(*common, "--train_steps=8")
    assert rc2 == 0, log2
    for p in ("p0", "p1"):
        assert re.search(rf"\[{p}\].*sharding fsdp, restored=True", log2), log2
        assert re.search(rf"\[{p}\].*done: step=8", log2), log2


@pytest.mark.parametrize("argv,what", [
    (["--devices_per_process=2"], "one device per process"),
])
def test_refused_launcher_flags_name_their_reason(argv, what):
    with pytest.raises(SystemExit) as info:
        launch_mod.main(argv + ["--", "--config=mlp_mnist"])
    assert what in str(info.value.code)


_KILL = '{"faults": [{"kind": "kill_process", "process": 1, "after_s": 2.0}]}'


@pytest.mark.parametrize("argv,want", [
    (["--max_restarts=2", "--restart_backoff_s=0.5"],
     {"max_restarts": 2, "restart_backoff_s": 0.5}),
    (["--elastic", "--min_processes=2", "--regrow_after_s=3"],
     {"elastic": True, "min_processes": 2, "regrow_after_s": 3.0}),
    ([f"--fault_plan={_KILL}"], {"kill_spec": (1, 2.0), "host_kill": None}),
    (["--journal=/x/j.jsonl"], {"journal": "/x/j.jsonl"}),
    (["--compile_cache_dir=/x"], {"compile_cache_dir": "/x"}),
    (["--elastic", "--supervisor_port=0"],
     {"elastic": True, "supervisor_port": 0}),
], ids=["max_restarts", "elastic", "fault_plan", "journal",
        "compile_cache_dir", "supervisor_port"])
def test_supervisor_flags_reach_the_supervisor(monkeypatch, argv, want):
    """The supervisor's flags (ROADMAP §1 items 13(a) and 13(b)) now run:
    each reaches `launch`, and a fault plan goes on to the children too
    (the supervised runs themselves: tests/test_torch_faults.py and
    tests/test_torch_elastic.py; the compile cache's forwarding to every
    generation: tests/test_torch_compilecache.py)."""
    seen = {}

    def fake(n, train_args, **kw):
        seen.update(kw, n=n, train_args=train_args)
        return 0

    monkeypatch.setattr(launch_mod, "launch", fake)
    assert launch_mod.main(argv + ["--", "--config=mlp_mnist"]) == 0
    assert {k: seen[k] for k in want} == want
    assert seen["train_args"][0] == "--config=mlp_mnist"
    if "kill_spec" in want:
        assert seen["train_args"][1].startswith("--fault_plan=")


_SLEEP_STUB = """\
import os, signal, sys, time
signal.signal(signal.SIGTERM, lambda *a: sys.exit(0))
args = dict(a.split("=", 1) for a in sys.argv[1:] if "=" in a)
gen = os.environ.get("DIST_MNIST_TPU_GENERATION", "0")
time.sleep(float(args.get("--stub_sleep_g" + gen, "0")))
"""


def test_supervisor_endpoint_serves_its_health(tmp_path):
    """`--supervisor_port` (ROADMAP §1 item 14): under --elastic the
    supervisor serves its own HealthState — ``training`` while a
    generation runs — its /metrics labelled role=supervisor with the
    generation, its journal's tail; without --metrics_port among the
    train args there is no fleet view (/fleet 404). At the end the
    health reads ``stopped`` and the endpoint is closed."""
    import json
    import socket
    import sys
    import threading
    import time
    import urllib.error
    import urllib.request

    from dist_mnist_tpu_torch.obs import HealthState
    from dist_mnist_tpu_torch.obs.exporter import _LIVE_EXPORTERS

    def get(url):
        try:
            with urllib.request.urlopen(url, timeout=5) as resp:
                return resp.status, resp.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode()

    stub = tmp_path / "stub.py"
    stub.write_text(_SLEEP_STUB)
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    health, result = HealthState(), {}

    def supervise():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            result["rc"] = launch_mod.launch(
                2, ["--stub_sleep_g0=1.5", "--stub_sleep_g1=1.5"],
                platform="cpu", child_command=[sys.executable, str(stub)],
                elastic=True, journal=str(tmp_path / "j.jsonl"),
                kill_spec=(1, 0.5), health=health, supervisor_port=port)
        result["log"] = buf.getvalue()

    t = threading.Thread(target=supervise)
    t.start()
    seen = {}
    try:
        base = f"http://127.0.0.1:{port}"
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and len(seen) < 2:
            try:
                code, body = get(base + "/healthz")
            except OSError:
                time.sleep(0.05)
                continue
            state = json.loads(body)
            if code == 200 and state["state"] == "training":
                _, metrics = get(base + "/metrics")
                gen = "1" if "generation=\"1\"" in metrics else "0"
                seen.setdefault(gen, (metrics, get(base + "/fleet"),
                                      get(base + "/events?n=50")))
            time.sleep(0.05)
    finally:
        t.join(timeout=60)
    assert result["rc"] == 0, result.get("log")
    assert sorted(seen) == ["0", "1"], result["log"]
    metrics, fleet, tail = seen["1"]
    assert 'process_info{generation="1",role="supervisor"} 1' in metrics
    assert 'process_state{state="training"} 1' in metrics
    assert fleet[0] == 404
    assert "generation_resize" in tail[1]
    assert health.state == "stopped"
    assert not _LIVE_EXPORTERS


#: a rank module for the stand-by tests: records how it was started
_RANK_STUB = """\
import json, os, sys, time
_MODULE_T0 = time.monotonic()
time.sleep(0.5)  # an import that takes a while


def main(argv):
    args = dict(a.split("=", 1) for a in argv if "=" in a)
    main_mod = sys.modules["__main__"].__spec__
    with open(args["--stub_log"], "a") as f:
        f.write(json.dumps({
            "gen": os.environ.get("DIST_MNIST_TPU_GENERATION"),
            "host": os.environ.get("DIST_MNIST_TPU_HOST_ID"),
            "rank": args["--process_id"],
            "omp": os.environ.get("OMP_NUM_THREADS"),
            "standby": main_mod is not None
            and main_mod.name == "dist_mnist_tpu_torch.cli.standby",
            "since_anchor_s": time.monotonic() - _MODULE_T0,
            "import_ahead_s": globals().get("_STANDBY_IMPORT_S")}) + "\\n")
    if args.get("--stub_fail_g0") and os.environ.get(
            "DIST_MNIST_TPU_GENERATION") == "0" and args["--process_id"] == "1":
        time.sleep(1.5)  # the next generation's stand-bys import meanwhile
        sys.exit(3)


if __name__ == "__main__":
    main(sys.argv[1:])
"""


def test_supervised_generations_start_from_stand_bys(tmp_path, monkeypatch):
    """Every rank starts as a stand-by (`cli/standby.py`). Generation 0's
    are handed their arguments at once, so their startup clock counts
    the import; a supervised run's next generation is started ahead:
    its ranks imported the rank module while generation 0 ran, start at
    `main` with the generation's environment, their clock anchored at
    the hand-off and the import paid before it kept apart; a re-formed
    generation starts the next stand-bys only at its first step. Every
    CPU rank gets one intra-op thread; an unsupervised launch starts no
    rank ahead; no process outlives the launch."""
    import json
    import sys

    (tmp_path / "rank_stub.py").write_text(_RANK_STUB)
    monkeypatch.setenv("PYTHONPATH", str(tmp_path))
    monkeypatch.delenv("OMP_NUM_THREADS", raising=False)
    spawned = []
    spawn = launch_mod._spawn_standbys

    def counting(n, *a):
        spawned.append(n)
        return spawn(n, *a)

    monkeypatch.setattr(launch_mod, "_spawn_standbys", counting)
    log = tmp_path / "stub.log"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = launch_mod.launch(
            2, [f"--stub_log={log}", "--stub_fail_g0=1"], platform="cpu",
            module="rank_stub", max_restarts=1, restart_backoff_s=0.05,
            journal=str(tmp_path / "j.jsonl"))
    assert rc == 0, buf.getvalue()
    lines = [json.loads(x) for x in log.read_text().splitlines()]
    by_gen = {g: sorted((x["rank"], x["host"], x["standby"]) for x in lines
                        if x["gen"] == g) for g in ("0", "1")}
    assert by_gen == {"0": [("0", "0", True), ("1", "1", True)],
                      "1": [("0", "0", True), ("1", "1", True)]}
    assert {x["omp"] for x in lines} == {"1"}
    gen0 = [x for x in lines if x["gen"] == "0"]
    gen1 = [x for x in lines if x["gen"] == "1"]
    # the stub's import sleeps 0.5 s: generation 0 counts it, the
    # generation started ahead had paid it before its hand-off
    assert min(x["since_anchor_s"] for x in gen0) >= 0.5
    assert max(x["import_ahead_s"] for x in gen0) < 0.25
    assert max(x["since_anchor_s"] for x in gen1) < 0.5
    assert min(x["import_ahead_s"] for x in gen1) >= 0.5
    # generation 0's two ranks, then its two stand-bys ahead; generation
    # 1 journals no first step, so no stand-by is started after it
    assert spawned == [1, 1, 2]
    assert not launch_mod._LIVE_CHILDREN
    # an unsupervised launch starts its ranks at once and none ahead
    spawned.clear()
    with contextlib.redirect_stdout(io.StringIO()):
        assert launch_mod.launch(1, [f"--stub_log={log}"],
                                 module="rank_stub", platform="cpu") == 0
    assert spawned == [1]
    last = json.loads(log.read_text().splitlines()[-1])
    assert last["standby"] and last["since_anchor_s"] >= 0.5
    # a stand-by the supervisor no longer needs exits at end of input
    (p,) = launch_mod._spawn_standbys(1, "rank_stub", "cpu")
    p.stdin.close()
    assert p.wait(timeout=60) == 0
    launch_mod._retire([p])
    assert sys.modules.get("rank_stub") is None


def test_first_step_watch_reads_its_generation_from_whole_lines(tmp_path):
    """A re-formed generation's stand-bys start at its ``first_step``:
    the watch sees only that generation's record, and only once its line
    is whole."""
    import json

    path = tmp_path / "j.jsonl"
    watch = launch_mod._FirstStepWatch(str(path), 1)
    assert not watch.seen()  # no journal yet
    rec = {"event": "first_step", "gen": 0, "step": 1}
    path.write_text(json.dumps(rec) + "\n")
    assert not watch.seen()
    line = json.dumps(dict(rec, gen=1))
    with open(path, "a") as f:
        f.write(line[:10])
    assert not watch.seen()  # a torn line waits
    with open(path, "a") as f:
        f.write(line[10:] + "\n")
    assert watch.seen()


def test_exit_status_normalization():
    assert launch_mod._normalize_rc(-9) == 137
    assert launch_mod._normalize_rc(3) == 3
    assert "killed by SIGKILL" in launch_mod._describe_exit("p1", -9)
    assert launch_mod._describe_exit("p0", 2) == "p0 exited rc=2"
