"""The port's elastic membership and supervisor (`cluster/membership.py`,
`configs.apply_elastic_policy`, `cli/launch.py --elastic`) on the CPU,
as the reference's tests/test_elastic.py drives its own.

Against the JAX package: `membership.py` is a byte copy, and one
fail/restore/due sequence gives both packages' `Membership` the same
alive lists, ranks and deadlines; `apply_elastic_policy` agrees on
every policy and size; a kill_host plan gives both the same specs. The
port alone: the kill_host injector (the victim only, generation 0 only),
the coordinator-port bind retry, the elastic supervisor's ladder with
stub children (shrink at once, grow back through a drain, the chief's
death and the min_processes floor fatal), the injected
``--elastic_baseline_devices``, the supervisor's own temp dir, one real
two-rank `cli.launch --elastic` run that shrinks on a planned host loss,
finishes and grows back, and `bench --faults --elastic`'s JSON line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import errno
import io
import json
import os
import re
import socket
import sys
import tempfile
import textwrap
from pathlib import Path

import pytest

from dist_mnist_tpu import configs as jconfigs
from dist_mnist_tpu.cluster import membership as jmembership
from dist_mnist_tpu.faults import plan as jplan
from dist_mnist_tpu_torch import bench
from dist_mnist_tpu_torch.cli import launch as launch_mod
from dist_mnist_tpu_torch.cluster.membership import (
    ENV_ALIVE_HOSTS,
    ENV_HOST_ID,
    Membership,
)
from dist_mnist_tpu_torch.configs import (
    ELASTIC_BATCH_POLICIES,
    apply_elastic_policy,
    get_config,
)
from dist_mnist_tpu_torch.data import datasets
from dist_mnist_tpu_torch.faults import Fault, FaultPlan
from dist_mnist_tpu_torch.obs import events

import torch_resilience_cases as cases

ROOT = Path(__file__).resolve().parents[1]


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
def _no_resilience_leaks():
    """No grow timer, kill timer or launcher child outlives a test, no
    supervisor temp dir is left."""
    root = Path(tempfile.gettempdir())
    before = set(root.glob("dist_mnist_torch_supervisor_*"))
    yield
    left = cases.wait_unleaked(root, before)
    assert left == [], f"leaked: {left}"


# -- membership: a copy, and the same answers ----------------------------

def test_membership_module_is_a_copy_of_the_reference():
    ours = (ROOT / "dist_mnist_tpu_torch/cluster/membership.py").read_bytes()
    assert ours == (ROOT / "dist_mnist_tpu/cluster/membership.py").read_bytes()
    assert (ENV_HOST_ID, ENV_ALIVE_HOSTS) == (jmembership.ENV_HOST_ID,
                                              jmembership.ENV_ALIVE_HOSTS)
    assert ENV_HOST_ID == events.ENV_HOST_ID


#: (op, host, now, recover_after_s) sequences
SEQUENCES = [
    [("fail", 2, 100.0, None), ("restore", 2, 0.0, None)],
    [("fail", 1, 10.0, 5.0), ("fail", 2, 10.0, None), ("due", 0, 14.9, None),
     ("due", 0, 15.0, None), ("restore_due", 0, 15.0, None),
     ("due", 0, 1e9, None)],
    [("fail", 3, 0.0, 1.0), ("fail", 1, 0.5, 0.25), ("restore_due", 0, 0.8,
                                                       None),
     ("fail", 1, 1.0, None), ("restore_due", 0, 2.0, None),
     ("restore", 1, 0.0, None)],
]


def _replay(cls, n, seq):
    m, out = cls(n), []
    for op, host, now, recover in seq:
        if op == "fail":
            m.fail(host, now=now, recover_after_s=recover)
        elif op == "restore":
            m.restore(host)
        elif op == "due":
            out.append(("due", m.due(now)))
        else:
            out.append(("restored", m.restore_due(now)))
        out.append((m.alive(), m.world_size,
                    [m.rank_of(h) for h in range(n)],
                    [m.is_alive(h) for h in range(-1, n + 1)],
                    m.next_recovery_in(now)))
    return out


@pytest.mark.parametrize("seq", SEQUENCES, ids=range(len(SEQUENCES)))
def test_membership_answers_as_the_reference(seq):
    assert _replay(Membership, 4, seq) == _replay(jmembership.Membership, 4,
                                                  seq)


def test_membership_chief_and_range_guards():
    m = Membership(2)
    with pytest.raises(ValueError, match="chief"):
        m.fail(0, now=0.0)
    with pytest.raises(ValueError, match="out of range"):
        m.fail(2, now=0.0)
    with pytest.raises(ValueError):
        Membership(0)


# -- kill_host: the plan and its injector ---------------------------------

def test_kill_host_plan_roundtrip_and_specs():
    plan = FaultPlan([Fault.kill_host(1, step=35, recover_after_s=2.5)])
    again = FaultPlan.from_spec(plan.to_json())
    f = again.faults[0]
    assert (f.kind, f.process, f.step, f.recover_after_s) == (
        "kill_host", 1, 35, 2.5)
    assert again.host_kill_spec() == (1, 2.5) == jplan.FaultPlan.from_spec(
        plan.to_json()).host_kill_spec()
    assert again.kill_spec() is None
    timer = FaultPlan([Fault.kill_process(1, after_s=5.0)])
    assert timer.kill_spec() == (1, 5.0)
    assert timer.host_kill_spec() is None
    assert FaultPlan([Fault.kill_host(2, step=10)]).host_kill_spec() == (
        2, None)


def test_kill_host_latches_without_killing_in_later_generations(monkeypatch):
    monkeypatch.setenv(events.ENV_GENERATION, "1")
    plan = FaultPlan([Fault.kill_host(0, step=3)])
    plan.hook().before_step(5)  # the victim IS this process, but gen != 0
    assert plan.faults[0].fired  # latched: a replay cannot lose it again


def test_kill_host_ignores_non_victim_process():
    plan = FaultPlan([Fault.kill_host(1, step=3)])  # this process is rank 0
    plan.hook().before_step(5)
    assert not plan.faults[0].fired


# -- the batch policy -------------------------------------------------------

@pytest.mark.parametrize("policy", [*ELASTIC_BATCH_POLICIES, "yolo"])
@pytest.mark.parametrize("baseline,current", [(8, 4), (8, 8), (0, 4),
                                              (2, 1), (4, 2), (1, 2)])
def test_apply_elastic_policy_agrees_with_the_reference(policy, baseline,
                                                        current):
    assert ELASTIC_BATCH_POLICIES == jconfigs.ELASTIC_BATCH_POLICIES
    ours = dataclasses.replace(get_config("mlp_mnist"),
                               elastic_batch_policy=policy)
    theirs = dataclasses.replace(jconfigs.get_config("mlp_mnist"),
                                 elastic_batch_policy=policy)
    if policy not in ELASTIC_BATCH_POLICIES:
        for fn, cfg in ((apply_elastic_policy, ours),
                        (jconfigs.apply_elastic_policy, theirs)):
            with pytest.raises(ValueError, match="elastic_batch_policy"):
                fn(cfg, baseline, current)
        return
    a = apply_elastic_policy(ours, baseline, current)
    b = jconfigs.apply_elastic_policy(theirs, baseline, current)
    assert (a.batch_size, a.learning_rate) == (b.batch_size, b.learning_rate)
    assert (a is ours) == (b is theirs)


# -- the coordinator port's bind retry ------------------------------------

def test_reserve_port_retries_transient_bind_failures(monkeypatch):
    real_socket = socket.socket
    fails = {"n": 3}

    class FlakySocket(real_socket):
        def bind(self, addr):
            if fails["n"] > 0:
                fails["n"] -= 1
                raise OSError(errno.EADDRINUSE, "Address already in use")
            return super().bind(addr)

    monkeypatch.setattr(launch_mod.socket, "socket", FlakySocket)
    port, probe, lock = launch_mod._reserve_port()
    try:
        assert port > 0 and fails["n"] == 0
    finally:
        probe.close()
        lock.unlink()


def test_reserve_port_exhaustion_raises_os_error(monkeypatch):
    class DeadSocket(socket.socket):
        def bind(self, addr):
            raise OSError(errno.EADDRNOTAVAIL, "Cannot assign")

    monkeypatch.setattr(launch_mod.socket, "socket", DeadSocket)
    with pytest.raises(OSError, match="after 32 attempts"):
        launch_mod._reserve_port()


# -- the elastic supervisor with stub children -----------------------------

# A child with no torch: logs its generation/host/rank/world (and the
# journal it was given) to a shared file, takes SIGTERM as the graceful
# handshake (exit 0), and sleeps per generation (`--stub_sleep_g<N>`).
ELASTIC_STUB = textwrap.dedent("""\
    import os, signal, sys, time

    signal.signal(signal.SIGTERM, lambda *a: sys.exit(0))
    args = dict(a.split("=", 1) for a in sys.argv[1:]
                if a.startswith("--") and "=" in a)
    gen = os.environ.get("DIST_MNIST_TPU_GENERATION", "0")
    host = os.environ.get("DIST_MNIST_TPU_HOST_ID", "?")
    alive = os.environ.get("DIST_MNIST_TPU_ALIVE_HOSTS", "?")
    journal = os.environ.get("DIST_MNIST_TPU_JOURNAL", "none")
    with open(args["--stub_log"], "a") as f:
        f.write(f"gen={gen} host={host} rank={args['--process_id']} "
                f"world={args['--num_processes']} alive={alive} "
                f"journal={journal}\\n")
    time.sleep(float(args.get(f"--stub_sleep_g{gen}", "0")))
    sys.exit(0)
""")


@pytest.fixture()
def elastic_stub(tmp_path):
    path = tmp_path / "elastic_stub.py"
    path.write_text(ELASTIC_STUB)
    return [sys.executable, str(path)]


def _supervise_elastic(n, elastic_stub, train_args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = launch_mod.launch(n, train_args, platform="cpu",
                               child_command=elastic_stub,
                               restart_backoff_s=0.05, elastic=True, **kw)
    return rc, buf.getvalue()


def _stub_lines(log_path):
    return [dict(kv.split("=", 1) for kv in line.split())
            for line in log_path.read_text().splitlines()]


def _records(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_elastic_shrink_reforms_at_surviving_world(elastic_stub, tmp_path):
    """Kill host 1 of 3: the next generation launches hosts {0, 2} as
    ranks {0, 1}, at once, with no full-world restart."""
    stub_log, jpath = tmp_path / "stub.log", tmp_path / "journal.jsonl"
    rc, log = _supervise_elastic(
        3, elastic_stub, [f"--stub_log={stub_log}", "--stub_sleep_g0=5.0"],
        kill_spec=(1, 0.3), journal=str(jpath))
    assert rc == 0, log
    assert "p1 exited rc=137 (killed by SIGKILL)" in log
    assert "generation resized 3 -> 2 (shrink: host 1 out)" in log
    assert "no backoff" in log
    assert "restarting cluster" not in log
    gen1 = [line for line in _stub_lines(stub_log) if line["gen"] == "1"]
    assert sorted((x["host"], x["rank"], x["world"], x["alive"])
                  for x in gen1) == [("0", "0", "2", "0,2"),
                                     ("2", "1", "2", "0,2")]
    records = _records(jpath)
    resize = [r for r in records if r["event"] == "generation_resize"]
    assert [(r["kind"], r["old_world"], r["new_world"], r["host"])
            for r in resize] == [("shrink", 3, 2, 1)]
    gen1_start = [r for r in records if r["event"] == "generation_start"
                  and r["gen"] == 1]
    assert gen1_start[0]["world"] == 2 and gen1_start[0]["hosts"] == [0, 2]


def test_elastic_grow_back_after_recovery(elastic_stub, tmp_path):
    """A kill_host with a recovery deadline: shrink 2 -> 1, then the grow
    timer drains the shrunken generation (SIGTERM -> exit 0) and the mesh
    grows back to 2; the grow consumes no restart budget."""
    stub_log, jpath = tmp_path / "stub.log", tmp_path / "journal.jsonl"
    rc, log = _supervise_elastic(
        2, elastic_stub,
        [f"--stub_log={stub_log}", "--stub_sleep_g0=5.0",
         "--stub_sleep_g1=10.0"],
        kill_spec=(1, 0.3), host_kill=(1, 0.9), journal=str(jpath))
    assert rc == 0, log
    assert ("generation resized 2 -> 1 (shrink: host 1 out, recovery in "
            "0.9s)") in log
    assert "host recovery due: draining generation 1" in log
    assert "generation resized 1 -> 2 (grow: host(s) [1] back)" in log
    records = _records(jpath)
    assert [(r["kind"], r["old_world"], r["new_world"]) for r in records
            if r["event"] == "generation_resize"] == [("shrink", 2, 1),
                                                      ("grow", 1, 2)]
    assert any(r["event"] == "grow_drain" for r in records)
    gen2 = [line for line in _stub_lines(stub_log) if line["gen"] == "2"]
    assert sorted(x["host"] for x in gen2) == ["0", "1"]
    (stop,) = [r for r in records if r["event"] == "supervisor_stop"]
    assert stop["rc"] == 0 and stop["restarts"] == 1


def test_elastic_generation_finished_before_its_drain_is_not_grown(
        elastic_stub, tmp_path):
    """The grow drain lands on a generation whose ranks have already
    trained the last step (each journaled an ok, unpreempted
    ``run_stop``): it exits 0 as a drained one does, and the supervisor
    ends the run there instead of growing a generation with nothing left
    to train."""
    stub_log, jpath = tmp_path / "stub.log", tmp_path / "journal.jsonl"
    finished = tmp_path / "finished_stub.py"
    finished.write_text(ELASTIC_STUB.replace(
        "time.sleep(float(", textwrap.dedent("""\
            if gen == "1":
                import json
                with open(journal, "a") as f:
                    f.write(json.dumps({"event": "run_stop", "gen": 1,
                                        "ok": True, "preempted_at": None,
                                        "step": 60}) + "\\n")
            time.sleep(float(""")))
    rc, log = _supervise_elastic(
        2, [sys.executable, str(finished)],
        [f"--stub_log={stub_log}", "--stub_sleep_g0=5.0",
         "--stub_sleep_g1=10.0"],
        kill_spec=(1, 0.3), host_kill=(1, 0.9), journal=str(jpath))
    assert rc == 0, log
    assert "host recovery due: draining generation 1" in log
    assert "generation 1 finished the run before its drain; not growing" \
        in log
    assert "grow" not in [r.get("kind") for r in _records(jpath)]
    assert not [line for line in _stub_lines(stub_log) if line["gen"] == "2"]
    (stop,) = [r for r in _records(jpath) if r["event"] == "supervisor_stop"]
    assert stop["rc"] == 0


def test_elastic_chief_death_still_fatal(elastic_stub, tmp_path):
    rc, log = _supervise_elastic(
        2, elastic_stub,
        [f"--stub_log={tmp_path / 'stub.log'}", "--stub_sleep_g0=5.0"],
        kill_spec=(0, 0.3))
    assert rc == 137, log
    assert "chief died" in log
    assert "generation resized" not in log


def test_elastic_min_processes_floor_is_fatal(elastic_stub, tmp_path):
    rc, log = _supervise_elastic(
        2, elastic_stub,
        [f"--stub_log={tmp_path / 'stub.log'}", "--stub_sleep_g0=5.0"],
        kill_spec=(1, 0.3), min_processes=2)
    assert rc == 137, log
    assert "below min_processes=2" in log
    assert "generation resized" not in log


def test_supervisor_journal_lives_in_its_own_temp_dir(elastic_stub,
                                                      tmp_path):
    """Without --journal a supervised run keeps its journal in a
    ``dist_mnist_torch_supervisor_*`` dir under the temp root, every
    child is given it, and the dir is gone when the run ends."""
    stub_log = tmp_path / "stub.log"
    rc, log = _supervise_elastic(2, elastic_stub,
                                 [f"--stub_log={stub_log}"])
    assert rc == 0, log
    journals = {line["journal"] for line in _stub_lines(stub_log)}
    (journal,) = journals
    parent = Path(journal).parent
    assert parent.name.startswith(launch_mod.SUPERVISOR_DIR_PREFIX)
    assert parent.parent == Path(tempfile.gettempdir())
    assert not parent.exists()


def test_elastic_injects_the_baseline_world(monkeypatch):
    """One device per process: `--elastic` passes the pre-shrink world
    as ``--elastic_baseline_devices=<num_processes>``, unless the train
    flags already name one."""
    seen = []

    def once(world, train_args, **kw):
        seen.append(list(train_args))
        return 0, None, None, False

    monkeypatch.setattr(launch_mod, "_launch_once", once)
    assert launch_mod.launch(3, ["--config=mlp_mnist"], elastic=True,
                             journal=os.devnull) == 0
    assert launch_mod.launch(3, ["--elastic_baseline_devices=8"],
                             elastic=True, journal=os.devnull) == 0
    assert launch_mod.launch(3, ["--config=mlp_mnist"],
                             journal=os.devnull) == 0
    assert seen == [["--config=mlp_mnist", "--elastic_baseline_devices=3"],
                    ["--elastic_baseline_devices=8"], ["--config=mlp_mnist"]]


# -- one real two-rank elastic launch: shrink, finish, grow back ----------

@pytest.fixture(scope="module")
def data_dir(tmp_path_factory) -> str:
    path = tmp_path_factory.mktemp("mnist-data")
    datasets._write_synth_cache(path, "mnist",
                                datasets._synth("mnist", 2048, 256, 0))
    return str(path)


def test_launch_elastic_shrinks_finishes_and_grows_back(data_dir, tmp_path):
    """`cli.launch --elastic` with kill_host(1, step=35,
    recover_after_s=1): host 1 SIGKILLs itself at step 35, the world
    shrinks to host 0 alone, the host's recovery comes due one second
    into that generation, the mesh grows back, and the grown generation
    restores the last checkpoint and finishes every step on both ranks.
    The shrunken rank is a stand-by that imported torch during
    generation 0 and could train the steps left inside that second, so
    an input stall of 2 s at a process's 25th batch (step 25 in
    generation 0, step 55 in generation 1, which restores step 30) holds
    it there and the drain lands while it trains. (That a one-rank
    generation trains to the end is `bench --faults --elastic`'s, below;
    a generation that finished before its drain is not grown: the stub
    test above.)"""
    plan = FaultPlan([Fault.kill_host(1, step=35, recover_after_s=1.0),
                      Fault.stall_input(25, 2.0)])
    jpath = tmp_path / "journal.jsonl"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = launch_mod.main([
            "--num_processes=2", "--platform=cpu", "--elastic",
            f"--journal={jpath}", f"--fault_plan={plan.to_json()}", "--",
            "--config=mlp_mnist", f"--data_dir={data_dir}",
            f"--checkpoint_dir={tmp_path / 'ckpt'}", "--train_steps=60",
            "--batch_size=64", "--eval_every=0", "--log_every=10",
            "--checkpoint_every_steps=10", "--async_snapshot",
            f"--peer_dir={tmp_path / 'peer'}"])
    log = buf.getvalue()
    assert rc == 0, log[-4000:]
    assert "fault injected: kill_host p1 (SIGKILL self) at step 35" in log
    assert "generation resized 2 -> 1 (shrink: host 1 out, recovery in " \
           "1.0s)" in log
    assert "host recovery due: draining generation 1" in log
    assert "generation resized 1 -> 2 (grow: host(s) [1] back)" in log
    records = _records(jpath)
    assert [(r["kind"], r["old_world"], r["new_world"]) for r in records
            if r["event"] == "generation_resize"] == [("shrink", 2, 1),
                                                      ("grow", 1, 2)]
    assert [(r["gen"], r["world"], r["hosts"]) for r in records
            if r["event"] == "generation_start"] == [
        (0, 2, [0, 1]), (1, 1, [0]), (2, 2, [0, 1])]
    assert not [r for r in records if r["event"] == "supervisor_restart"]
    policy = {(r["gen"], r["baseline_devices"], r["devices"])
              for r in records if r["event"] == "elastic_policy"}
    assert {(0, 2, 2), (2, 2, 2)} <= policy
    restored = [r for r in records if r.get("gen") == 2 and r["event"] in (
        "peer_restore", "checkpoint_restore")]
    # the grown generation restored below the last step: it trained
    assert restored and all(30 <= r["step"] < 60 for r in restored)
    finals = [r for r in records if r["event"] == "run_stop"
              and r["gen"] == 2]
    assert sorted(r["process"] for r in finals) == [0, 1]
    assert all(r["ok"] and r["step"] == 60 for r in finals)
    assert len(re.findall(r"done: step=60", log)) == 2


# -- the bench ------------------------------------------------------------

def test_bench_faults_elastic_prints_its_line_and_holds_its_gates(
        data_dir, capsys):
    record = bench.main(["--faults", "--elastic", "--device=cpu",
                         f"--data_dir={data_dir}"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == json.loads(json.dumps(record))
    assert record["metric"] == "elastic_goodput_fraction"
    extra = record["extra"]
    assert extra["elastic"]["resizes"] == [
        {"kind": "shrink", "old_world": 2, "new_world": 1, "host": 1}]
    assert extra["restart_baseline"]["resizes"] == []
    assert extra["elastic"]["final_step"] == extra["restart_baseline"][
        "final_step"] == 60
    assert record["value"] > extra["restart_baseline"]["goodput_fraction"]
    assert record["vs_baseline"] > 1.0
    # the elastic side's fleet trace: a track per host, the shrink's
    # marker, spans on both sides of the resize
    trace = extra["fleet_trace"]
    assert trace["host_tracks"] >= 2 and trace["resize_markers"] >= 1
    assert trace["span_generations"] == [0, 1]
