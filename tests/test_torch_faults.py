"""The port's fault plans and injectors (`faults/plan.py`,
`faults/inject.py`) and its restart supervisor (`cli/launch.py`) on the
CPU, as the reference's tests/test_faults.py drives its own.

Against the JAX package: the same plan JSON round-trips identically
through both `FaultPlan`s and fires at the same steps in both packages'
injectors, and the port's `bench --faults` clean MLP run stays within
1e-5 per step of the reference bench's clean run from one init. The
port alone: a preemption with its checkpoint corrupted and an input
stall recovers to the clean trajectory bit for bit (blocking saves and
the write-behind snapshotter), the corrupted step is quarantined and
restore falls back without raising, the stall shim keeps the stream's
contract, `cli.train --fault_plan` ends with the clean run's ``done:``
line, the supervisor's restart ladder with stub children (restart,
give up with the child's status, fail fast, chaos kill, the chief's
death fatal), one real two-rank `cli.launch --max_restarts=1` run whose
chaos kill lands and whose restart completes, and `bench --faults
[--async-save]`'s JSON lines.
"""

from __future__ import annotations

import contextlib
import io
import json
import re
import sys
import tempfile
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from dist_mnist_tpu.faults import plan as jplan
from dist_mnist_tpu_torch import bench
from dist_mnist_tpu_torch.checkpoint import CheckpointManager
from dist_mnist_tpu_torch.cli import launch as launch_mod
from dist_mnist_tpu_torch.cli import train as train_cli
from dist_mnist_tpu_torch.data import datasets
from dist_mnist_tpu_torch.faults import (
    Fault,
    FaultPlan,
    FaultyBatches,
    FaultyStepFn,
)
from dist_mnist_tpu_torch.faults.inject import _corrupt_step_dir
from dist_mnist_tpu_torch.train.loop import PreemptionError

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
    """No snapshot writer, kill timer or launcher child outlives a test,
    no peer temp file stays pending, no supervisor temp dir is left."""
    root = Path(tempfile.gettempdir())
    before = set(root.glob("dist_mnist_torch_supervisor_*"))
    yield
    left = cases.wait_unleaked(root, before)
    assert left == [], f"leaked: {left}"


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory) -> str:
    """A small MNIST twin (2,048 train / 256 test) both packages read."""
    path = tmp_path_factory.mktemp("mnist-data")
    datasets._write_synth_cache(path, "mnist",
                                datasets._synth("mnist", 2048, 256, 0))
    return str(path)


# -- plans: the same JSON, the same firing steps in both packages ---------

PLANS = [
    {"seed": 3, "faults": [{"kind": "preempt", "step": 8},
                           {"kind": "corrupt_checkpoint", "step": 6},
                           {"kind": "stall_input", "step": 2,
                            "seconds": 0.01}]},
    {"seed": 0, "faults": [{"kind": "kill_process", "process": 1,
                            "after_s": 5.0},
                           {"kind": "kill_host", "process": 1, "step": 35,
                            "recover_after_s": 2.5}]},
    {"seed": 0, "faults": [{"kind": "corrupt_checkpoint", "step": 4,
                            "mode": "delete"},
                           {"kind": "serve_error", "request": 2},
                           {"kind": "serve_replica_kill", "replica": 1},
                           {"kind": "serve_replica_stall", "replica": 0,
                            "seconds": 0.5, "request": 3}]},
    {"seed": 1, "faults": [{"kind": "preempt", "step": 3},
                           {"kind": "preempt", "step": 5}]},
]


@pytest.mark.parametrize("obj", PLANS, ids=range(len(PLANS)))
def test_plan_json_round_trips_as_the_reference(obj, tmp_path):
    text = json.dumps(obj)
    ours, theirs = FaultPlan.from_json(text), jplan.FaultPlan.from_json(text)
    assert ours.to_json() == theirs.to_json()
    assert FaultPlan.from_json(ours.to_json()).to_json() == ours.to_json()
    (tmp_path / "plan.json").write_text(text)
    assert FaultPlan.from_spec(str(tmp_path / "plan.json")).to_json() \
        == theirs.to_json()
    assert ours.kill_spec() == theirs.kill_spec()
    assert ours.host_kill_spec() == theirs.host_kill_spec()
    for kind in jplan.KINDS:
        assert ([f.to_dict() for f in ours.pending(kind)]
                == [f.to_dict() for f in theirs.pending(kind)])


def test_plan_module_is_a_copy_of_the_reference():
    ours = (ROOT / "dist_mnist_tpu_torch/faults/plan.py").read_text()
    theirs = (ROOT / "dist_mnist_tpu/faults/plan.py").read_text()
    assert ours == theirs.replace("from dist_mnist_tpu.faults.inject",
                                  "from dist_mnist_tpu_torch.faults.inject")
    assert tuple(jplan.KINDS) == tuple(sys.modules[
        FaultPlan.__module__].KINDS)


def test_unknown_fault_kind_rejected():
    with pytest.raises(ValueError, match="unknown fault kind"):
        Fault("meteor_strike")


def test_wiring_helpers_are_noops_without_matching_faults():
    plan = FaultPlan([Fault.preempt(3)])
    sentinel = object()
    assert plan.wrap_batches(sentinel) is sentinel
    assert plan.wrap_checkpoint_manager(sentinel) is sentinel
    assert plan.wrap_checkpoint_manager(None) is None
    assert plan.wrap_engine(sentinel) is sentinel


def _fire_steps(plan, hook_cls, error_cls, steps):
    """The loop steps at which `hook_cls(plan)` raises a preemption."""
    hook, fired = hook_cls(plan), []
    for step in steps:
        try:
            hook.before_step(step)
        except error_cls:
            fired.append(step)
    return fired


@pytest.mark.parametrize("obj", [PLANS[0], PLANS[3]], ids=["chain", "two"])
def test_plans_fire_at_the_same_steps_as_the_reference(obj):
    from dist_mnist_tpu.faults import inject as jinject
    from dist_mnist_tpu.train.loop import PreemptionError as JPreemption

    from dist_mnist_tpu_torch.faults.inject import FaultInjectionHook

    text = json.dumps(obj)
    # a replay: steps run forward, then again from an earlier step
    steps = [*range(0, 10), *range(4, 12)]
    ours = _fire_steps(FaultPlan.from_json(text), FaultInjectionHook,
                       PreemptionError, steps)
    theirs = _fire_steps(jplan.FaultPlan.from_json(text),
                         jinject.FaultInjectionHook, JPreemption, steps)
    assert ours == theirs and ours
    # the stall shim: the same items, a stall at the same step, once
    plans = FaultPlan.from_json(text), jplan.FaultPlan.from_json(text)
    got = [list(cls(_ListBatches(list(range(6))), p))
           for cls, p in ((FaultyBatches, plans[0]),
                          (jinject.FaultyBatches, plans[1]))]
    assert got[0] == got[1] == list(range(6))
    assert ([f.fired for f in plans[0].faults]
            == [f.fired for f in plans[1].faults])


def test_faulty_step_fn_counts_calls():
    plan = FaultPlan([Fault.preempt(2)])
    fn = FaultyStepFn(lambda s, b: (s + 1, {}), plan)
    state = 0
    for _ in range(2):
        state, _ = fn(state, None)
    with pytest.raises(PreemptionError, match="step call 2"):
        fn(state, None)
    assert plan.faults[0].fired
    assert fn(state, None)[0] == 3  # latched: no second raise


# -- the stall shim -------------------------------------------------------

class _ListBatches:
    def __init__(self, items, start=0):
        self.items = items
        self.start = start

    def at_step(self, step):
        return _ListBatches(self.items, start=step)

    def __iter__(self):
        return iter(self.items[self.start:])


def test_faulty_batches_stalls_then_delegates():
    plan = FaultPlan([Fault.stall_input(1, 0.05)])
    fb = FaultyBatches(_ListBatches([10, 11, 12]), plan)
    t0 = time.monotonic()
    assert list(fb) == [10, 11, 12]
    assert time.monotonic() - t0 >= 0.05
    assert plan.faults[0].fired
    t0 = time.monotonic()
    assert list(fb) == [10, 11, 12]
    assert time.monotonic() - t0 < 0.05


def test_faulty_batches_reseek_preserves_wrapper():
    plan = FaultPlan([Fault.stall_input(99, 0.01)])
    fb = FaultyBatches(_ListBatches([10, 11, 12]), plan)
    fb2 = fb.at_step(2)
    assert isinstance(fb2, FaultyBatches)
    assert list(fb2) == [12]
    assert fb2._plan is plan


# -- corruption and the store's fallback ladder ---------------------------

@pytest.mark.parametrize("mode", ["truncate", "delete"])
def test_corrupted_latest_is_quarantined_and_restore_falls_back(
        tmp_path, mode):
    from dist_mnist_tpu_torch.checkpoint import fork_state

    ds = datasets.load_dataset("mnist", "/nonexistent", seed=0,
                               synthetic_sizes=(64, 16),
                               cache_synthetic=False)
    state = bench.faults_state(torch.device("cpu"), ds)
    mgr = CheckpointManager(tmp_path, async_save=False)
    for step in (3, 6):
        s = fork_state(state)
        s.step = torch.tensor(step, dtype=torch.int32)
        s.params["hid"]["b"].add_(step)
        assert mgr.save(s)
    damaged = _corrupt_step_dir(tmp_path / "6", mode=mode)
    assert damaged == tmp_path / "6" / "state.pt"  # the largest file
    restored = mgr.restore(state)  # falls back, never raises
    assert restored.step_int == 3
    assert torch.equal(restored.params["hid"]["b"],
                       state.params["hid"]["b"] + 3)
    assert (tmp_path / "quarantine" / "step_6").exists()
    assert mgr.latest_step() == 3
    mgr.close()


# -- trajectories: recovered == clean, bit for bit -----------------------

@pytest.fixture(scope="module")
def small(data_dir):
    ds = datasets.load_dataset("mnist", data_dir, seed=0)
    return ds, bench.faults_state(torch.device("cpu"), ds)


@pytest.fixture(scope="module")
def clean12(small):
    ds, state0 = small
    return bench.faults_run(torch.device("cpu"), ds, state0, n_steps=12,
                            batch=64, ckpt_every=3)["loss"]


@pytest.mark.parametrize("async_save", [False, True], ids=["sync", "async"])
def test_preempt_corrupt_stall_chain_recovers_bit_for_bit(
        small, clean12, tmp_path, async_save):
    """The chain: a preemption at 8, the checkpoint it wants (6)
    corrupted, an input stall: restore quarantines 6, falls back to 3,
    replays 5 steps, and the losses equal the clean run's bit for bit."""
    ds, state0 = small
    ckpt = tmp_path / "ckpt"
    plan = FaultPlan([Fault.preempt(8), Fault.corrupt_checkpoint(6),
                      Fault.stall_input(2, 0.05)])
    run = bench.faults_run(torch.device("cpu"), ds, state0, n_steps=12,
                           batch=64, ckpt_every=3, plan=plan,
                           ckpt_dir=str(ckpt), async_save=async_save)
    assert bench.same_trajectory(clean12, run["loss"])
    assert sorted(f.kind for f in plan.fired()) == [
        "corrupt_checkpoint", "preempt", "stall_input"]
    assert (ckpt / "quarantine" / "step_6").exists()
    assert (ckpt / "6").exists()  # the replay saved step 6 again
    snap = run["loop"].goodput.snapshot()
    assert snap["recoveries"] == 1 and snap["replayed_steps"] == 5
    assert snap["stall_s"] >= 0.05
    (ev,) = run["loop"].goodput.events
    assert ev["restored_step"] == 3 and ev["failed_at_step"] == 8


def test_clean_run_matches_the_reference_bench_from_one_init(small, mesh1,
                                                             data_dir):
    """The reference's `bench --faults` clean run (its MLP, Adam 1e-3,
    its batcher at batch 256) and the port's, from one init on one
    dataset: per-step losses within 1e-5."""
    import jax

    from dist_mnist_tpu import hooks as jhooks
    from dist_mnist_tpu import optim as joptim
    from dist_mnist_tpu.cluster.mesh import activate
    from dist_mnist_tpu.data import ShardedBatcher as JBatcher
    from dist_mnist_tpu.data import load_dataset as jload
    from dist_mnist_tpu.models import get_model as jget_model
    from dist_mnist_tpu.parallel.sharding import shard_train_state
    from dist_mnist_tpu.train import TrainLoop as JLoop
    from dist_mnist_tpu.train import create_train_state as jcreate
    from dist_mnist_tpu.train.step import make_train_step as jstep

    from dist_mnist_tpu_torch.convert import train_state_from_jax

    steps = 60
    jds = jload("mnist", data_dir, seed=0)
    ds, _ = small
    assert np.array_equal(jds.train_images, ds.train_images)

    class _JTraj:
        def __init__(self):
            self.loss = {}

        def begin(self, loop):
            pass

        def before_step(self, step):
            pass

        def after_step(self, step, state, outputs):
            self.loss[step] = outputs["loss"]

        def end(self, state):
            self.loss = {k: float(np.asarray(jax.device_get(v)))
                         for k, v in self.loss.items()}

    with activate(mesh1):
        model, opt = jget_model("mlp"), joptim.adam(1e-3)
        jstate = shard_train_state(jcreate(model, opt, jax.random.PRNGKey(0),
                                           jds.train_images[:1]), mesh1)
        traj = _JTraj()
        JLoop(jstep(model, opt, mesh1, donate=False), jstate,
              JBatcher(jds, 256, mesh1, seed=0),
              [jhooks.StopAtStepHook(last_step=steps), traj]).run()
    start = train_state_from_jax(jax.device_get(jstate), seed=0)
    ours = bench.faults_run(torch.device("cpu"), ds, start, n_steps=steps)
    got = [float(ours["loss"][s]) for s in sorted(ours["loss"])]
    want = [traj.loss[s] for s in sorted(traj.loss)]
    assert len(got) == len(want) == steps
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# -- the training CLI ------------------------------------------------------

def test_cli_fault_plan_ends_with_the_clean_runs_result(tmp_path, data_dir,
                                                        caplog):
    plan = json.dumps({"faults": [
        {"kind": "preempt", "step": 20},
        {"kind": "corrupt_checkpoint", "step": 20},
        {"kind": "stall_input", "step": 3, "seconds": 0.05}]})
    common = ["--device=cpu", "--config=mlp_mnist", f"--data_dir={data_dir}",
              "--train_steps=30", "--eval_every=0", "--log_every=10"]
    clean, clean_final, _ = train_cli.main(common)
    with caplog.at_level("INFO"):
        state, final, ctx = train_cli.main(
            common + [f"--checkpoint_dir={tmp_path / 'ck'}",
                      "--checkpoint_every_steps=5",
                      "--max_restore_fallbacks=2", f"--fault_plan={plan}"])
    assert state.step_int == 30
    assert (final["accuracy"], final["loss"]) == (clean_final["accuracy"],
                                                  clean_final["loss"])
    done = [r.getMessage() for r in caplog.records
            if r.getMessage().startswith("done:")]
    assert done and "step=30" in done[-1]
    assert "fault injected: preemption at step 20" in caplog.text
    assert "falling back to step 15" in caplog.text
    assert (tmp_path / "ck" / "quarantine" / "step_20").exists()
    assert ctx["loop"].goodput.snapshot()["recoveries"] == 1
    for a, b in zip(cases.full_numpy(state)["params"]["hid"].values(),
                    cases.full_numpy(clean)["params"]["hid"].values()):
        assert a.tobytes() == b.tobytes()


def test_cli_refuses_a_bad_plan():
    with pytest.raises(SystemExit, match="error: .*fault kind"):
        train_cli.main(["--device=cpu", '--fault_plan={"faults": '
                        '[{"kind": "meteor"}]}'])
    with pytest.raises(SystemExit, match="error: "):
        train_cli.main(["--device=cpu", "--fault_plan=/no/such/plan.json"])


# -- the supervisor: the restart ladder with stub children ----------------

STUB_CHILD = textwrap.dedent("""\
    import os, sys, time

    args = dict(a.split("=", 1) for a in sys.argv[1:]
                if a.startswith("--") and "=" in a)
    pid = int(args.get("--process_id", "0"))
    mode = args.get("--stub_mode", "ok")
    if pid == 0:
        chief_rc = int(args.get("--stub_chief_rc", "0"))
        time.sleep(float(args.get("--stub_chief_sleep", "0.5")))
        sys.exit(chief_rc)
    if mode == "fail_once":
        marker = args["--stub_marker"]
        if not os.path.exists(marker):
            open(marker, "w").close()
            sys.exit(3)
        sys.exit(0)
    if mode == "fail_always":
        sys.exit(7)
    time.sleep(float(args.get("--stub_sleep", "0")))
    sys.exit(0)
""")


@pytest.fixture()
def stub_child(tmp_path):
    """A child program with no torch, so the supervisor's semantics
    (restart, backoff, exit codes, kill injection) take about a second."""
    path = tmp_path / "stub_child.py"
    path.write_text(STUB_CHILD)
    return [sys.executable, str(path)]


def _supervise(stub_child, train_args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = launch_mod.launch(2, train_args, platform="cpu",
                               child_command=stub_child,
                               restart_backoff_s=0.05, **kw)
    return rc, buf.getvalue()


def test_supervisor_restarts_failed_worker(stub_child, tmp_path):
    rc, log = _supervise(
        stub_child,
        ["--stub_mode=fail_once", f"--stub_marker={tmp_path / 'marker'}"],
        max_restarts=2)
    assert rc == 0, log
    assert "p1 exited rc=3" in log
    assert "restarting cluster (attempt 1/2)" in log


def test_supervisor_gives_up_with_childs_rc(stub_child):
    rc, log = _supervise(stub_child, ["--stub_mode=fail_always"],
                         max_restarts=1)
    assert rc == 7, log
    assert "p1 exited rc=7" in log
    assert "giving up after 1 restart(s)" in log


def test_supervisor_fail_fast_without_restarts(stub_child):
    rc, log = _supervise(stub_child, ["--stub_mode=fail_always"],
                         max_restarts=0)
    assert rc == 7, log
    assert "restarting" not in log


def test_supervisor_kill_injection_then_clean_restart(stub_child, tmp_path):
    journal = tmp_path / "journal.jsonl"
    rc, log = _supervise(
        stub_child,
        ["--stub_mode=sleep", "--stub_sleep=2.0", "--stub_chief_sleep=2.0"],
        max_restarts=1, kill_spec=(1, 0.3), journal=str(journal))
    assert rc == 0, log
    assert "fault injected: SIGKILL p1" in log
    assert "p1 exited rc=137 (killed by SIGKILL)" in log
    assert "restarting cluster (attempt 1/1)" in log
    names = [json.loads(line)["event"]
             for line in journal.read_text().splitlines()]
    assert names == ["supervisor_start", "generation_start",
                     "fault_injected", "generation_end",
                     "supervisor_restart", "generation_start",
                     "generation_end", "supervisor_stop"]


def test_supervisor_chief_death_is_fatal(stub_child):
    rc, log = _supervise(
        stub_child,
        ["--stub_chief_rc=5", "--stub_chief_sleep=0.1", "--stub_mode=sleep",
         "--stub_sleep=2.0"],
        max_restarts=3)
    assert rc == 5, log
    assert "chief died" in log
    assert "restarting cluster" not in log


# -- one real two-rank launch: the chaos kill lands, the restart finishes --

def test_launch_kill_process_restarts_and_completes(data_dir, tmp_path):
    """`cli.launch --max_restarts=1 --fault_plan=<kill_process p1 after
    1 s>`: the kill lands while the children start (their torch import
    alone takes longer), the supervisor restarts the world once, and both
    ranks finish every step with equal results. The plan reaches the
    children too (they ignore the kinds they do not consume)."""
    plan = FaultPlan([Fault.kill_process(1, after_s=1.0)]).to_json()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = launch_mod.main([
            "--num_processes=2", "--platform=cpu", "--max_restarts=1",
            "--restart_backoff_s=0.2", f"--fault_plan={plan}", "--",
            "--config=mlp_mnist", f"--data_dir={data_dir}",
            f"--checkpoint_dir={tmp_path / 'ckpt'}", "--train_steps=6",
            "--batch_size=32", "--eval_every=0", "--log_every=2"])
    log = buf.getvalue()
    assert rc == 0, log[-3000:]
    assert "fault injected: SIGKILL p1 after 1.0s" in log
    assert "p1 exited rc=137" in log
    assert "restarting cluster (attempt 1/1)" in log
    finals = re.findall(r"\[p(\d)\].*done: step=(\d+) test_acc=([0-9.]+)",
                        log)
    assert sorted(f[0] for f in finals) == ["0", "1"], log[-3000:]
    assert all(f[1] == "6" for f in finals), finals
    assert finals[0][2] == finals[1][2], finals


# -- the bench --------------------------------------------------------------

@pytest.mark.parametrize("flags", [[], ["--async-save"]],
                         ids=["sync", "async"])
def test_bench_faults_prints_its_line_and_holds_its_gates(flags, data_dir,
                                                          capsys):
    record = bench.main(["--faults", *flags, "--device=cpu",
                         f"--data_dir={data_dir}"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == json.loads(json.dumps(record))
    assert record["metric"] == "recovery_latency_ms" and record["value"] > 0
    extra = record["extra"]
    assert extra["trajectory_identical"] is True
    assert extra["faults_fired"] == ["preempt", "corrupt_checkpoint"]
    assert extra["recoveries"] == extra["journal_restores"] == 1
    assert extra["replayed_steps"] == 10  # fell back from 40 to 30
    assert extra["async_save"] is bool(flags)
    # the fault run carried the obs stack: the scraper reached it live
    fleet = extra["fleet"]
    assert fleet["host_reachable"] is True and fleet["scrapes"] >= 1
    assert fleet["scrape_errors"] == 0 and fleet["anomalies"] >= 0


def test_bench_refuses_mixed_modes():
    for argv in (["--async-save"], ["--elastic"], ["--faults", "--ckpt"],
                 ["--faults", "--serve"], ["--faults", "--elastic",
                                           "--async-save"]):
        with pytest.raises(SystemExit, match="error: "):
            bench.main([*argv, "--device=cpu"])
