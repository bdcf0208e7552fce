"""The port's hook lifecycle and TrainLoop (`dist_mnist_tpu_torch.hooks`,
`train/loop.py`): every case of the reference's `tests/test_hooks_loop.py`
against the port, and the same scripted step and hook list run through
both packages' loops, which must make the same (hook, method, step) calls,
across a `PreemptionError` restore too."""

from __future__ import annotations

import itertools
import json
import pickle
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_mnist_tpu import hooks as jhooks
from dist_mnist_tpu.train import loop as jloop
from dist_mnist_tpu.train.state import TrainState as JTrainState
from dist_mnist_tpu_torch.hooks import (
    CheckpointHook,
    EvalHook,
    FinalOpsHook,
    GlobalStepWaiterHook,
    InputPipelineHook,
    LoggingHook,
    MemoryHook,
    MemoryProfileHook,
    NaNGuardHook,
    NanLossError,
    ProfilerHook,
    StepCounterHook,
    StepTimeHook,
    StopAtStepHook,
    SummaryHook,
)
from dist_mnist_tpu_torch.hooks import builtin
from dist_mnist_tpu_torch.hooks.base import EverySteps, Hook
from dist_mnist_tpu_torch.train.loop import PreemptionError, StopSignal, TrainLoop
from dist_mnist_tpu_torch.train.state import TrainState


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


def _state(step=0, params=None):
    return TrainState(
        step=torch.tensor(step, dtype=torch.int32),
        params={} if params is None else params, model_state={},
        opt_state={}, rng=torch.Generator().manual_seed(0))


def _fake_step(state, batch):
    return (
        TrainState(step=state.step + 1, params=state.params,
                   model_state=state.model_state, opt_state=state.opt_state,
                   rng=state.rng),
        {"loss": torch.tensor(batch, dtype=torch.float32)},
    )


def test_stop_at_step():
    loop = TrainLoop(_fake_step, _state(), itertools.repeat(1.0),
                     [StopAtStepHook(last_step=7)])
    final = loop.run()
    assert final.step_int == 7
    assert loop.stop.reason == "reached last step"


def test_stop_num_steps_from_restore():
    """num_steps counts from the restored step (≙ StopAtStepHook:441-447)."""
    loop = TrainLoop(_fake_step, _state(step=10), itertools.repeat(1.0),
                     [StopAtStepHook(num_steps=5)])
    assert loop.run().step_int == 15


def test_steps_per_call_chunked_loop():
    """steps_per_call=K: hooks fire once per chunk at the post-chunk step;
    stop rounds up to the chunk boundary."""
    def chunk_step(state, batch):  # pretends to run 10 steps in one call
        return (TrainState(step=state.step + 10, params=state.params,
                           model_state=state.model_state,
                           opt_state=state.opt_state, rng=state.rng),
                {"loss": torch.tensor(1.0)})

    seen = []

    class Rec(Hook):
        def after_step(self, step, state, outputs):
            seen.append(step)

    loop = TrainLoop(chunk_step, _state(), itertools.repeat(None),
                     [Rec(), StopAtStepHook(last_step=25)],
                     steps_per_call=10)
    final = loop.run()
    assert seen == [10, 20, 30]
    assert final.step_int == 30


def test_data_exhaustion_stops():
    loop = TrainLoop(_fake_step, _state(), iter([1.0, 1.0, 1.0]), [])
    assert loop.run().step_int == 3
    assert loop.stop.reason == "data exhausted"


def test_hook_order_and_lifecycle():
    calls = []

    class Recorder(Hook):
        def begin(self, loop):
            calls.append("begin")

        def before_step(self, step):
            calls.append(f"before{step}")

        def after_step(self, step, state, outputs):
            calls.append(f"after{step}")

        def end(self, state):
            calls.append("end")

    loop = TrainLoop(_fake_step, _state(), iter([1.0, 2.0]), [Recorder()])
    loop.run()
    assert calls == ["begin", "before0", "after1", "before1", "after2", "end"]


def test_nan_guard_raises():
    loop = TrainLoop(_fake_step, _state(), itertools.repeat(float("nan")),
                     [NaNGuardHook(every_steps=1), StopAtStepHook(last_step=10)])
    with pytest.raises(NanLossError):
        loop.run()


def test_nan_guard_stop_mode():
    loop = TrainLoop(_fake_step, _state(), itertools.repeat(float("nan")),
                     [NaNGuardHook(every_steps=1, fail_on_nan=False),
                      StopAtStepHook(last_step=10)])
    final = loop.run()
    assert final.step_int == 1
    assert loop.stop.reason == "non-finite loss"


def test_logging_hook_single_sync_per_cadence(monkeypatch):
    """Every logged key rides ONE batched fetch per cadence: one `.cpu()`
    of all of them, never one `.item()` per key."""
    def multi_metric_step(state, batch):
        state, _ = _fake_step(state, batch)
        return state, {"loss": torch.tensor(0.5), "accuracy": torch.tensor(0.9),
                       "grad_norm": torch.tensor(1.2)}

    loop = TrainLoop(multi_metric_step, _state(), itertools.repeat(1.0),
                     [LoggingHook(every_steps=2), StopAtStepHook(last_step=4)])
    fetches, cpus, items = [], [], []
    real_fetch, real_cpu, real_item = (builtin.fetch, torch.Tensor.cpu,
                                       torch.Tensor.item)
    monkeypatch.setattr(builtin, "fetch",
                        lambda tree: fetches.append(sorted(tree))
                        or real_fetch(tree))
    monkeypatch.setattr(torch.Tensor, "cpu",
                        lambda self, *a, **k: cpus.append(1)
                        or real_cpu(self, *a, **k))
    monkeypatch.setattr(torch.Tensor, "item",
                        lambda self: items.append(1) or real_item(self))
    loop.run()
    assert fetches == [["accuracy", "grad_norm", "loss"]] * 2
    assert len(cpus) == 2  # cadences at steps 2 and 4: one transfer each
    assert items == []


def test_fetch_keeps_values_and_shapes():
    vals = builtin.fetch({"a": torch.tensor(0.25), "b": torch.arange(6.0).view(2, 3),
                          "c": torch.tensor(7, dtype=torch.int32), "d": 1.5})
    assert float(vals["a"]) == 0.25 and float(vals["d"]) == 1.5
    assert vals["b"].shape == (2, 3) and vals["b"][1, 2] == 5.0
    assert int(vals["c"]) == 7
    bf = builtin.fetch({"x": torch.tensor(1 / 3, dtype=torch.bfloat16)})["x"]
    assert float(bf) == float(torch.tensor(1 / 3, dtype=torch.bfloat16))


def test_step_counter_rate():
    hook = StepCounterHook(every_steps=5, batch_size=32)
    loop = TrainLoop(_fake_step, _state(), itertools.repeat(1.0),
                     [hook, StopAtStepHook(last_step=10)])
    loop.run()
    assert hook.last_rate is not None and hook.last_rate > 0


def test_eval_hook_cadence_and_end():
    evals = []
    hook = EvalHook(lambda s: evals.append(s.step_int) or
                    {"loss": 0.0, "accuracy": 1.0}, every_steps=4)
    loop = TrainLoop(_fake_step, _state(), itertools.repeat(1.0),
                     [hook, StopAtStepHook(last_step=10)])
    loop.run()
    assert evals == [4, 8, 10]


def test_every_steps_requires_config():
    with pytest.raises(ValueError):
        EverySteps()


def test_every_steps_crossing_not_aliasing():
    t = EverySteps(every_steps=100)
    t.prime(0)
    fired = [s for s in range(64, 1700, 64) if t.should_trigger(s)]
    assert len(fired) == 16
    assert fired[:3] == [128, 256, 320]
    t2 = EverySteps(every_steps=4)
    t2.prime(0)
    assert [s for s in range(1, 11) if t2.should_trigger(s)] == [4, 8]
    t3 = EverySteps(every_steps=100)
    t3.prime(0)
    assert t3.should_trigger(150)
    t4 = EverySteps(every_steps=100)
    t4.prime(5000)
    assert not t4.should_trigger(5001)
    assert t4.should_trigger(5100)


def test_stop_signal_exception_channel():
    sig = StopSignal()
    sig.request_stop("bad", RuntimeError("boom"))
    assert sig.should_stop()
    with pytest.raises(RuntimeError, match="boom"):
        sig.raise_requested_exception()


class _FlakyStep:
    """Fails with a preemption error on chosen calls (§4 injection)."""

    def __init__(self, fail_at: set[int], step=_fake_step,
                 error=PreemptionError):
        self.calls = 0
        self.fail_at = fail_at
        self.step = step
        self.error = error

    def __call__(self, state, batch):
        self.calls += 1
        if self.calls in self.fail_at:
            raise self.error("fake preemption")
        return self.step(state, batch)


class _MemoryCkpt:
    """In-memory checkpoint manager double."""

    def __init__(self, log=None):
        self.saved = None
        self.log = log

    def save(self, state):
        self.saved = state
        if self.log is not None:
            self.log.append(("manager", "save", state.step_int))

    def restore(self, target):
        if self.log is not None:
            self.log.append(("manager", "restore", self.saved.step_int))
        return self.saved

    def latest_step(self):
        return None if self.saved is None else self.saved.step_int

    def wait(self):
        pass


def test_recoverable_loop_restores_and_continues():
    mgr = _MemoryCkpt()
    state = _state()
    mgr.save(state)
    loop = TrainLoop(_FlakyStep(fail_at={4}), state, itertools.repeat(1.0),
                     [StopAtStepHook(last_step=6)],
                     checkpoint_manager=mgr, max_recoveries=2)
    assert loop.run().step_int == 6
    snap = loop.goodput.snapshot()
    assert snap["recoveries"] == 1 and snap["replayed_steps"] == 3


def test_unrecoverable_without_manager():
    loop = TrainLoop(_FlakyStep(fail_at={2}), _state(), itertools.repeat(1.0),
                     [StopAtStepHook(last_step=6)])
    with pytest.raises(PreemptionError):
        loop.run()


def test_non_preemption_errors_propagate():
    def bad_step(state, batch):
        raise ValueError("logic bug")

    loop = TrainLoop(bad_step, _state(), itertools.repeat(1.0),
                     [StopAtStepHook(last_step=6)],
                     checkpoint_manager=_MemoryCkpt(), max_recoveries=5)
    with pytest.raises(ValueError, match="logic bug"):
        loop.run()


def test_runtime_error_naming_preemption_propagates():
    """The stated departure: only `PreemptionError` is recoverable. A
    RuntimeError whose message names an unavailable or preempted device
    (the reference retries XlaRuntimeErrors like it) propagates."""
    mgr = _MemoryCkpt()
    mgr.save(_state())
    loop = TrainLoop(
        _FlakyStep(fail_at={2}, error=lambda m: RuntimeError(
            "UNAVAILABLE: device preempted")),
        _state(), itertools.repeat(1.0), [StopAtStepHook(last_step=6)],
        checkpoint_manager=mgr, max_recoveries=5)
    with pytest.raises(RuntimeError, match="UNAVAILABLE"):
        loop.run()


def test_stop_hook_no_extra_step_after_restore():
    loop = TrainLoop(_fake_step, _state(step=2000), itertools.repeat(1.0),
                     [StopAtStepHook(last_step=2000)])
    assert loop.run().step_int == 2000
    assert loop.stop.reason == "already at last step"


def test_eval_hook_no_double_eval_when_final_on_cadence():
    evals = []
    hook = EvalHook(lambda s: evals.append(s.step_int) or
                    {"loss": 0.0, "accuracy": 1.0}, every_steps=4)
    loop = TrainLoop(_fake_step, _state(), itertools.repeat(1.0),
                     [hook, StopAtStepHook(last_step=8)])
    loop.run()
    assert evals == [4, 8]


class _FakeMgr:
    """latest_step advances each poll — a trainer job making progress."""

    def __init__(self, steps):
        self._steps = iter(steps)
        self.polls = 0

    def latest_step(self):
        self.polls += 1
        return next(self._steps)


def test_global_step_waiter_blocks_until_step():
    mgr = _FakeMgr([None, 2, 4, 5, 99])
    hook = GlobalStepWaiterHook(5, checkpoint_manager=mgr, poll_secs=0.0)
    TrainLoop(_fake_step, _state(), iter([1.0]), [hook]).run()
    assert mgr.polls == 4


def test_global_step_waiter_passes_if_restored_past():
    mgr = _FakeMgr([])
    hook = GlobalStepWaiterHook(5, checkpoint_manager=mgr, poll_secs=0.0)
    TrainLoop(_fake_step, _state(step=9), iter([1.0]), [hook]).run()
    assert mgr.polls == 0


def test_global_step_waiter_timeout():
    mgr = _FakeMgr(itertools.repeat(1))
    hook = GlobalStepWaiterHook(5, checkpoint_manager=mgr, poll_secs=0.0,
                                timeout_secs=0.05)
    with pytest.raises(TimeoutError):
        TrainLoop(_fake_step, _state(), iter([1.0]), [hook]).run()


def test_final_ops_hook():
    hook = FinalOpsHook(lambda state: state.step_int * 10)
    TrainLoop(_fake_step, _state(), iter([1.0, 1.0]), [hook]).run()
    assert hook.final_result == 20


def test_global_step_waiter_reloads_bare_managers():
    class _BareMgr:
        def __init__(self):
            self._on_disk = None
            self.reloads = 0

        def reload(self):
            self.reloads += 1
            if self.reloads >= 3:
                self._on_disk = 7

        def latest_step(self):
            return self._on_disk

    mgr = _BareMgr()
    hook = GlobalStepWaiterHook(5, checkpoint_manager=mgr, poll_secs=0.0,
                                timeout_secs=5.0)
    TrainLoop(_fake_step, _state(), iter([1.0]), [hook]).run()
    assert mgr.reloads == 3


def test_global_step_waiter_refreshes_the_port_manager(tmp_path):
    """The port's CheckpointManager takes `latest_step(refresh=True)`, and
    sees a step another manager committed after it was opened."""
    from dist_mnist_tpu_torch.checkpoint import CheckpointManager

    reader = CheckpointManager(tmp_path / "ck", async_save=False)
    writer = CheckpointManager(tmp_path / "ck", async_save=False)
    writer.save(_state(step=6))
    hook = GlobalStepWaiterHook(5, checkpoint_manager=reader, poll_secs=0.0,
                                timeout_secs=5.0)
    TrainLoop(_fake_step, _state(), iter([1.0]), [hook]).run()
    assert reader.latest_step(refresh=True) == 6


class _RecWriter:
    def __init__(self):
        self.scalars = []
        self.hists = []

    def scalar(self, tag, value, step):
        self.scalars.append((step, tag, value))

    def histogram(self, tag, values, step):
        self.hists.append((step, tag, int(np.asarray(values).size)))

    def flush(self):
        pass


def test_summary_hook_histograms_array_outputs():
    def step_with_vec(state, batch):
        new, out = _fake_step(state, batch)
        out["grad_norms"] = torch.arange(5.0)
        return new, out

    w = _RecWriter()
    TrainLoop(step_with_vec, _state(), itertools.repeat(1.0),
              [SummaryHook(w, every_steps=2),
               StopAtStepHook(last_step=4)]).run()
    assert [(s, t) for s, t, _ in w.scalars] == [(2, "loss"), (4, "loss")]
    assert w.hists == [(2, "grad_norms", 5), (4, "grad_norms", 5)]


def test_summary_hook_degrades_for_scalar_only_writer():
    class OldWriter:
        def __init__(self):
            self.scalars = []

        def scalar(self, tag, value, step):
            self.scalars.append((step, tag, value))

        def flush(self):
            pass

    def step_with_vec(state, batch):
        new, out = _fake_step(state, batch)
        out["grad_norms"] = torch.arange(4.0)
        return new, out

    w = OldWriter()
    TrainLoop(step_with_vec, _state(), itertools.repeat(1.0),
              [SummaryHook(w, every_steps=2),
               StopAtStepHook(last_step=2)]).run()
    tags = {t for _, t, _ in w.scalars}
    assert "grad_norms/mean" in tags and "grad_norms/max" in tags
    assert "loss" in tags


def test_summary_hook_param_histograms_cadence():
    state = _state(params={"hid": {"w": torch.ones(3, 2),
                                   "b": torch.zeros(2)}})

    def step_keep_params(s, batch):
        new, out = _fake_step(s, batch)
        return TrainState(step=new.step, params=s.params, model_state={},
                          opt_state={}, rng=s.rng), out

    w = _RecWriter()
    TrainLoop(step_keep_params, state, itertools.repeat(1.0),
              [SummaryHook(w, every_steps=100, param_histograms_every=3),
               StopAtStepHook(last_step=6)]).run()
    assert (3, "params/hid/w", 6) in w.hists
    assert (3, "params/hid/b", 2) in w.hists
    assert (6, "params/hid/w", 6) in w.hists


def test_memory_profile_hook(tmp_path):
    hook = MemoryProfileHook(str(tmp_path), after_steps=2)
    TrainLoop(_fake_step, _state(), iter([1.0] * 3), [hook]).run()
    prof = tmp_path / "memory-step2.prof"
    assert prof.exists() and prof.stat().st_size > 0
    # the CPU has no CUDA allocator: a snapshot with no segments
    assert pickle.loads(prof.read_bytes()) == {"segments": [],
                                               "device_traces": []}


def test_memory_profile_hook_resumed_and_short_runs(tmp_path):
    hook = MemoryProfileHook(str(tmp_path), after_steps=2)
    TrainLoop(_fake_step, _state(step=100), iter([1.0] * 3), [hook]).run()
    assert (tmp_path / "memory-step102.prof").exists()
    short = tmp_path / "short"
    short.mkdir()
    hook = MemoryProfileHook(str(short), after_steps=50)
    TrainLoop(_fake_step, _state(), iter([1.0] * 3), [hook]).run()
    assert (short / "memory-final.prof").exists()


def test_memory_hook_on_cpu_reports_state_bytes_and_no_live_stats():
    w = _RecWriter()
    hook = MemoryHook(w, every_steps=1)
    state = _state(params={"w": torch.ones(4, 4)})
    TrainLoop(_fake_step, state, iter([1.0] * 2), [hook]).run()
    assert hook.last["memory/param_bytes_per_device"] == 64
    assert "memory/bytes_in_use" not in hook.last


def test_profiler_hook_writes_a_chrome_trace(tmp_path):
    hook = ProfilerHook(str(tmp_path), start_step=1, num_steps=2)
    TrainLoop(_fake_step, _state(), iter([1.0] * 5), [hook]).run()
    assert hook.trace_path == str(tmp_path / "trace-steps1-3.json")
    assert "traceEvents" in json.loads((tmp_path / "trace-steps1-3.json")
                                       .read_text())


def test_step_time_and_input_pipeline_hooks():
    w = _RecWriter()
    st, ip = StepTimeHook(w, every_steps=2), InputPipelineHook(w, every_steps=2)
    TrainLoop(_fake_step, _state(), iter([1.0] * 4), [st, ip]).run()
    assert set(st.last) == {"step_time/p50_ms", "step_time/p95_ms",
                            "step_time/p99_ms", "step_time/mean_ms"}
    assert set(ip.last) == {"input/feed_stall_ms_per_step",
                            "input/runahead_wait_ms_per_step"}


def test_checkpoint_hook_saves_at_begin_cadence_and_end():
    log = []
    mgr = _MemoryCkpt(log)
    hook = CheckpointHook(mgr, every_steps=2, every_secs=None)
    loop = TrainLoop(_fake_step, _state(), iter([1.0] * 5), [hook])
    loop.run()
    assert [s for _, what, s in log if what == "save"] == [0, 2, 4, 5]
    assert loop.goodput.save_s > 0


def test_overlap_hook_publishes_the_plan():
    """`overlap/*` once at begin, at the initial step: numbers as they
    are, booleans as 1.0 / 0.0, the chunk mode (a string) left out; the
    same values the reference's hook publishes for the same plan."""
    plan = {"buckets": 4, "sharded_leaves": 82, "total_leaves": 82,
            "gathered_bytes": 1_092_264, "bucket_mb": 0.25, "serial": True,
            "chunk": "ring"}
    w = _RecWriter()
    hook = builtin.OverlapHook(w, plan)
    loop = TrainLoop(_fake_step, _state(step=3), iter([1.0] * 2), [hook])
    loop.run()
    want = {"overlap/buckets": 4, "overlap/sharded_leaves": 82,
            "overlap/total_leaves": 82, "overlap/gathered_bytes": 1_092_264,
            "overlap/bucket_mb": 0.25, "overlap/serial": 1.0}
    assert hook.last == want
    assert sorted(w.scalars) == sorted((3, k, v) for k, v in want.items())
    ref = jhooks.OverlapHook(None, plan)
    ref.begin(type("L", (), {"initial_step": 3})())
    assert ref.last == hook.last


# -- both packages' loops, one script -----------------------------------------

class _CallLog:
    """A hook recording (name, method, step) — one class, duck-typed for
    both packages' loops."""

    def __init__(self, name, calls):
        self.name, self.calls = name, calls

    def begin(self, loop):
        self.calls.append((self.name, "begin", loop.initial_step))

    def before_step(self, step):
        self.calls.append((self.name, "before_step", step))

    def after_step(self, step, state, outputs):
        self.calls.append((self.name, "after_step", step))

    def end(self, state):
        self.calls.append((self.name, "end", state.step_int))


def _jax_state(step=0):
    return JTrainState(step=jnp.int32(step), params={}, model_state={},
                       opt_state={}, rng=jnp.zeros((2,), jnp.uint32))


def _jax_fake_step(state, batch):
    return (JTrainState(step=state.step + 1, params=state.params,
                        model_state=state.model_state,
                        opt_state=state.opt_state, rng=state.rng),
            {"loss": jnp.float32(batch)})


def _run_script(pkg: str) -> list:
    """The same script through one package's loop: a preemption on the 5th
    call, recovered from the step-2 checkpoint, a run to step 8, two
    recorders around the reference's stop/eval/checkpoint hooks."""
    calls = []
    if pkg == "jax":
        hooks_mod, loop_mod = jhooks, jloop
        state, step = _jax_state(), _jax_fake_step
    else:
        from dist_mnist_tpu_torch import hooks as hooks_mod
        from dist_mnist_tpu_torch.train import loop as loop_mod
        state, step = _state(), _fake_step
    mgr = _MemoryCkpt(calls)
    evals = hooks_mod.EvalHook(
        lambda s: calls.append(("eval", "eval", s.step_int))
        or {"loss": 0.0, "accuracy": 1.0}, every_steps=3)
    hook_list = [_CallLog("a", calls),
                 hooks_mod.StopAtStepHook(last_step=8), evals,
                 hooks_mod.CheckpointHook(mgr, every_steps=2,
                                          every_secs=None),
                 _CallLog("b", calls)]
    loop = loop_mod.TrainLoop(
        _FlakyStep(fail_at={5}, step=step, error=loop_mod.PreemptionError),
        state, itertools.repeat(1.0), hook_list, checkpoint_manager=mgr,
        max_recoveries=1)
    final = loop.run()
    calls.append(("loop", "final", final.step_int))
    return calls


def test_both_loops_make_the_same_hook_calls_across_a_restore():
    want = _run_script("jax")
    got = _run_script("torch")
    assert got == want
    # the script did restore: step 4's work is replayed from step 4's save
    assert ("manager", "restore", 4) in got
    assert got[-1] == ("loop", "final", 8)
