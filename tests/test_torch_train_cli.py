"""The port's training CLI (`dist_mnist_tpu_torch/cli/train.py`) on the
CPU: the same `mlp_mnist` run through both packages' `run_config` from one
init (per-step losses within 1e-5, the final eval within 1e-4, and the
same journal events minus those of subsystems the port lacks); LeNet-5
with dropout preempted-and-recovered and stopped-and-resumed, each equal
to the uninterrupted run bit for bit; the SIGTERM handshake in a
subprocess; absl's flag spellings; every refused flag naming its ROADMAP
item; the PS-era flags; --download_only; no card without --device=cpu;
and serving the trained checkpoint."""

from __future__ import annotations

import collections
import dataclasses
import logging
import os
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from dist_mnist_tpu import configs as jconfigs
from dist_mnist_tpu.cli.train import build_optimizer as jbuild_optimizer
from dist_mnist_tpu.cli.train import run_config as jrun_config
from dist_mnist_tpu.models import get_model as jget_model
from dist_mnist_tpu.train import create_train_state as jcreate_train_state
from dist_mnist_tpu_torch import train as ttrain
from dist_mnist_tpu_torch.cli import serve as serve_cli
from dist_mnist_tpu_torch.cli import train as cli
from dist_mnist_tpu_torch.cluster.mesh import MeshSpec
from dist_mnist_tpu_torch.configs import get_config
from dist_mnist_tpu_torch.convert import train_state_from_jax
from dist_mnist_tpu_torch.data import datasets
from dist_mnist_tpu_torch.obs import events
from dist_mnist_tpu_torch.train.loop import PreemptionError
from dist_mnist_tpu_torch.utils.tree import flatten_with_path

ROOT = Path(__file__).resolve().parents[1]

#: journal events of subsystems the port has not ported: the compile
#: cache and the cold-start clock (compilecache/, ROADMAP §1 item 13)
UNPORTED_EVENTS = {"compile_cache", "compile_cache_hit", "compile_cache_miss",
                   "compile_cache_store", "startup"}


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


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory) -> str:
    """A small MNIST twin (2,048 train / 500 test) in the IDX layout both
    packages read."""
    path = tmp_path_factory.mktemp("mnist-data")
    datasets._write_synth_cache(path, "mnist",
                                datasets._synth("mnist", 2048, 500, 0))
    return str(path)


class _Losses:
    """Records each step's loss (one host sync a step: tests only)."""

    def __init__(self):
        self.values = []

    def begin(self, loop):
        pass

    def before_step(self, step):
        pass

    def after_step(self, step, state, outputs):
        self.values.append(float(np.asarray(outputs["loss"])))

    def end(self, state):
        pass


def _journal_events(path) -> list[str]:
    return [r["event"] for r in events.read_journal(path)]


def test_mlp_mnist_matches_the_jax_cli_from_one_init(tmp_path, data_dir,
                                                     mesh1, monkeypatch):
    steps = 50
    jcfg = jconfigs.get_config("mlp_mnist", train_steps=steps, eval_every=0)
    tcfg = get_config("mlp_mnist", train_steps=steps, eval_every=0)
    jstate = jcreate_train_state(
        jget_model(jcfg.model, **jcfg.model_kwargs), jbuild_optimizer(jcfg),
        jax.random.PRNGKey(jcfg.seed), np.zeros((1, 28, 28, 1), np.uint8))
    start = jax.device_get(jstate)
    monkeypatch.setattr(ttrain, "create_train_state",
                        lambda *a, **k: train_state_from_jax(start,
                                                             seed=tcfg.seed))
    jl, tl = _Losses(), _Losses()
    common = dict(data_dir=data_dir, checkpoint_every_steps=20)
    _, jfinal, _ = jrun_config(jcfg, mesh=mesh1, extra_hooks=[jl],
                               checkpoint_dir=str(tmp_path / "jck"),
                               journal=str(tmp_path / "j.jsonl"), **common)
    tstate, tfinal, ctx = cli.run_config(
        tcfg, device="cpu", extra_hooks=[tl],
        checkpoint_dir=str(tmp_path / "tck"),
        journal=str(tmp_path / "t.jsonl"), **common)
    assert tstate.step_int == steps and len(tl.values) == steps
    np.testing.assert_allclose(tl.values, jl.values, rtol=0, atol=1e-5)
    assert abs(tfinal["loss"] - jfinal["loss"]) <= 1e-4
    assert abs(tfinal["accuracy"] - jfinal["accuracy"]) <= 1e-4
    want = collections.Counter(e for e in _journal_events(tmp_path / "j.jsonl")
                               if e not in UNPORTED_EVENTS)
    got = collections.Counter(_journal_events(tmp_path / "t.jsonl"))
    assert got == want
    assert {"run_start", "first_step", "checkpoint_save",
            "checkpoint_commit", "run_stop"} <= set(got)


@pytest.fixture(scope="module")
def lenet_data_dir(tmp_path_factory) -> str:
    """256 train rows: an epoch is 16 steps of 16."""
    path = tmp_path_factory.mktemp("lenet-data")
    datasets._write_synth_cache(path, "mnist",
                                datasets._synth("mnist", 256, 64, 0))
    return str(path)


def _lenet_cfg(steps):
    return get_config("lenet5_mnist", train_steps=steps, batch_size=16,
                      eval_every=0, log_every=8)


def _run_lenet(data_dir, steps, ckpt=None, **kw):
    return cli.run_config(_lenet_cfg(steps), device="cpu", data_dir=data_dir,
                          checkpoint_dir=ckpt, checkpoint_every_steps=8,
                          prefetch_depth=2, **kw)


def _assert_same_bits(a, b):
    for tree in ("params", "opt_state"):
        fa = flatten_with_path(getattr(a, tree))
        fb = flatten_with_path(getattr(b, tree))
        assert [p for p, _ in fa] == [p for p, _ in fb]
        for (path, x), (_, y) in zip(fa, fb):
            assert torch.equal(x, y), (tree, path)
    assert torch.equal(a.rng.get_state(), b.rng.get_state())


class _PreemptOnce:
    """Raises PreemptionError once, after step `at`."""

    def __init__(self, at):
        self.at, self.fired = at, False

    def begin(self, loop):
        pass

    def before_step(self, step):
        pass

    def after_step(self, step, state, outputs):
        if step == self.at and not self.fired:
            self.fired = True
            raise PreemptionError(f"injected at step {step}")

    def end(self, state):
        pass


@pytest.fixture(scope="module")
def lenet_uninterrupted(lenet_data_dir):
    """24 steps (an epoch is 16) of LeNet-5 with dropout, straight."""
    state, _, _ = _run_lenet(lenet_data_dir, 24)
    return state


def test_preempted_lenet_run_recovers_bit_for_bit(tmp_path, lenet_data_dir,
                                                  lenet_uninterrupted):
    hook = _PreemptOnce(13)
    state, _, ctx = _run_lenet(lenet_data_dir, 24, str(tmp_path / "ck"),
                               max_recoveries=1, extra_hooks=[hook])
    assert hook.fired and state.step_int == 24
    snap = ctx["loop"].goodput.snapshot()
    assert snap["recoveries"] == 1 and snap["replayed_steps"] == 5
    _assert_same_bits(state, lenet_uninterrupted)


def test_stopped_and_resumed_lenet_run_equals_the_straight_one(
        tmp_path, lenet_data_dir, lenet_uninterrupted):
    ckpt = str(tmp_path / "ck")
    first, _, ctx1 = _run_lenet(lenet_data_dir, 12, ckpt)
    assert first.step_int == 12 and not ctx1["restored"]
    state, _, ctx = _run_lenet(lenet_data_dir, 24, ckpt)
    assert ctx["restored"] and ctx["initial_step"] == 12
    _assert_same_bits(state, lenet_uninterrupted)


def test_native_pipeline_resumes_and_recovers_bit_for_bit(
        tmp_path, lenet_data_dir):
    """`--input_pipeline=native` (the C++ batcher, prefetched): a run
    stopped and resumed, and a run preempted and recovered through the
    batcher's `at_step`, each end with the straight run's bits."""
    straight, _, ctx = _run_lenet(lenet_data_dir, 24,
                                  input_pipeline="native")
    assert straight.step_int == 24
    assert type(ctx["loop"].batches.inner).__name__ == "NativeBatcher"
    ckpt = str(tmp_path / "ck")
    _run_lenet(lenet_data_dir, 12, ckpt, input_pipeline="native")
    resumed, _, ctx = _run_lenet(lenet_data_dir, 24, ckpt,
                                 input_pipeline="native")
    assert ctx["restored"] and ctx["initial_step"] == 12
    _assert_same_bits(resumed, straight)
    hook = _PreemptOnce(13)
    recovered, _, ctx = _run_lenet(
        lenet_data_dir, 24, str(tmp_path / "ck2"), max_recoveries=1,
        extra_hooks=[hook], input_pipeline="native")
    assert hook.fired and ctx["loop"].goodput.snapshot()["recoveries"] == 1
    _assert_same_bits(recovered, straight)


def test_cli_checkpoint_resume_flow_and_serving_it(tmp_path, data_dir,
                                                   caplog, capsys):
    ckpt, logdir = str(tmp_path / "ck"), str(tmp_path / "logs")
    argv = ["--device=cpu", "--config=mlp_mnist", f"--data_dir={data_dir}",
            "--eval_every=0", f"--checkpoint_dir={ckpt}", f"--logdir={logdir}",
            "--checkpoint_every_steps", "10", "--log_every=10"]
    with caplog.at_level(logging.INFO):
        state, final, ctx = cli.main(argv + ["--train_steps=20"])
    assert state.step_int == 20 and not ctx["restored"]
    assert sorted(p.name for p in Path(ckpt, "commits").iterdir()) == [
        "0.committed", "10.committed", "20.committed"]
    caplog.clear()
    with caplog.at_level(logging.INFO):
        state, _, ctx = cli.main(argv + ["--train_steps=30"])
    assert ctx["restored"] and ctx["initial_step"] == 20
    assert state.step_int == 30
    assert "restored=True" in caplog.text
    assert "done: step=30 test_acc=" in caplog.text
    tags = {row.split(",")[1] for row in
            Path(logdir, "metrics.csv").read_text().splitlines()[1:]}
    assert {"steps_per_sec", "loss", "accuracy", "step_time/p50_ms",
            "goodput/productive_s", "input/feed_stall_ms_per_step",
            "memory/param_bytes_per_device"} <= tags
    names = set(_journal_events(Path(logdir, "events.jsonl")))
    assert {"run_start", "checkpoint_restore", "first_step",
            "checkpoint_save", "checkpoint_commit", "run_stop"} <= names
    capsys.readouterr()
    summary = serve_cli.main(["--config=mlp_mnist", "--device=cpu",
                              f"--checkpoint_dir={ckpt}", "--requests=16",
                              "--concurrency=4"])
    assert summary["checkpoint_step"] == 30 and summary["restored"]
    assert summary["ok"] == 16
    summary = serve_cli.main(["--config=mlp_mnist", "--device=cpu",
                              f"--checkpoint_dir={ckpt}", "--step=20",
                              "--requests=8", "--concurrency=4"])
    assert summary["checkpoint_step"] == 20


def test_sigterm_checkpoints_logs_preempted_and_exits_zero(tmp_path,
                                                           data_dir):
    ckpt = tmp_path / "ck"
    proc = subprocess.Popen(
        [sys.executable, "-m", "dist_mnist_tpu_torch.cli.train",
         "--device=cpu", "--config=mlp_mnist", f"--data_dir={data_dir}",
         "--train_steps=1000000", "--eval_every=0", "--log_every=5",
         f"--checkpoint_dir={ckpt}", "--checkpoint_every_steps=100000"],
        cwd=ROOT, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONUNBUFFERED": "1"})
    try:
        deadline = time.monotonic() + 120
        lines = []
        for line in proc.stderr:  # wait until it is training
            lines.append(line)
            if "steps/sec" in line or time.monotonic() > deadline:
                break
        proc.send_signal(signal.SIGTERM)
        _, rest = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    log_text = "".join(lines) + rest
    assert proc.returncode == 0, log_text[-2000:]
    marker = [ln for ln in log_text.splitlines() if "preempted@step=" in ln]
    assert marker, log_text[-2000:]
    step = int(marker[0].split("preempted@step=")[1].split()[0])
    assert step > 0
    assert (ckpt / "commits" / f"{step}.committed").exists()


@pytest.mark.parametrize("argv,want", [
    (["--sync_replicas=false"], False),
    (["--nosync_replicas"], False),
    (["--sync_replicas"], True),
    (["--sync_replicas", "--nosync_replicas"], False),
    (["--download_only=true"], True),
])
def test_absl_boolean_spellings(argv, want):
    args = cli.build_parser().parse_args(argv)
    name = argv[0].lstrip("-").split("=")[0].removeprefix("no")
    assert getattr(args, name) is want


def test_absl_value_spellings():
    args = cli.build_parser().parse_args(
        ["--train_steps=7", "--batch_size", "32", "--learning_rate=0.5"])
    assert (args.train_steps, args.batch_size, args.learning_rate) == (
        7, 32, 0.5)


REFUSED = [
    (["--mesh=data=1,model=2,seq=2"], "item 11"),
    (["--host_device_count=8"], "item 12"),
    (["--mesh=data=1,model=2,pipe=2"], "item 11"),
    (["--overlap"], "item 13"),
    (["--overlap_bucket_mb=2"], "item 13"),
    (["--overlap_chunk=ring"], "item 13"),
    (["--fault_plan={}"], "item 13"),
    (["--compile_cache_dir=/x"], "item 13"),
    (["--elastic_batch_policy=scale_lr"], "item 13"),
    (["--elastic_baseline_devices=4"], "item 13"),
    (["--async_snapshot"], "item 13"),
    (["--snapshot_window=2"], "item 13"),
    (["--snapshot_policy=drop_oldest"], "item 13"),
    (["--peer_dir=/x"], "item 13"),
    (["--metrics_port=9000"], "item 14"),
    (["--anomaly"], "item 14"),
    (["--anomaly_every=5"], "item 14"),
    (["--tuned=require"], "item 16"),
    (["--tuned_dir=/x"], "item 16"),
    (["--prng_impl=rbg"], "closing line"),
]


@pytest.mark.parametrize("argv,item", REFUSED,
                         ids=[a[0].split("=")[0] + "=" for a, _ in REFUSED])
def test_refused_flags_name_their_roadmap_item(argv, item):
    with pytest.raises(SystemExit) as info:
        cli.main(["--device=cpu", "--config=mlp_mnist", *argv])
    msg = str(info.value.code)
    assert msg.startswith("error: ") and "ROADMAP §1" in msg and item in msg


def test_refused_config_fields_name_their_roadmap_item(data_dir):
    for over, item in (({"mesh": MeshSpec(data=1, model=2, seq=2)},
                        "item 11"),
                       ({"prng_impl": "rbg"}, "closing line"),
                       ({"overlap": True}, "item 13")):
        cfg = dataclasses.replace(get_config("mlp_mnist"), **over)
        with pytest.raises(NotImplementedError, match=item):
            cli.run_config(cfg, device="cpu", data_dir=data_dir)


#: flags the data- and sequence-parallel slices and the native layer
#: lifted from the refusals above
LIFTED = [
    ["--input_pipeline=native"],
    ["--replicas_to_aggregate=2"],
    ["--mesh=data=1"],
    ["--sharding=fsdp"],
    ["--input_pipeline=device_sharded"],
    ["--coordinator_address=localhost:1234", "--num_processes=1"],
    ["--platform=cpu"],
    ["--remat_policy=save_attn"],
    ["--remat_policy=dots"],
]


@pytest.mark.parametrize("argv", LIFTED, ids=[a[0].split("=")[0] + "="
                                              for a in LIFTED])
def test_lifted_flags_now_run(data_dir, argv):
    """Each flag the data- and sequence-parallel slices lifted trains on
    one process (a coordinator address with one process is no group: a
    no-op; the remat policies are accepted, and a config without remat
    does not use them)."""
    state, final, ctx = cli.main([
        "--device=cpu", "--config=mlp_mnist", f"--data_dir={data_dir}",
        "--train_steps=4", "--eval_every=0", *argv])
    assert state.step_int == 4
    assert 0.0 <= final["accuracy"] <= 1.0
    assert ctx["mesh"].size == 1


def test_ps_era_flags_warn_and_still_train(data_dir, caplog):
    with caplog.at_level(logging.INFO):
        state, _, _ = cli.main([
            "--device=cpu", "--config=mlp_mnist", f"--data_dir={data_dir}",
            "--train_steps=5", "--eval_every=0", "--job_name=worker",
            "--task_index=1", "--ps_hosts=a:1", "--worker_hosts=b:1",
            "--nosync_replicas", "--num_gpus=2", "--existing_servers"])
    assert state.step_int == 5
    warned = [r.getMessage() for r in caplog.records
              if r.levelno == logging.WARNING]
    for flag in ("--job_name", "--ps_hosts", "--worker_hosts",
                 "--task_index", "--num_gpus", "--existing_servers",
                 "--nosync_replicas"):
        assert any(flag in w for w in warned), flag
    assert "done: step=5" in caplog.text


def test_download_only_exits_before_training(tmp_path, caplog):
    data = tmp_path / "fresh"
    # a small twin via the loader's own cache path
    datasets._write_synth_cache(data, "mnist",
                                datasets._synth("mnist", 128, 32, 1))
    with caplog.at_level(logging.INFO):
        out = cli.main(["--device=cpu", "--download_only",
                        f"--data_dir={data}"])
    assert out is None
    assert "dataset mnist ready (128 train / 32 test" in caplog.text
    assert "done:" not in caplog.text


def test_without_a_card_the_cli_exits_nonzero(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as info:
        cli.main(["--config=mlp_mnist"])
    assert "no CUDA device" in str(info.value.code)
    proc = subprocess.run(
        [sys.executable, "-m", "dist_mnist_tpu_torch.cli.train",
         "--config=mlp_mnist", "--train_steps=1"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr


def test_scan_chunk_needs_the_device_pipeline():
    with pytest.raises(SystemExit, match="scan_chunk"):
        cli.main(["--device=cpu", "--scan_chunk=10"])


def test_device_pipeline_in_chunks_trains(data_dir):
    state, final, ctx = cli.main([
        "--device=cpu", "--config=mlp_mnist", f"--data_dir={data_dir}",
        "--train_steps=40", "--eval_every=0", "--input_pipeline=device",
        "--scan_chunk=20"])
    assert state.step_int == 40 and ctx["prefetch"] is None
    assert np.isfinite(final["loss"])
