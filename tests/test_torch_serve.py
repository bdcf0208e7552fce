"""The port's serving stack on the CPU: engine parity with the JAX
`InferenceEngine`, the server + load generator end to end, device
selection and the CLI.

The JAX engine serves the same converted params with its dense layers on
the Pallas `quant_matmul` kernel in interpret mode (FUSED_MATMUL set
before its first trace); the port's engine runs on `device="cpu"`, where
its kernel wrapper takes the plain version.
"""

from __future__ import annotations

import builtins
import concurrent.futures
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dist_mnist_tpu.models.registry import get_model as jget_model
from dist_mnist_tpu.obs import hist as jhist
from dist_mnist_tpu.ops import quant as jquant
from dist_mnist_tpu.serve import errors as jerrors
from dist_mnist_tpu.serve import metrics as jmetrics
from dist_mnist_tpu.serve.engine import InferenceEngine as JaxEngine
from dist_mnist_tpu_torch.cli import serve as tcli
from dist_mnist_tpu_torch.convert import params_from_jax
from dist_mnist_tpu_torch.models.registry import get_model as tget_model
from dist_mnist_tpu_torch.obs import hist as thist
from dist_mnist_tpu_torch.serve import errors as terrors
from dist_mnist_tpu_torch.serve import metrics as tmetrics
from dist_mnist_tpu_torch.serve import (
    InferenceEngine,
    InferenceServer,
    ServeConfig,
    load_for_serving,
    make_images,
    run_loadgen,
)
from dist_mnist_tpu_torch.utils.device import resolve_device

IMAGE_SHAPE = (28, 28, 1)
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


def _engines(mesh, name, max_bucket=64, seed=0):
    """(port engine on cpu, JAX engine on `mesh`), both int8, same params."""
    jmodel = jget_model(name)
    jparams, _ = jmodel.init(jax.random.PRNGKey(seed),
                             jnp.zeros((1, *IMAGE_SHAPE)))
    tparams = params_from_jax(jax.device_get(jparams))
    jeng = JaxEngine(jmodel, jparams, {}, mesh, model_name=f"{name}_q",
                     image_shape=IMAGE_SHAPE, max_bucket=max_bucket,
                     quant="int8")
    teng = InferenceEngine(tget_model(name), tparams, {}, device="cpu",
                           image_shape=IMAGE_SHAPE,
                           max_bucket=max_bucket, quant="int8")
    return teng, jeng


@pytest.mark.parametrize("name,n", [("lenet5", 1), ("lenet5", 5),
                                    ("lenet5", 64), ("mlp", 5)])
def test_engine_predict_matches_jax_engine(monkeypatch, mesh1, name, n):
    monkeypatch.setattr(jquant, "FUSED_MATMUL", "pallas")
    teng, jeng = _engines(mesh1, name)
    images = make_images(IMAGE_SHAPE, seed=n, n=n)
    got, want = teng.predict(images), jeng.predict(images)
    assert got.shape == want.shape == (n, 10) and got.dtype == np.float32
    if name == "lenet5":
        # bf16 compute: the zoo's bound, and the same top-1
        assert float(np.max(np.abs(got - want))) <= 0.04
        assert float(np.mean(got.argmax(-1) == want.argmax(-1))) >= 0.98
    else:
        # f32 compute: summation order only
        assert float(np.max(np.abs(got - want))) <= \
            1e-4 * float(np.max(np.abs(want)))
    # int8 leaves count 1 byte each, scales 4: the same bytes as the JAX
    # engine holds per device
    assert teng.state_bytes_per_device() == jeng.state_bytes_per_device()


def test_engine_buckets_pad_and_count_first_runs():
    bundle = load_for_serving("lenet5_mnist", "cpu", quant="int8")
    eng = InferenceEngine(bundle.model, bundle.params, bundle.model_state,
                          device="cpu", image_shape=bundle.image_shape,
                          max_bucket=8, quant=bundle.quant)
    assert eng.quant == "int8" and eng.buckets() == [1, 2, 4, 8]
    assert eng.prewarm([1, 4]) == 2 and eng.prewarm([1, 4]) == 0
    images = make_images(IMAGE_SHAPE, n=5)
    out = eng.predict(images)
    assert out.shape == (5, 10) and np.isfinite(out).all()
    # padding rows never leak into real rows
    np.testing.assert_array_equal(eng.predict(images[:3]), out[:3])
    stats = eng.cache_stats()
    assert stats.pop("execute_secs") > 0.0
    assert stats == {"hits": 1, "misses": 3, "execute_count": 4,
                     "per_bucket": {"1": 1, "4": 2, "8": 1}}
    with pytest.raises(ValueError):
        eng.bucket_for(9)
    with pytest.raises(ValueError):
        eng.predict(np.zeros((2, 32, 32, 3), np.uint8))


def test_loader_seeded_fresh_init_is_deterministic():
    a = load_for_serving("lenet5_mnist", "cpu", quant="int8")
    b = load_for_serving("lenet5_mnist", "cpu", quant="int8")
    assert a.quant == "int8" and a.quant_report["n_quantized"] == 4
    assert a.quant_report["max_rel_err"] < 5e-3
    assert torch.equal(a.params["fc1"]["w"].q, b.params["fc1"]["w"].q)
    assert a.params["fc1"]["w"].scale.shape == (1, 512)
    assert a.params["conv2"]["w"].scale.shape == (5, 5, 1, 64)


def test_loader_serves_params_carried_from_jax():
    jparams, _ = jget_model("lenet5").init(jax.random.PRNGKey(2),
                                           jnp.zeros((1, *IMAGE_SHAPE)))
    bundle = load_for_serving(
        "lenet5_mnist", "cpu", quant="int8",
        params=params_from_jax(jax.device_get(jparams)))
    want = jquant.quantize_tree(jparams)
    for layer in ("conv1", "conv2", "fc1", "fc2"):
        np.testing.assert_array_equal(bundle.params[layer]["w"].q.numpy(),
                                      np.asarray(want[layer]["w"].q))


def test_server_and_loadgen_end_to_end_on_cpu():
    bundle = load_for_serving("lenet5_mnist", "cpu", quant="int8")
    eng = InferenceEngine(bundle.model, bundle.params, bundle.model_state,
                          device="cpu", image_shape=bundle.image_shape,
                          max_bucket=8, quant=bundle.quant,
                          quant_report=bundle.quant_report)
    server = InferenceServer(eng, ServeConfig(max_batch=8, max_wait_ms=2.0))
    with server:
        summary = run_loadgen(server, n_requests=48, concurrency=8,
                              image_shape=bundle.image_shape, seed=1)
    assert summary["ok"] == 48 and summary["errors"] == 0
    assert summary["deadline_expired"] == 0
    assert summary["rejected_queue_full"] == summary["rejected_shutdown"] == 0
    assert 1 <= summary["mean_batch_size"] <= 8
    assert summary["cache"]["misses"] == 4  # buckets 1..8 prewarmed
    stats = server.stats()
    assert stats["completed"] == 48 and stats["quant"] == "int8"
    assert stats["quant_error_max"] == bundle.quant_report["max_abs_err"]
    # close() joined the batcher thread
    assert not server._batcher._thread.is_alive()


def test_histogram_and_serve_metrics_match_reference():
    """The copied host modules give the reference's numbers for the same
    observations."""
    rng = np.random.default_rng(4)
    ports, refs = tmetrics.ServeMetrics(), jmetrics.ServeMetrics()
    for m in (ports, refs):
        m.record_quant_report({"max_abs_err": 0.25})
        for _ in range(7):
            m.record_admitted()
        m.record_rejected("queue_full")
        m.record_rejected("deadline")
        m.record_failed(2)
        m.record_cancelled()
    for ms in rng.lognormal(1.0, 0.8, 500):
        ports.record_latency(float(ms))
        refs.record_latency(float(ms))
    for n, bucket in ((3, 4), (8, 8), (5, 8), (1, 1)):
        ports.record_batch(n, bucket)
        refs.record_batch(n, bucket)
    assert ports.snapshot() == refs.snapshot()
    th, jh = thist.StreamingHistogram(), jhist.StreamingHistogram()
    for v in rng.exponential(3.0, 1000):
        th.observe(float(v))
        jh.observe(float(v))
    assert th.snapshot() == jh.snapshot()


@pytest.mark.parametrize("name", [
    "QueueFullError", "ShuttingDownError", "DeadlineExceededError",
    "ShedError", "ReplicaKilledError", "AllReplicasDownError",
    "CancelledError", "ConnectionError", "ValueError"])
def test_classify_failure_matches_reference(name):
    def make(errors_mod):
        for mod in (errors_mod, builtins, concurrent.futures):
            if hasattr(mod, name):
                return getattr(mod, name)("x")
        raise AssertionError(name)

    assert terrors.classify_failure(make(terrors)) == \
        jerrors.classify_failure(make(jerrors))


def test_resolve_device_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(name)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("mps")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_for_serving("lenet5_mnist", quant="int8")


def test_cli_without_cuda_exits_nonzero():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "dist_mnist_tpu_torch.cli.serve",
         "--config=lenet5_mnist", "--quant=int8"],
        capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert proc.stdout == ""


def test_cli_serves_on_cpu(capsys):
    summary = tcli.main(["--config=lenet5_mnist", "--quant=int8",
                         "--device=cpu", "--requests=24", "--max_batch=4",
                         "--concurrency=4"])
    printed = json.loads(capsys.readouterr().out)
    assert printed == json.loads(json.dumps(summary))
    assert summary["ok"] == 24 and summary["errors"] == 0
    assert summary["device"] == "cpu" and summary["quant"] == "int8"
    assert summary["quant_leaves"] == 4
    for key in ("p50_ms", "p99_ms", "mean_batch_size", "n_batches", "cache",
                "checkpoint_step", "restored",
                "serve_state_bytes_per_device", "quant_error_max",
                "quant_rel_err_max"):
        assert key in summary

