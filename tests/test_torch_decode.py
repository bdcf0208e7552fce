"""Parity of the port's causal LM and decode serving against the JAX
package, and the port's own decode contracts, on the CPU.

Weights come from the JAX init and are carried across with
`convert.params_from_jax`; token inputs come from numpy seeds. Stated
tolerances: full-forward and dense/paged/flash decode logits within 1e-5
of the JAX model (f32, sums in another order), int8 paged decode within
1e-4 (the same int8 pages, dequantized and attended in another order).
Within the port on the CPU, an incremental decode equals the full forward
bit for bit, and continuous and static scheduling give identical streams.

Geometry (small): dim 32, 2 heads, depth 2, max_seq 64, pages of 8
tokens, 4 slots.
"""

from __future__ import annotations

import tempfile
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_mnist_tpu.models.causal_lm import CausalLMTiny as JaxLM
from dist_mnist_tpu.ops import nn as jnn
from dist_mnist_tpu.serve.loadgen import make_prompts as jax_make_prompts
from dist_mnist_tpu_torch import bench
from dist_mnist_tpu_torch.cli import serve as serve_cli
from dist_mnist_tpu_torch.convert import params_from_jax
from dist_mnist_tpu_torch.models.causal_lm import CausalLMTiny
from dist_mnist_tpu_torch.ops import nn as tnn
from dist_mnist_tpu_torch.serve import (
    BEST_EFFORT,
    LATENCY_SENSITIVE,
    DecodeScheduler,
    QueueFullError,
    ShuttingDownError,
    build_decode_engine,
    init_lm_for_serving,
    make_prompts,
    run_decode_loadgen,
)
from dist_mnist_tpu_torch.serve.zoo import DecodeGrid, default_decode_grid
from dist_mnist_tpu_torch.utils.tree import flatten_with_path

LM_KW = dict(vocab_size=64, dim=32, depth=2, heads=2, max_seq=64)
PAGE_T = 8
PPS = LM_KW["max_seq"] // PAGE_T
MAX_SLOTS = 4
LAYOUTS = {
    "dense": dict(LM_KW),
    "paged": dict(LM_KW, cache_layout="paged", kv_page_tokens=PAGE_T),
    "int8": dict(LM_KW, cache_layout="paged", kv_page_tokens=PAGE_T,
                 kv_quant="int8"),
    "flash": dict(LM_KW, attention_impl="flash"),
}


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
def lm():
    """(JAX params, the port's carried copy)."""
    jparams, _ = JaxLM(**LM_KW).init(jax.random.PRNGKey(0))
    return jparams, params_from_jax(jax.device_get(jparams))


def _t(a):
    return torch.from_numpy(np.asarray(a))


# -- layers and params -------------------------------------------------------

def test_layer_norm_and_gelu_match_jax():
    rng = np.random.default_rng(0)
    x = (3.0 * rng.standard_normal((4, 7, 32)) + 1.0).astype(np.float32)
    p = {"scale": rng.standard_normal(32).astype(np.float32),
         "bias": rng.standard_normal(32).astype(np.float32)}
    want = jnn.layer_norm({k: jnp.asarray(v) for k, v in p.items()},
                          jnp.asarray(x))
    got = tnn.layer_norm({k: _t(v) for k, v in p.items()}, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(tnn.gelu(_t(x)).numpy(),
                               np.asarray(jnn.gelu(jnp.asarray(x))),
                               atol=1e-5, rtol=0)


def test_convert_carries_the_causal_lm_param_tree(lm):
    jparams, tparams = lm
    paths = ["/".join(str(k) for k in p) for p, _ in
             flatten_with_path(tparams)]
    want = ["final_ln/bias", "final_ln/scale", "lm_head/b", "lm_head/w",
            "pos", "tok_emb"]
    for i in range(LM_KW["depth"]):
        want += [f"block{i}/{leaf}" for leaf in (
            "attn/out/b", "attn/out/w", "attn/qkv/b", "attn/qkv/w",
            "ln1/bias", "ln1/scale", "ln2/bias", "ln2/scale",
            "mlp_in/b", "mlp_in/w", "mlp_out/b", "mlp_out/w")]
    assert sorted(paths) == sorted(want)
    jflat = {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(a)
             for p, a in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    for path, leaf in flatten_with_path(tparams):
        np.testing.assert_array_equal(leaf.numpy(),
                                      jflat["/".join(path)])
    # the port's own init makes the same tree
    fresh, _ = CausalLMTiny(**LM_KW).init(torch.Generator().manual_seed(0))
    assert sorted("/".join(p) for p, _ in flatten_with_path(fresh)) == \
        sorted(want)


def test_full_forward_matches_jax(lm):
    jparams, tparams = lm
    tokens = np.random.default_rng(1).integers(0, 64, size=(3, 20),
                                               dtype=np.int32)
    want, _ = JaxLM(**LM_KW).apply(jparams, {}, jnp.asarray(tokens))
    got, _ = CausalLMTiny(**LM_KW).apply(tparams, {}, _t(tokens))
    assert got.shape == (3, 20, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    flops = CausalLMTiny(**LM_KW).flops_per_example((1, 20))
    assert flops == JaxLM(**LM_KW).flops_per_example((1, 20))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_prefill_then_decode_matches_jax(lm, layout):
    """Prefill two prompts, then 10 decode steps fed the JAX model's own
    greedy tokens, in every layout: logits within 1e-5 of the JAX model
    (1e-4 for int8 pages). JAX runs its default CPU dispatch (the flash
    kernel in Pallas interpret mode; int8 pages through its gather)."""
    jparams, tparams = lm
    kw = LAYOUTS[layout]
    jm, tm = JaxLM(**kw), CausalLMTiny(**kw)
    tol = 1e-4 if layout == "int8" else 1e-5
    rng = np.random.default_rng(2)
    rows, s_b = 2, 16
    plen = np.asarray([11, 16], np.int32)
    prompt = rng.integers(0, 64, size=(rows, s_b), dtype=np.int32)
    slots = np.arange(rows, dtype=np.int32)
    extra_j, extra_t = {}, {}
    table = None
    if jm.cache_layout == "paged":
        table = np.arange(rows * PPS, dtype=np.int32).reshape(rows, PPS)
        extra_j, extra_t = {"page_table": table}, {"page_table": _t(table)}
    want, jcache = jm.prefill(jparams, jm.init_cache(rows), prompt, slots,
                              plen, **extra_j)
    tcache = tm.init_cache(rows)
    got, _ = tm.prefill(tparams, tcache, _t(prompt), _t(slots), _t(plen),
                        **extra_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=0)
    tok = np.argmax(np.asarray(want), -1).astype(np.int32)
    pos = plen.copy()
    for _ in range(10):
        if table is not None and layout == "int8":  # truncated buckets
            width = -(-(int(pos.max()) + 1) // PAGE_T)
            extra_j = {"page_table": table[:, :width]}
            extra_t = {"page_table": _t(table[:, :width].copy())}
        want, jcache = jm.decode_step(jparams, jcache, tok, pos, **extra_j)
        got, _ = tm.decode_step(tparams, tcache, _t(tok), _t(pos),
                                **extra_t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                                   rtol=0)
        tok = np.argmax(np.asarray(want), -1).astype(np.int32)
        pos = pos + 1


# -- the port's own decode contracts -----------------------------------------

def test_incremental_decode_bit_matches_full_forward(lm):
    _, tparams = lm
    model = CausalLMTiny(**LM_KW)
    tokens = _t(np.random.default_rng(1).integers(0, 64, size=(2, 12),
                                                  dtype=np.int32))
    full, _ = model.apply(tparams, {}, tokens)
    cache = model.init_cache(2)
    for pos in range(12):
        logits, _ = model.decode_step(tparams, cache, tokens[:, pos],
                                      torch.full((2,), pos,
                                                 dtype=torch.int32))
        assert torch.equal(logits, full[:, pos]), f"position {pos}"


def test_prefill_then_decode_boundary_bitwise(lm):
    _, tparams = lm
    model = CausalLMTiny(**LM_KW)
    plen = 9
    prompt = _t(np.random.default_rng(2).integers(0, 64, size=(2, plen),
                                                  dtype=np.int32))
    full, _ = model.apply(tparams, {}, prompt)
    cache = model.init_cache(2)
    last, _ = model.prefill(tparams, cache, prompt,
                            torch.arange(2, dtype=torch.int32),
                            torch.full((2,), plen, dtype=torch.int32))
    assert torch.equal(last, full[:, -1])
    nxt = last.argmax(-1).to(torch.int32)
    step, _ = model.decode_step(tparams, cache, nxt,
                                torch.full((2,), plen, dtype=torch.int32))
    full2, _ = model.apply(tparams, {},
                           torch.cat([prompt, nxt[:, None]], dim=1))
    assert torch.equal(step, full2[:, plen])


def test_prefill_padding_rows_do_not_perturb_real_rows(lm):
    """A request's logits and cache rows are the same whatever else is in
    its (fixed-size) admission batch."""
    _, tparams = lm
    model = CausalLMTiny(**LM_KW)
    rng = np.random.default_rng(3)
    plen, bucket = 6, 8
    prompt = np.zeros((1, bucket), np.int32)
    prompt[0, :plen] = rng.integers(0, 64, size=plen)
    other = rng.integers(0, 64, size=(1, bucket), dtype=np.int32)
    pad = np.zeros((1, bucket), np.int32)
    outs = []
    for batch, slots, lens in (
            (np.concatenate([pad, prompt]), [2, 1], [1, plen]),
            (np.concatenate([other, prompt]), [0, 1], [bucket, plen])):
        cache = model.init_cache(3)
        last, _ = model.prefill(tparams, cache, _t(batch),
                                _t(np.asarray(slots, np.int32)),
                                _t(np.asarray(lens, np.int32)))
        outs.append((last[1], cache["k"][:, 1].clone()))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def test_decode_grid_buckets_and_cells():
    grid = default_decode_grid(CausalLMTiny(**LM_KW), max_slots=MAX_SLOTS)
    assert grid.prompt_buckets == (4, 8, 16, 32, 64)
    assert grid.admit_buckets == (MAX_SLOTS,)  # one fixed admission shape
    assert grid.rows == MAX_SLOTS + 1
    assert grid.prompt_bucket_for(5) == 8
    assert grid.admit_bucket_for(1) == MAX_SLOTS
    assert grid.cells()[-1] == ("decode",)
    assert len(grid.cells()) == 5 + 1
    with pytest.raises(ValueError):
        grid.prompt_bucket_for(65)
    with pytest.raises(ValueError):
        DecodeGrid(max_slots=2, max_seq=8, prompt_buckets=(16,),
                   admit_buckets=(2,))


def test_make_prompts_equals_the_reference():
    want = jax_make_prompts(10, max_seq=64, seed=4, max_new=9,
                            vocab_size=64)
    got = make_prompts(10, max_seq=64, seed=4, max_new=9, vocab_size=64)
    for (wp, wn), (gp, gn) in zip(want, got):
        np.testing.assert_array_equal(gp, wp)
        assert gn == wn


@pytest.fixture(scope="module")
def engine():
    eng = build_decode_engine("cpu", max_slots=MAX_SLOTS, **LM_KW)
    assert eng.prewarm() == len(eng.grid.cells())
    return eng


def test_prewarm_refuses_after_traffic(engine):
    with DecodeScheduler(engine) as sched:
        run_decode_loadgen(sched, n_requests=2, concurrency=2, seed=9)
    with pytest.raises(RuntimeError):
        engine.prewarm()


def test_continuous_and_static_streams_identical():
    streams = {}
    for mode, runahead in (("continuous", 1), ("continuous", 0),
                           ("static", 1)):
        eng = build_decode_engine("cpu", max_slots=MAX_SLOTS, **LM_KW)
        with DecodeScheduler(eng, mode=mode, runahead=runahead) as sched:
            res = run_decode_loadgen(sched, n_requests=16, concurrency=8,
                                     seed=5, keep_streams=True)
        assert res["ok"] == 16 and res["errors"] == 0
        assert len(res["token_times"]) == 16
        streams[(mode, runahead)] = res["streams"]
    assert streams[("continuous", 1)] == streams[("static", 1)]
    assert streams[("continuous", 1)] == streams[("continuous", 0)]


def _prompts(n, seed):
    return [p for p, _ in make_prompts(n, max_seq=64, seed=seed,
                                       max_prompt=16, max_new=1,
                                       vocab_size=64)]


def test_latency_sensitive_jumps_the_queue(engine):
    """With every slot occupied and best_effort requests queued, a newly
    submitted latency_sensitive request is admitted before all of them."""
    with DecodeScheduler(engine) as sched:
        occupants = [sched.submit(p, 40) for p in _prompts(MAX_SLOTS, 9)]
        deadline = time.monotonic() + 30
        while sched.free_slots and time.monotonic() < deadline:
            time.sleep(0.002)
        assert sched.free_slots == 0
        queued_be = [sched.submit(p, 2) for p in _prompts(3, 10)]
        ls = sched.submit(_prompts(1, 11)[0], 2,
                          request_class=LATENCY_SENSITIVE)
        for f in [ls, *occupants, *queued_be]:
            f.result(timeout=60)
        assert sched.drain(timeout=30)
    post = [cls for _, cls in sched.admit_log[MAX_SLOTS:]]
    assert post == [LATENCY_SENSITIVE] + [BEST_EFFORT] * 3


def test_submit_validation_and_backpressure(engine):
    with DecodeScheduler(engine, max_queue=2) as sched:
        with pytest.raises(ValueError, match="empty prompt"):
            sched.submit(np.zeros(0, np.int32), 4)
        with pytest.raises(ValueError, match="max_seq"):
            sched.submit(np.zeros(60, np.int32), 8)
        with pytest.raises(ValueError, match="request class"):
            sched.submit(np.zeros(4, np.int32), 2, request_class="vip")
        with pytest.raises(ValueError, match="vocab"):
            sched.submit(np.asarray([3, 64], np.int32), 2)
        # fill the slots one at a time (max_queue also caps un-admitted
        # submissions), then the queue
        blockers = []
        deadline = time.monotonic() + 30
        for p in _prompts(MAX_SLOTS, 12):
            blockers.append(sched.submit(p, 40))
            while sched.queue_depth and time.monotonic() < deadline:
                time.sleep(0.002)
        while sched.free_slots and time.monotonic() < deadline:
            time.sleep(0.002)
        queued = []
        with pytest.raises(QueueFullError):
            for p in _prompts(8, 13):
                queued.append(sched.submit(p, 2))
        assert sched.metrics.rejected_queue_full == 1
        for f in blockers + queued:
            f.result(timeout=60)
    with pytest.raises(ShuttingDownError):
        sched.submit(np.zeros(4, np.int32), 2)


def test_close_fails_pending_and_joins_thread(engine):
    sched = DecodeScheduler(engine)
    futs = [sched.submit(p, 40) for p in _prompts(2 * MAX_SLOTS, 14)]
    sched.close()
    for f in futs:
        assert f.done()
        if f.exception() is not None:
            assert isinstance(f.exception(), ShuttingDownError)
    assert not sched._thread.is_alive()
    sched.close()  # idempotent


def test_init_lm_for_serving_rejects_non_lm():
    with pytest.raises(ValueError):
        init_lm_for_serving("mlp")


# -- entry points ------------------------------------------------------------

def test_cli_decode_on_cpu(capsys):
    summary = serve_cli.main(["--decode", "--device=cpu", "--requests=16",
                              "--concurrency=8", "--max_slots=4"])
    assert summary["ok"] == 16 and summary["errors"] == 0
    assert summary["device"] == "cpu" and summary["model"] == "causal_tiny"
    assert summary["kv"]["layout"] == "dense"
    assert summary["decode_steps"] > 0 and "token_times" not in summary
    assert '"ok": 16' in capsys.readouterr().out


@pytest.mark.parametrize("entry", ["cli", "bench"])
def test_decode_entry_points_need_a_gpu_unless_asked_for_cpu(entry):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(SystemExit) as exc:
        if entry == "cli":
            serve_cli.main(["--decode", "--requests=1"])
        else:
            bench.main(["--serve", "--decode", "--requests=1"])
    assert "error: no CUDA device" in str(exc.value)
