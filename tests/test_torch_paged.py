"""Parity of the port's decode kernels' plain versions and its paged KV
cache against the JAX package, on the CPU.

The same numpy-seeded inputs go through both packages. The JAX kernels
run in Pallas interpret mode (their off-TPU parity surface); the port's
wrappers take their plain versions for CPU tensors — the CUDA kernels run
only on the card (tests/test_torch_cuda.py). Tolerances: 1e-5 abs for
the attention outputs (f32 softmax and products summed in another order),
bits for `quantize_kv` and for everything computed from integers (page
counts, costs, residency).

Geometry (small): dim 32, 2 heads, depth 2, max_seq 64, pages of 8
tokens (8 pages per slot), 4 slots.
"""

from __future__ import annotations

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dist_mnist_tpu.ops.pallas.paged_attention as jpaged
from dist_mnist_tpu.ops.pallas.flash_attention import (
    masked_flash_attention as jax_masked_flash,
    masked_flash_attention_probe as jax_masked_flash_probe,
    masked_flash_flops as jax_masked_flash_flops,
)
from dist_mnist_tpu.ops.quant import QuantizedArray as JQuantizedArray
from dist_mnist_tpu.ops.quant import quantize_kv as jax_quantize_kv
from dist_mnist_tpu.serve import build_decode_engine as jax_build_engine
from dist_mnist_tpu.serve import CompiledModelCache
from dist_mnist_tpu_torch.bench import decode_forced_agreement
from dist_mnist_tpu_torch.models.causal_lm import CausalLMTiny
from dist_mnist_tpu_torch.ops.kernels.masked_flash import (
    BLOCK_K,
    masked_flash_attention,
    masked_flash_attention_launch_floor,
    masked_flash_attention_probe,
    masked_flash_cost,
    masked_flash_flops,
    masked_forward_body,
    masked_key_blocks,
)
from dist_mnist_tpu_torch.ops.kernels.paged_attention import (
    decode_launch_plan,
    paged_attention,
    paged_attention_cost,
    paged_attention_launch_floor,
    paged_attention_pages,
    paged_attention_probe,
)
from dist_mnist_tpu_torch.ops.quant import QuantizedArray, quantize_kv
from dist_mnist_tpu_torch.serve import (
    DecodeScheduler,
    build_decode_engine,
    make_prompts,
    run_decode_loadgen,
)
from dist_mnist_tpu_torch.serve.decode import DecodeEngine
from dist_mnist_tpu_torch.serve.zoo import default_decode_grid

LM_KW = dict(vocab_size=64, dim=32, depth=2, heads=2, max_seq=64)
PAGE_T = 8
PPS = LM_KW["max_seq"] // PAGE_T
MAX_SLOTS = 4
PAGED_KW = dict(LM_KW, cache_layout="paged", kv_page_tokens=PAGE_T)
INT8_KW = dict(PAGED_KW, kv_quant="int8")
TOL = 1e-5


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


def _pools(rng, n_pages, t=PAGE_T, h=2, d=16):
    """The same int8 K/V pools for both packages: float pages quantized
    by the JAX `quantize_kv` (the port's is pinned bitwise to it below)."""
    out = []
    for _ in range(2):
        x = rng.standard_normal((n_pages, t, h, d)).astype(np.float32)
        q, s = jax_quantize_kv(jnp.asarray(x))
        out.append((np.array(q), np.array(s)))
    jp = [JQuantizedArray(jnp.asarray(q), jnp.asarray(s), "kv_head")
          for q, s in out]
    tp = [QuantizedArray(torch.from_numpy(q), torch.from_numpy(s), "kv_head")
          for q, s in out]
    return jp, tp


# -- quantize_kv -------------------------------------------------------------

@pytest.mark.parametrize("shape,zero_token", [((5, 8, 2, 16), False),
                                              ((3, 1, 4, 8), True)])
def test_quantize_kv_bitwise_equal_to_jax(shape, zero_token):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    if zero_token:
        x[1, 0, 2] = 0.0  # one all-zero token/head: the _EPS floor
    want_q, want_s = jax_quantize_kv(jnp.asarray(x))
    got_q, got_s = quantize_kv(torch.from_numpy(x))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    assert tuple(got_s.shape) == shape[:-1] + (1,)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy().view(np.int32),
                                  np.asarray(want_s).view(np.int32))


# -- paged_attention ---------------------------------------------------------

@pytest.mark.parametrize("n_pages", [1, 2, PPS])
def test_paged_attention_plain_matches_jax_kernel(n_pages):
    """The port's plain version against the Pallas kernel in interpret
    mode, at the int8 grid's page buckets, random tables and ragged
    lengths; visits equal the JAX probe's."""
    rng = np.random.default_rng(20 + n_pages)
    rows, pool = MAX_SLOTS + 1, 12
    (jk, jv), (tk, tv) = _pools(rng, pool)
    q = rng.standard_normal((rows, 1, 2, 16)).astype(np.float32)
    table = np.stack([rng.choice(pool, size=n_pages, replace=False)
                      for _ in range(rows)]).astype(np.int32)
    lengths = rng.integers(1, n_pages * PAGE_T + 1,
                           size=rows).astype(np.int32)
    lengths[0] = n_pages * PAGE_T  # a row that fills its table
    want, want_vis = jpaged.paged_attention_probe(
        jnp.asarray(q), jk, jv, jnp.asarray(table), jnp.asarray(lengths),
        interpret=True)
    got = paged_attention(torch.from_numpy(q), tk, tv,
                          torch.from_numpy(table), torch.from_numpy(lengths))
    _, vis = paged_attention_probe(torch.from_numpy(q), tk, tv,
                                   torch.from_numpy(table),
                                   torch.from_numpy(lengths))
    assert got.shape == (rows, 1, 2, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)
    np.testing.assert_array_equal(vis.numpy(), np.asarray(want_vis))


def test_paged_attention_dispatch_through_the_jax_model(monkeypatch):
    """One int8 paged decode step of the JAX model with its paged
    dispatch forced onto the Pallas kernel (interpret mode) against the
    port's model, whose wrapper takes the plain version on the CPU."""
    from dist_mnist_tpu.models.causal_lm import CausalLMTiny as JaxLM
    from dist_mnist_tpu_torch.convert import params_from_jax

    monkeypatch.setattr(jpaged, "PAGED_ATTENTION", "pallas")
    jm, tm = JaxLM(**INT8_KW), CausalLMTiny(**INT8_KW)
    jparams, _ = jm.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.device_get(jparams))
    rng = np.random.default_rng(5)
    rows, plen = 2, 11
    prompt = rng.integers(0, 64, size=(rows, 16), dtype=np.int32)
    slots = np.arange(rows, dtype=np.int32)
    lengths = np.full(rows, plen, np.int32)
    table = np.arange(rows * PPS, dtype=np.int32).reshape(rows, PPS)
    _, jcache = jm.prefill(jparams, jm.init_cache(rows), prompt, slots,
                           lengths, page_table=table)
    tcache = tm.init_cache(rows)
    tm.prefill(tparams, tcache, torch.from_numpy(prompt),
               torch.from_numpy(slots), torch.from_numpy(lengths),
               page_table=torch.from_numpy(table))
    tok = prompt[:, plen - 1]
    pos = np.full(rows, plen, np.int32)
    want, _ = jm.decode_step(jparams, jcache, tok, pos,
                             page_table=table[:, :2])
    got, _ = tm.decode_step(tparams, tcache, torch.from_numpy(tok),
                            torch.from_numpy(pos),
                            page_table=torch.from_numpy(table[:, :2].copy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


def test_paged_attention_cost_and_pages_match_reference():
    lengths = np.asarray([1, PAGE_T, PAGE_T + 1, PPS * PAGE_T, 3 * PAGE_T])
    for n in (1, 2, PPS):
        want = jpaged.paged_attention_cost(lengths, n, PAGE_T, 2, 16)
        got = paged_attention_cost(lengths, n, PAGE_T, 2, 16)
        assert got["flops"] == want["flops"]
        assert got["hbm_bytes"] == want["hbm_bytes"]
        # only the active pages count toward what the kernel reads
        active = np.minimum(-(-lengths // PAGE_T), n)
        tiles = int(active.sum()) * 2 * 2 * (PAGE_T * 16 + PAGE_T * 4)
        assert got["active_bytes"] == tiles + 2 * 5 * 2 * 16 * 4 \
            + 5 * n * 4 + 5 * 4
    np.testing.assert_array_equal(
        paged_attention_pages(torch.from_numpy(lengths), PAGE_T).numpy(),
        np.asarray(jpaged.paged_attention_pages(lengths, PAGE_T)))


@pytest.mark.parametrize("case", ["float_pool", "q_rank", "q_dtype",
                                  "table_rows", "table_dtype", "lengths_rows",
                                  "head_dim", "noncontiguous", "scale_shape"])
def test_paged_attention_rejects_bad_inputs(case):
    rng = np.random.default_rng(0)
    _, (tk, tv) = _pools(rng, 4)
    q = torch.zeros(3, 1, 2, 16)
    table = torch.zeros(3, 2, dtype=torch.int32)
    lengths = torch.ones(3, dtype=torch.int32)
    if case == "float_pool":
        tk = tk.q.float()
    elif case == "q_rank":
        q = q[:, 0]
    elif case == "q_dtype":
        q = q.to(torch.float16)
    elif case == "table_rows":
        table = table[:2]
    elif case == "table_dtype":
        table = table.long()
    elif case == "lengths_rows":
        lengths = lengths[:2]
    elif case == "head_dim":
        _, (tk, tv) = _pools(rng, 4, d=160)
        q = torch.zeros(3, 1, 2, 160)
    elif case == "noncontiguous":
        q = torch.zeros(3, 1, 16, 2).transpose(2, 3)
    elif case == "scale_shape":
        tk = QuantizedArray(tk.q, tk.scale[..., 0], "kv_head")
    with pytest.raises((ValueError, TypeError)):
        paged_attention(q, tk, tv, table, lengths)


# -- masked_flash_attention --------------------------------------------------

@pytest.mark.parametrize("sq,sk", [(1, 64), (8, 64), (1, 200)])
def test_masked_flash_plain_matches_jax(sq, sk):
    rng = np.random.default_rng(sq + sk)
    b, h, d = 3, 2, 16
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, h, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, h, d)).astype(np.float32)
    lengths = np.asarray([1, sk, sk // 2 + 3], np.int32)
    want = jax_masked_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(lengths))
    got = masked_flash_attention(*(torch.from_numpy(a)
                                   for a in (q, k, v, lengths)))
    assert got.shape == (b, sq, h, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


def test_masked_flash_probe_visits_and_flops():
    """Visits count the port's own key blocks (BLOCK_K = 32), where the
    reference's count 128-key blocks; the FLOP counts agree with the
    reference's at the same block size."""
    rng = np.random.default_rng(3)
    b, sq, sk, h, d = 4, 2, 100, 2, 16
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((b, sq, h, d), (b, sk, h, d), (b, sk, h, d)))
    lengths = torch.tensor([1, 32, 33, 100], dtype=torch.int32)
    out, vis = masked_flash_attention_probe(q, k, v, lengths)
    torch.testing.assert_close(out, masked_flash_attention(q, k, v, lengths),
                               rtol=0, atol=0)
    want = np.asarray([1, 1, 2, 4], np.float32)
    np.testing.assert_array_equal(vis.numpy(),
                                  np.broadcast_to(want[:, None, None],
                                                  (b, h, sq)))
    np.testing.assert_array_equal(masked_key_blocks(lengths).numpy(),
                                  want.astype(np.int32))
    _, jvis = jax_masked_flash_probe(*(jnp.asarray(t.numpy())
                                       for t in (q, k, v, lengths)))
    np.testing.assert_array_equal(np.asarray(jvis), np.ones((b, h, sq)))
    for bk in (BLOCK_K, 128):
        assert masked_flash_flops(lengths.numpy(), sq, h, d, bk) == \
            jax_masked_flash_flops(lengths.numpy(), sq, h, d, bk)


@pytest.mark.parametrize("case", ["lengths_dtype", "mixed_dtype", "kv_shape",
                                  "head_dim"])
def test_masked_flash_rejects_bad_inputs(case):
    q = torch.zeros(2, 1, 2, 16)
    k = torch.zeros(2, 8, 2, 16)
    v = torch.zeros(2, 8, 2, 16)
    lengths = torch.ones(2, dtype=torch.int32)
    err = (ValueError, TypeError)
    if case == "lengths_dtype":
        lengths = lengths.long()
    elif case == "mixed_dtype":
        k = k.to(torch.bfloat16)
    elif case == "kv_shape":
        v = torch.zeros(2, 9, 2, 16)
    elif case == "head_dim":
        q, k, v = (torch.zeros(2, s, 2, 160) for s in (1, 8, 8))
    with pytest.raises(err):
        masked_flash_attention(q, k, v, lengths)


@pytest.mark.parametrize("rows,heads,d,lanes", [
    (9, 8, 16, 1),  # the decode path: a lane a token, 72 warps
    (9, 8, 8, 1),
    (9, 8, 17, 2),
    (3, 2, 32, 2),
    (3, 2, 64, 4),  # the masked backward's Sq = 1 case
    (1, 1, 65, 8),
    (1, 1, 128, 8),
    (1025, 3, 40, 4),
])
def test_decode_launch_plan(rows, heads, d, lanes):
    """One warp per (row, head), a block each on the grid (heads, rows);
    the lanes that share a token cover head_dim 16 dimensions each, the
    fewest such lanes that is a power of two."""
    assert decode_launch_plan(rows, heads, d) == (lanes, heads, rows, 32)
    assert 32 % lanes == 0 and lanes * 16 >= d
    assert lanes == 1 or lanes * 8 < d


@pytest.mark.parametrize("sq,sk,dtype,body", [
    (1, 4096, torch.float32, "masked_flash_decode_kernel"),
    (2, 100, torch.bfloat16, "flash_fwd_mma_onepass"),
    (65, 65, torch.bfloat16, "flash_fwd_mma_onepass"),
    (300, 300, torch.bfloat16, "flash_fwd_mma_tiled"),
    (7, 256, torch.float32, "flash_fwd_f32"),
    (128, 256, torch.float32, "flash_fwd_f32"),
])
def test_masked_forward_body(sq, sk, dtype, body):
    """Sq = 1 takes the decode kernel; above it the flash forward's
    kernels with the lengths: bf16 one pass up to 128 keys and tiles
    above, f32 the register-tiled kernel."""
    assert masked_forward_body(sq, sk, dtype) == body


def test_launch_floors_refuse_cpu_tensors():
    """The empty-kernel launches time the card's launch floor; on the CPU
    there is nothing to launch, and they say so."""
    rng = np.random.default_rng(4)
    pool = QuantizedArray(*quantize_kv(torch.from_numpy(
        rng.standard_normal((4, PAGE_T, 2, 16)).astype(np.float32))),
        "kv_head")
    q = torch.zeros(2, 1, 2, 16)
    table = torch.zeros(2, 2, dtype=torch.int32)
    lengths = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention_launch_floor(q, pool, pool, table, lengths)
    k = torch.zeros(2, 8, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        masked_flash_attention_launch_floor(q, k, k, lengths)


def test_masked_flash_cost_by_operand_size():
    """The bytes scale with the operands' size and the lengths' 4 bytes do
    not; the operations do not depend on the dtype."""
    lengths = [2, 33, 65]
    f32 = masked_flash_cost(lengths, 65, 3, 64)
    bf16 = masked_flash_cost(lengths, 65, 3, 64, itemsize=2)
    assert f32["flops"] == bf16["flops"] == 2 * 2 * 65 * 64 * 3 * 100
    assert f32["hbm_bytes"] - 12 == 2 * (bf16["hbm_bytes"] - 12)
    assert f32["hbm_bytes"] == (2 * 3 * 65 * 3 * 64 + 2 * 100 * 3 * 64) * 4 \
        + 12


# -- the paged model and engine ----------------------------------------------

def test_paged_float_decode_bitwise_dense_every_position():
    model = CausalLMTiny(**LM_KW)
    paged = CausalLMTiny(**PAGED_KW)
    params, _ = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    b, plen = 2, 9
    prompt = torch.from_numpy(rng.integers(0, 64, size=(b, plen),
                                           dtype=np.int32))
    slots = torch.arange(b, dtype=torch.int32)
    lengths = torch.full((b,), plen, dtype=torch.int32)
    table = torch.arange(b * PPS, dtype=torch.int32).reshape(b, PPS)
    d_cache, p_cache = model.init_cache(b), paged.init_cache(b)
    d_last, _ = model.prefill(params, d_cache, prompt, slots, lengths)
    p_last, _ = paged.prefill(params, p_cache, prompt, slots, lengths,
                              page_table=table)
    assert torch.equal(p_last, d_last)
    tok = d_last.argmax(-1).to(torch.int32)
    pos = torch.full((b,), plen, dtype=torch.int32)
    for _ in range(12):
        d_log, _ = model.decode_step(params, d_cache, tok, pos)
        p_log, _ = paged.decode_step(params, p_cache, tok, pos,
                                     page_table=table)
        assert torch.equal(p_log, d_log)
        tok = d_log.argmax(-1).to(torch.int32)
        pos = pos + 1


def test_default_grid_page_buckets():
    flt = default_decode_grid(CausalLMTiny(**PAGED_KW), max_slots=MAX_SLOTS)
    assert flt.decode_page_buckets == (PPS,)
    i8 = default_decode_grid(CausalLMTiny(**INT8_KW), max_slots=MAX_SLOTS)
    assert i8.decode_page_buckets == (1, 2, 4, PPS)
    assert i8.admit_buckets == (MAX_SLOTS,)
    assert [c for c in i8.cells() if c[0] == "decode"] == \
        [("decode", p) for p in (1, 2, 4, PPS)]
    assert i8.decode_page_bucket_for(3) == 4
    with pytest.raises(ValueError):
        i8.decode_page_bucket_for(PPS + 1)


def _engine(**kw):
    return build_decode_engine("cpu", max_slots=MAX_SLOTS, **kw)


def test_pages_balance_after_drain_and_only_scratch_collides():
    """A drained run leaves no page pinned and the free list whole (each
    page once); while requests run, every live slot's pages are its own:
    no two table rows share a page outside the scratch stripe, which is
    what makes the undefined winner of duplicate scatter writes harmless."""
    eng = _engine(**INT8_KW)
    free0 = sorted(eng._free_pages)
    scratch = set(eng._scratch_pages.tolist())
    seen = []
    reserve = eng.try_reserve

    def checked_reserve(slot, total):
        ok = reserve(slot, total)
        live = [p for pages in eng._slot_pages.values() for p in pages]
        seen.append(len(live))
        assert len(live) == len(set(live)) and not scratch & set(live)
        for r, row in enumerate(eng._page_table):
            if r not in eng._slot_pages:
                assert set(row.tolist()) <= scratch
        return ok

    eng.try_reserve = checked_reserve
    with DecodeScheduler(eng, mode="continuous") as sched:
        res = run_decode_loadgen(sched, n_requests=12, concurrency=6,
                                 seed=7)
        assert sched.drain(timeout=60.0)
    assert res["ok"] == 12 and max(seen) > 0
    stats = eng.kv_stats()
    assert stats["kv_pages_pinned"] == 0
    assert sorted(eng._free_pages) == free0
    assert all((row == eng._scratch_pages).all() for row in eng._page_table)


def test_kv_stats_equal_the_jax_engine(mesh1):
    """Residency is arithmetic: the same reservations on the JAX engine
    and the port's give the same `kv_stats`, field for field, for the
    dense, paged-float and int8 layouts."""
    for kw in (LM_KW, PAGED_KW, INT8_KW):
        jeng = jax_build_engine(mesh1, max_slots=MAX_SLOTS,
                                cache=CompiledModelCache(), **kw)
        teng = _engine(**kw)
        assert teng.kv_stats() == jeng.kv_stats()
        for slot, total in ((0, 9), (1, 40), (2, 64), (3, 1)):
            assert teng.try_reserve(slot, total) == \
                jeng.try_reserve(slot, total)
        teng.release_slot(1)
        jeng.release_slot(1)
        assert teng.try_reserve(1, 17) == jeng.try_reserve(1, 17)
        assert teng.kv_stats() == jeng.kv_stats()


def test_undersized_pool_defers_then_completes():
    from dist_mnist_tpu_torch.serve import init_lm_for_serving

    model, params = init_lm_for_serving("causal_tiny", seed=0, **PAGED_KW)
    grid = default_decode_grid(model, max_slots=MAX_SLOTS)
    # scratch stripe + one full slot: long requests must queue for pages
    eng = DecodeEngine(model, params, "cpu", grid=grid, num_pages=2 * PPS)
    with DecodeScheduler(eng, mode="continuous") as sched:
        res = run_decode_loadgen(sched, n_requests=8, concurrency=8, seed=3,
                                 min_prompt=20, max_prompt=30,
                                 keep_streams=True)
    assert res["ok"] == 8 and res["errors"] == 0
    assert eng.kv_stats()["kv_pages_pinned"] == 0


def test_device_table_is_a_frozen_copy_until_dirtied():
    eng = _engine(**INT8_KW)
    tab = eng._device_table(2)
    assert eng._device_table(2) is tab  # cached per width
    before = tab.clone()
    eng._page_table[0, 0] = 0  # a host edit after the "dispatch"
    assert torch.equal(tab, before)
    assert eng.try_reserve(1, 9)
    fresh = eng._device_table(2)
    assert fresh is not tab and torch.equal(
        fresh, torch.from_numpy(eng._page_table[:, :2].copy()))


def _jax_dense_streams(reqs):
    """Greedy streams of the JAX dense model from full forwards: one
    jitted forward over [n, max_seq] per generated position."""
    from dist_mnist_tpu.models.causal_lm import CausalLMTiny as JaxLM
    from dist_mnist_tpu.serve import init_lm_for_serving as jax_init

    jm, jparams = jax_init("causal_tiny", seed=0, **LM_KW)
    fwd = jax.jit(lambda p, t: jm.apply(p, {}, t)[0])
    n = len(reqs)
    seq = np.zeros((n, LM_KW["max_seq"]), np.int32)
    ends = np.zeros(n, np.int64)
    for i, (prompt, _) in enumerate(reqs):
        seq[i, :len(prompt)] = prompt
        ends[i] = len(prompt)
    streams = [[] for _ in range(n)]
    for _ in range(max(new for _, new in reqs)):
        logits = np.asarray(fwd(jparams, seq))
        for i, (_, new) in enumerate(reqs):
            if len(streams[i]) < new:
                tok = int(np.argmax(logits[i, ends[i] - 1]))
                streams[i].append(tok)
                seq[i, ends[i]] = tok
                ends[i] += 1
    assert isinstance(jm, JaxLM)
    return jparams, streams


def test_int8_engine_agrees_with_jax_dense_streams():
    """Teacher-forced next-token agreement of the port's int8 paged
    engine, on the JAX package's weights, with the JAX dense model's
    greedy streams: >= 0.99, the reference's gate."""
    from dist_mnist_tpu_torch.convert import params_from_jax

    reqs = make_prompts(16, max_seq=LM_KW["max_seq"], seed=0, max_new=12,
                        vocab_size=LM_KW["vocab_size"])
    jparams, streams = _jax_dense_streams(reqs)
    model = CausalLMTiny(**INT8_KW)
    eng = DecodeEngine(model, params_from_jax(jax.device_get(jparams)),
                       "cpu", grid=default_decode_grid(model,
                                                       max_slots=MAX_SLOTS))
    hits, total = decode_forced_agreement(eng, reqs, streams)
    assert total == sum(len(s) for s in streams)
    assert hits / total >= 0.99, (hits, total)
    assert eng.kv_stats()["kv_pages_pinned"] == 0


def test_paged_float_streams_equal_dense():
    streams = []
    for kw in (LM_KW, PAGED_KW):
        with DecodeScheduler(_engine(**kw), mode="continuous") as sched:
            res = run_decode_loadgen(sched, n_requests=12, concurrency=8,
                                     seed=7, keep_streams=True)
        assert res["ok"] == 12
        streams.append(res["streams"])
    assert streams[0] == streams[1]
