"""The masked forward at Sq > 1 against the JAX package, on the CPU.

Since the masked forward at Sq > 1 runs the flash forward kernels with
per-row lengths (`ops/kernels/flash_attention.py launch_forward`), these
tests hold what the CPU can see of that route: the launch plan the
wrapper computes for it (the C entry computes the same one; a card test,
tests/test_torch_cuda.py, holds the two together), the plain version the
card's kernels are held to, against the reference Pallas kernel in
interpret mode (`_masked_flash_fwd_impl`, out and lse), and a ViT-Tiny
forward under a zoo bucket's token mask against the JAX package's.

The same numpy-seeded inputs go to both packages. Tolerances: out within
1e-2 (bf16) or 1e-5 (f32: sums in another order) of the largest value,
the lse within 1e-5 of the largest, the ViT's f32 logits within 1e-4 of
the largest; and in bf16 at least 0.999 of the outputs equal to the
reference's, since the plain version follows its streamed rule (the
unnormalized p rounded to bf16, over blocks of 128 keys).
"""

from __future__ import annotations

import importlib
import importlib.util
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_mnist_tpu.models import get_model as jget_model
from dist_mnist_tpu.serve.zoo import default_seq_grid
from dist_mnist_tpu_torch.convert import params_from_jax
from dist_mnist_tpu_torch.models.registry import get_model as tget_model
from dist_mnist_tpu_torch.ops.kernels import flash_attention as tfa
from dist_mnist_tpu_torch.ops.kernels import masked_flash as tmf

# the package re-exports `flash_attention` (the function) over its module
jfa = importlib.import_module("dist_mnist_tpu.ops.pallas.flash_attention")

#: the largest dynamic shared memory one H100 block may take (227 KB)
SMEM_LIMIT = 232_448


@pytest.fixture(scope="module", autouse=True)
def _own_temp_root(tmp_path_factory):
    """A temp root of this module's own, set before the session's
    per-test leak check reads it: that check looks for stray temp dirs,
    and tests that run at the same time in other processes make such dirs
    under the shared root. What these tests leak still lands where the
    check looks."""
    shared = tempfile.tempdir
    tempfile.tempdir = str(tmp_path_factory.mktemp("temp_root"))
    yield
    tempfile.tempdir = shared


# -- the launch plan ----------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sk", [65, 128, 129, 300])
@pytest.mark.parametrize("sq", [2, 65, 129, 300])
def test_masked_forward_plan_covers_the_rows_and_fits_a_block(sq, sk, dtype):
    """The masked route's launch, a function of the shape alone: the grid
    (query-row blocks, heads, batch) covers every query row exactly once;
    bf16 blocks are whole warps of 16 rows (at most 8), holding every key
    padded to 16 up to 128 keys (the one-pass kernel) and tiles of 64
    above (the tiled one); f32 blocks follow `f32_forward_plan`; at every
    head dim a block's shared memory fits the 227 KB an H100 block may
    take."""
    for b, h in ((1, 1), (3, 2), (64, 3), (1024, 8)):
        for d in (1, 16, 17, 40, 64, 65, 128):
            plan = tfa.forward_plan(b, sq, sk, h, d, dtype)
            assert plan == tfa.forward_plan(b, sq, sk, h, d, dtype)
            gx, gy, gz, threads, smem, rows, tile = plan
            assert (gy, gz) == (h, b)
            assert gx * rows >= sq > (gx - 1) * rows
            assert threads % 32 == 0 and 32 <= threads <= 256
            assert 0 < smem <= SMEM_LIMIT
            if dtype == torch.bfloat16:
                assert rows == threads // 32 * 16 <= 128
                assert (sq <= rows < sq + 16) if sq <= 128 else rows == 128
                assert tile == (-(-sk // 16) * 16 if sk <= 128 else 64)
                assert smem == 2 * (tfa.padded_head_dim(d) + 8) * (
                    rows + 2 * tile)
            else:
                assert (rows, tile, threads) == tfa.f32_forward_plan(
                    b, sq, sk, h, d)
                assert smem == tfa.f32_forward_smem(rows, tile, d)
            assert tmf.masked_forward_body(sq, sk, dtype) == \
                tfa.forward_body(sk, dtype)


def test_masked_forward_plan_at_vit_shape():
    """ViT-Tiny's masked call (B = 64, S = 65, H = 3, D = 64): in bf16 one
    block of 5 warps per (b, h) holding 80 padded keys (192 blocks, the
    unmasked forward's launch), in f32 two groups of 36 query rows per
    (b, h) against one tile of 68 keys (384 blocks of 160 threads)."""
    assert tfa.forward_plan(64, 65, 65, 3, 64, torch.bfloat16) == (
        1, 3, 64, 160, 2 * 72 * (80 + 160), 80, 80)
    assert tfa.forward_plan(64, 65, 65, 3, 64, torch.float32) == (
        2, 3, 64, 160, 57_584, 36, 68)


# -- the plain version against the reference kernel ---------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,sk", [(5, 65), (5, 200), (65, 65), (65, 200)])
def test_masked_forward_out_and_lse_match_jax(sq, sk, dtype):
    """The port's masked forward on the CPU (the plain version the card's
    kernels are held to) against the reference `_masked_flash_fwd_impl`
    in interpret mode, the same bf16 or f32 inputs: B = 3, H = 2, D = 16,
    lengths 1, a middle one and Sk."""
    b, h, d = 3, 2, 16
    rng = np.random.default_rng(sq * 1000 + sk)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, sq, h, d), (b, sk, h, d), (b, sk, h, d)))
    lens = np.asarray([1, sk // 2 + 3, sk], np.int32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    want_out, want_lse, want_vis = jfa._masked_flash_fwd_impl(
        jq, jk, jv, jnp.asarray(lens), block_q=128,
        block_k=min(128, -(-sk // 128) * 128), interpret=True)
    want_out = np.asarray(want_out.astype(jnp.float32))
    want_lse = np.asarray(want_lse)[:, :sq].reshape(b, h, sq)
    np.testing.assert_array_equal(np.asarray(want_vis)[:, :sq].reshape(
        b, h, sq)[:, 0, 0], -(-lens // 128))
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    out, lse = tmf.masked_flash_attention_forward(tq, tk, tv,
                                                  torch.from_numpy(lens))
    assert out.dtype == tdt and lse.dtype == torch.float32
    assert out.shape == (b, sq, h, d) and lse.shape == (b, h, sq)
    tol = 1e-2 if dtype == "bfloat16" else 1e-5
    err = float(np.max(np.abs(out.float().numpy() - want_out)))
    assert err <= tol * float(np.max(np.abs(want_out)))
    lse_err = float(np.max(np.abs(lse.numpy() - want_lse)))
    assert lse_err <= 1e-5 * float(np.max(np.abs(want_lse)))
    # the probe's visits: the port's 32-key steps, ceil(len / 32)
    _, vis = tmf.masked_flash_attention_probe(tq, tk, tv,
                                              torch.from_numpy(lens))
    np.testing.assert_array_equal(vis[:, 0, 0].numpy(), -(-lens // 32))


#: the least share of bf16 outputs equal to the reference's: the plain
#: version follows its streamed rule over 128-key blocks, so only an exp or
#: a sum that rounds the other way sets one apart (the normalized rule,
#: the plain version's before, matched 0.58-0.71 of them)
BF16_EQUAL_MIN = 0.999


@pytest.mark.parametrize("sq,sk", [(65, 65), (5, 200)])
def test_masked_forward_bf16_equals_jax(sq, sk):
    """The port's bf16 masked forward on the CPU against the JAX package's
    `masked_flash_attention` in interpret mode (its default block_k 128),
    the same numpy-seeded inputs at B = 3, H = 2, D = 16 and lengths 1, a
    middle one and Sk: at least `BF16_EQUAL_MIN` of the outputs equal
    bit for bit, the rest within one bf16 ulp of the largest output."""
    b, h, d = 3, 2, 16
    rng = np.random.default_rng(7 * sq + sk)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, sq, h, d), (b, sk, h, d), (b, sk, h, d)))
    lens = np.asarray([1, sk // 2 + 3, sk], np.int32)
    want = jfa.masked_flash_attention(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)),
        jnp.asarray(lens), interpret=True)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    got = tmf.masked_flash_attention(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
        torch.from_numpy(lens)).float()
    share = float((got == want).float().mean())
    assert share >= BF16_EQUAL_MIN, share
    assert float((got - want).abs().max()) <= 2 ** -7 * float(
        want.abs().max())


def test_masked_share_tells_the_streamed_rule_from_the_normalized_one():
    """`chip_smoke.masked_share`'s limit, on its shapes (B = 64, S = 33
    and 65, and the zoo grid's B = 32, S = 9 and 17 with its lengths; H =
    3, D = 64, bf16): the normalized rule (p / l rounded to
    bf16 before p @ V, what the `masked_normalized_rule` mutant makes the
    one-pass kernel compute) stays within the 1e-2 limit of
    `masked_parity` yet leaves fewer than `MASKED_MATCH_MIN` of the
    outputs equal to the plain version's bf16 values."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    gen = torch.Generator().manual_seed(35)
    zoo = smoke.zoo_cell_lengths(np.random.default_rng(9))
    for b, s_len, lengths in ((64, 33, smoke.masked_lengths(64, 33)),
                              (64, 65, smoke.masked_lengths(64, 65)),
                              (smoke.ZOO_B, 9, zoo[9]),
                              (smoke.ZOO_B, 17, zoo[17])):
        q, k, v = (torch.randn(b, s_len, 3, 64, generator=gen)
                   .to(torch.bfloat16) for _ in range(3))
        lens = torch.tensor(lengths, dtype=torch.int32)
        want = tmf.masked_flash_attention_reference(q, k, v, lens)
        w = torch.softmax(tfa._scores(q, k, lens), dim=-1).to(torch.bfloat16)
        normalized = torch.einsum("bhqk,bkhd->bqhd", w.float(),
                                  v.float()).to(torch.bfloat16)
        err = float((normalized.float() - want.float()).abs().max())
        assert err <= 1e-2 * float(want.float().abs().max())
        assert smoke.bf16_match_share([want], [want]) == 1.0
        assert smoke.bf16_match_share([normalized], [want]) < \
            smoke.MASKED_MATCH_MIN


# -- a ViT forward under a zoo bucket's token mask ----------------------------

#: the small ViT here: depth 2, dim 32, 2 heads of 16, patch 4 (a 16 x 32
#: bucket image is 32 patch tokens and CLS, as at full width), f32
SMALL_VIT = dict(depth=2, dim=32, heads=2, patch=4, scan_blocks=True,
                 dropout_rate=0.0)


@pytest.mark.parametrize("jax_impl", ["flash", "xla"])
def test_masked_vit_forward_matches_jax(jax_impl):
    """ViT-Tiny's layout at a small width serving the zoo's height-16
    bucket of 32 x 32 images: each row's real height from 9..16, the rows
    below it zero, the token mask from the JAX package's
    `SeqGrid.mask`. The port's `"flash"` path (the masked forward at
    Sq = 33 and its plain version on the CPU) against the JAX ViT's
    `apply(..., mask=)` with its masked Pallas kernel in interpret mode,
    and with its `"xla"` attention; params carried by `params_from_jax`."""
    jmodel = jget_model("vit_tiny", compute_dtype=jnp.float32,
                        attention_impl=jax_impl, **SMALL_VIT)
    tmodel = tget_model("vit_tiny", compute_dtype=torch.float32,
                        attention_impl="flash", **SMALL_VIT)
    jparams, _ = jmodel.init(jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 3)))
    jparams = jax.device_get(jparams)
    rng = np.random.default_rng(5)
    heights = rng.integers(9, 17, size=6)
    heights[:2] = [9, 16]
    x = rng.random((6, 16, 32, 3), dtype=np.float32)
    for row, hgt in enumerate(heights):
        x[row, hgt:] = 0.0
    mask = default_seq_grid((32, 32, 3), 4).mask(heights, 16)
    assert mask.shape == (6, 32) and sorted(set(mask.sum(1))) == [24, 32]
    want, _ = jmodel.apply(jparams, {}, jnp.asarray(x), mask=jnp.asarray(mask))
    want = np.asarray(want)
    before = tmf.masked_flash_attention.launches
    with torch.no_grad():
        got, _ = tmodel.apply(params_from_jax(jparams), {},
                              torch.from_numpy(x),
                              mask=torch.from_numpy(mask))
    assert tmf.masked_flash_attention.launches == before  # no kernel here
    assert got.shape == (6, 10) and got.dtype == torch.float32
    err = float(np.max(np.abs(got.numpy() - want)))
    assert err <= 1e-4 * float(np.max(np.abs(want)))
