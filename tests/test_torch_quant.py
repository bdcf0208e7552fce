"""Parity of the port's int8 quantization and `quant_matmul` against the
JAX package.

Inputs come from numpy seeds and go through both packages. The JAX side
of a matmul runs the Pallas `quant_matmul` kernel in interpret mode, as
tests/test_kernels.py does; the port's wrapper takes its plain version
for CPU tensors. The CUDA kernel itself runs only on the card
(tests/test_torch_cuda.py).
"""

from __future__ import annotations

import tempfile

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dist_mnist_tpu.ops import quant as jquant
from dist_mnist_tpu.ops.pallas.quant_matmul import (
    quant_matmul as jax_quant_matmul,
    quant_matmul_cost as jax_quant_matmul_cost,
)
from dist_mnist_tpu_torch.ops import quant as tquant
from dist_mnist_tpu_torch.ops.kernels import quant_matmul as tqmm
from dist_mnist_tpu_torch.ops.kernels.quant_matmul import (
    quant_matmul,
    quant_matmul_cost,
    quant_matmul_reference,
    route_tile,
    split_k_plan,
    vec_loads,
)


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


def _rel_err(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want))) / (float(np.max(np.abs(want)))
                                                + 1e-12)


def _to_np(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.float32).numpy() if t.dtype == torch.bfloat16 \
        else t.numpy()


def _leaf(kind: str) -> np.ndarray:
    rng = np.random.default_rng(7)
    if kind == "dense":
        return rng.standard_normal((48, 200)).astype(np.float32)
    if kind == "hwio":  # conv2-shaped: amax over Cin
        return (0.05 * rng.standard_normal((5, 5, 32, 64))).astype(np.float32)
    w = rng.standard_normal((8, 4)).astype(np.float32)
    w[:, 1] = 0.0  # one all-zero channel -> per-tensor fallback
    return w


@pytest.mark.parametrize("kind,mode", [("dense", "channel"),
                                       ("hwio", "channel"),
                                       ("zero_channel", "tensor")])
def test_quantize_bitwise_equal_to_jax(kind, mode):
    w = _leaf(kind)
    want = jquant.quantize(jnp.asarray(w))
    got = tquant.quantize(torch.from_numpy(w))
    assert got.mode == want.mode == mode
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    # bitwise: compare the f32 payloads as integers
    np.testing.assert_array_equal(got.scale.numpy().view(np.int32),
                                  np.asarray(want.scale).view(np.int32))
    np.testing.assert_array_equal(
        tquant.dequantize(got).numpy(),
        np.asarray(jquant.dequantize(want)))


def test_quantize_rejects_1d():
    with pytest.raises(ValueError):
        tquant.quantize(torch.zeros(8))


@pytest.mark.parametrize("m,d,h", [(8, 48, 200), (8, 3136, 512),
                                   (8, 512, 10)])
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5),
                                       ("bfloat16", 2e-2)])
def test_reference_matches_jax_kernel(m, d, h, dtype, tol):
    """quant_matmul_reference vs the Pallas kernel (interpret mode) at the
    served shapes: LeNet-5 fc1 [3136, 512], fc2 [512, 10], and an odd
    non-tile-multiple [48, 200]."""
    rng = np.random.default_rng(d + h)
    w = rng.standard_normal((d, h)).astype(np.float32)
    x = rng.standard_normal((m, d)).astype(np.float32)
    jqa = jquant.quantize(jnp.asarray(w))
    want = jax_quant_matmul(jnp.asarray(x, dtype), jqa.q, jqa.scale,
                            interpret=True)
    tqa = tquant.quantize(torch.from_numpy(w))
    tdtype = getattr(torch, dtype)
    got = quant_matmul_reference(torch.from_numpy(x).to(tdtype), tqa.q,
                                 tqa.scale)
    assert got.dtype == tdtype and tuple(got.shape) == (m, h)
    assert _rel_err(_to_np(got), np.asarray(want, np.float32)) < tol


def test_wrapper_takes_plain_version_on_cpu_and_keeps_lead_dims():
    rng = np.random.default_rng(3)
    qa = tquant.quantize(torch.from_numpy(
        rng.standard_normal((48, 72)).astype(np.float32)))
    x = torch.from_numpy(rng.standard_normal((4, 5, 48)).astype(np.float32))
    before = quant_matmul.launches
    got = quant_matmul(x, qa.q, qa.scale)
    assert tuple(got.shape) == (4, 5, 72)
    assert torch.equal(got, quant_matmul_reference(x, qa.q, qa.scale))
    assert torch.equal(tquant.q_dot(x, qa), got)
    # a [H] scale is the same layout as [1, H]
    assert torch.equal(quant_matmul(x, qa.q, qa.scale.reshape(-1)), got)
    # the counter counts kernel launches only: the CPU path launches none
    assert quant_matmul.launches == before
    # float weights are a passthrough matmul
    w = torch.from_numpy(rng.standard_normal((48, 72)).astype(np.float32))
    assert torch.equal(tquant.q_dot(x, w), x @ w)


@pytest.mark.parametrize("case", ["x_dtype", "w_dtype", "scale_dtype",
                                  "noncontiguous_x", "noncontiguous_w",
                                  "w_3d", "contraction", "scale_shape"])
def test_wrapper_rejects_bad_inputs(case):
    x = torch.zeros(4, 16)
    q = torch.zeros(16, 8, dtype=torch.int8)
    s = torch.ones(1, 8)
    if case == "x_dtype":
        x = x.to(torch.float16)
    elif case == "w_dtype":
        q = q.to(torch.int16)
    elif case == "scale_dtype":
        s = s.to(torch.bfloat16)
    elif case == "noncontiguous_x":
        x = torch.zeros(16, 4).t()
    elif case == "noncontiguous_w":
        q = torch.zeros(8, 16, dtype=torch.int8).t()
    elif case == "w_3d":
        q = torch.zeros(2, 16, 8, dtype=torch.int8)
    elif case == "contraction":
        x = torch.zeros(4, 15)
    else:
        s = torch.ones(2, 8)
    with pytest.raises((TypeError, ValueError)):
        quant_matmul(x, q, s)


@pytest.mark.parametrize("dtype,rows_per_block", [(torch.float32, 16),
                                                  (torch.bfloat16, 64)])
def test_wrapper_grid_check_follows_each_routes_tiling(dtype,
                                                       rows_per_block):
    """The rows axis is the grid's y axis (at most 65535 blocks), and the
    bf16 kernel's blocks take 64 rows where the f32 kernel's take at most
    16: the last M that fits passes, the next one raises."""
    q = torch.ones(1, 1, dtype=torch.int8)
    s = torch.ones(1)
    top = 65535 * rows_per_block
    assert quant_matmul(torch.ones(top, 1, dtype=dtype), q, s).shape == (
        top, 1)
    with pytest.raises(ValueError, match="grid"):
        quant_matmul(torch.ones(top + 1, 1, dtype=dtype), q, s)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [1, 2, 7, 16, 17, 64, 65, 200, 4096])
def test_split_k_plan_covers_k_exactly(m, dtype):
    """Over a grid of shapes, the MLP's among them, each route's plan is a
    function of (m, k, h) alone: its splits cover every K chunk of its
    tile, none is empty, at most its tile's most splits; tiles x splits
    never pass the tile's blocks by more than one split's worth of tiles.
    The f32 tile's rows are m's power of two, at most 16."""
    tile = route_tile(dtype, m)
    if dtype == torch.float32:
        assert tile.rows == min(16, 1 << (m - 1).bit_length()) >= min(m, 16)
    for k in (0, 1, 63, 64, 65, 100, 512, 784, 1000, 1001, 3136, 100_000):
        for h in (1, 10, 32, 33, 40, 100, 512, 4096):
            tiles, splits, per = split_k_plan(m, k, h, tile)
            assert (tiles, splits, per) == split_k_plan(m, k, h, tile)
            assert tiles == -(-h // tile.cols) * -(-m // tile.rows)
            chunks = max(1, -(-k // tile.chunk))
            assert 1 <= splits <= min(tile.max_splits, chunks)
            assert splits * per >= chunks > (splits - 1) * per
            assert (splits - 1) * tiles < max(tile.blocks, tiles)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_split_k_plan_fills_the_card_at_serve_batch(dtype):
    """bf16, LeNet-5's fc1 at M <= 64: 16 tiles of 32 channels, split 9
    ways over K = 3136 (49 chunks, 6 a split): 144 blocks for 132 SMs.
    f32 (two blocks per SM), the MLP's hidden layer [M, 784] x [784, 100]:
    at M = 1 4 tiles of one row, every one of the 25 chunks of 32 its own
    split (100 blocks); at M = 64 16 tiles of 16 rows x 13 splits (208
    blocks); the output layer (K = 100) has 4 chunks to split."""
    def plan(m, k, h):
        return split_k_plan(m, k, h, route_tile(dtype, m))

    if dtype == torch.bfloat16:
        for m in (1, 7, 16, 17, 64):
            assert plan(m, 3136, 512) == (16, 9, 6)
        assert plan(64, 512, 10) == (1, 8, 1)  # fc2
        return
    assert plan(1, 784, 100) == (4, 25, 1)
    assert plan(64, 784, 100) == (16, 13, 2)
    for m in (1, 2, 7, 16, 17, 64):  # the card's SMs, or every chunk split
        tiles, splits, _ = plan(m, 784, 100)
        assert tiles * splits >= min(tqmm.SMS, tiles * 25)
    assert plan(1, 100, 10) == (1, 4, 1)
    assert plan(64, 100, 10) == (4, 4, 1)


def test_vec_loads_needs_16_byte_rows_and_bases():
    x = torch.zeros(4, 3136, dtype=torch.bfloat16)
    q = torch.zeros(3136, 512, dtype=torch.int8)
    assert vec_loads(x, q) == (True, True)
    assert vec_loads(torch.zeros(4, 1001, dtype=torch.bfloat16),
                     torch.zeros(1001, 10, dtype=torch.int8)) == (False,
                                                                   False)
    flat = torch.zeros(4 * 3136 + 1, dtype=torch.bfloat16)
    assert vec_loads(flat[1:].view(4, 3136), q) == (False, True)


def test_vec_loads_f32_route_takes_4_byte_weight_rows():
    """The f32 route loads x by 16 bytes and q by 4 (one char4 of four
    channels): the MLP's hidden layer (rows of 100 bytes) takes vector
    loads, its output layer (10 bytes) and a K that is not a multiple of 4
    plain ones."""
    assert vec_loads(torch.zeros(4, 784), torch.zeros(
        784, 100, dtype=torch.int8)) == (True, True)
    assert vec_loads(torch.zeros(4, 100), torch.zeros(
        100, 10, dtype=torch.int8)) == (True, False)
    assert vec_loads(torch.zeros(4, 1001), torch.zeros(
        1001, 40, dtype=torch.int8)) == (False, True)
    flat = torch.zeros(4 * 784 + 1)
    assert vec_loads(flat[1:].view(4, 784), torch.zeros(
        784, 100, dtype=torch.int8)) == (False, True)


def test_q_dot_rejects_stacked_quantized_leaf():
    qa = tquant.quantize(torch.randn(2, 16, 8, generator=torch.Generator()
                                     .manual_seed(0)))
    with pytest.raises(ValueError):
        tquant.q_dot(torch.zeros(4, 16), qa)


@pytest.mark.parametrize("x_shape,w_shape,dtype", [
    ((64, 3136), (3136, 512), "bfloat16"),
    ((7, 512), (512, 10), "bfloat16"),
    ((2, 3, 784), (784, 100), "float32"),
])
def test_cost_matches_jax(x_shape, w_shape, dtype):
    assert quant_matmul_cost(x_shape, w_shape, getattr(torch, dtype)) == \
        jax_quant_matmul_cost(x_shape, w_shape, getattr(jnp, dtype))


def test_tree_rule_and_error_report_match_jax():
    rng = np.random.default_rng(11)
    tree = {
        "conv": {"w": (0.1 * rng.standard_normal((5, 5, 1, 4)))
                 .astype(np.float32), "b": np.zeros(4, np.float32)},
        "fc": {"w": rng.standard_normal((12, 6)).astype(np.float32),
               "b": np.zeros(6, np.float32)},
        "norm": {"scale": np.ones((3, 3), np.float32)},  # not a kernel name
    }
    jtree = {k: {n: jnp.asarray(a) for n, a in v.items()}
             for k, v in tree.items()}
    ttree = {k: {n: torch.from_numpy(a) for n, a in v.items()}
             for k, v in tree.items()}
    jq = jquant.quantize_tree(jtree)
    tq = tquant.quantize_tree(ttree)
    assert tquant.is_quantized(tq) and not tquant.is_quantized(ttree)
    assert tquant.quantize_tree(tq)["fc"]["w"] is tq["fc"]["w"]  # idempotent
    for k in ("conv", "fc"):
        assert isinstance(tq[k]["w"], tquant.QuantizedArray)
        assert not isinstance(tq[k]["b"], tquant.QuantizedArray)
        np.testing.assert_array_equal(tq[k]["w"].q.numpy(),
                                      np.asarray(jq[k]["w"].q))
    assert not isinstance(tq["norm"]["scale"], tquant.QuantizedArray)
    # materialize: a float leaf passes through untouched; an int8 one
    # dequantizes with the reference's rounding, here in bf16
    assert tquant.materialize(ttree["fc"]["b"]) is ttree["fc"]["b"]
    np.testing.assert_array_equal(
        _to_np(tquant.materialize(tq["conv"]["w"], torch.bfloat16)),
        np.asarray(jquant.materialize(jq["conv"]["w"], jnp.bfloat16),
                   np.float32))
    want = jquant.error_report(jtree, jq)
    got = tquant.error_report(ttree, tq)
    assert got["n_quantized"] == want["n_quantized"] == 2
    assert set(got["leaves"]) == set(want["leaves"]) == {"conv/w", "fc/w"}
    for name, stats in want["leaves"].items():
        assert got["leaves"][name]["mode"] == stats["mode"]
        assert got["leaves"][name]["max_abs_err"] == pytest.approx(
            stats["max_abs_err"], rel=1e-6)
    assert got["max_rel_err"] == pytest.approx(want["max_rel_err"], rel=1e-6)

