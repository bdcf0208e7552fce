"""Parity of the port's int8 quantization and `quant_matmul` against the
JAX package.

Inputs come from numpy seeds and go through both packages. The JAX side
of a matmul runs the Pallas `quant_matmul` kernel in interpret mode, as
tests/test_kernels.py does; the port's wrapper takes its plain version
for CPU tensors. The CUDA kernel itself runs only on the card
(tests/test_torch_cuda.py).
"""

from __future__ import annotations

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
from dist_mnist_tpu_torch.ops.kernels.quant_matmul import (
    quant_matmul,
    quant_matmul_cost,
    quant_matmul_reference,
)


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

