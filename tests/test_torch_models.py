"""Parity of the port's configs, layers and served models against the JAX
package, on the CPU.

Every model check starts from JAX-initialized params carried across with
`convert.params_from_jax`; inputs are numpy-seeded. int8 runs put the
JAX side's dense layers on the Pallas `quant_matmul` kernel in interpret
mode (FUSED_MATMUL="pallas", read per call), so the port is held to the
kernel's math, not the materialize path's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dist_mnist_tpu import configs as jconfigs
from dist_mnist_tpu.data.datasets import DATASETS as JDATASETS
from dist_mnist_tpu.models.registry import get_model as jget_model
from dist_mnist_tpu.ops import nn as jnn
from dist_mnist_tpu.ops import quant as jquant
from dist_mnist_tpu_torch import configs as tconfigs
from dist_mnist_tpu_torch.convert import params_from_jax
from dist_mnist_tpu_torch.data.datasets import DATASETS as TDATASETS
from dist_mnist_tpu_torch.models.registry import get_model as tget_model
from dist_mnist_tpu_torch.ops import nn as tnn
from dist_mnist_tpu_torch.ops import quant as tquant


def _images(n, shape=(28, 28, 1), seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(n, *shape), dtype=np.uint8)


def _rel_err(got, want) -> float:
    return float(np.max(np.abs(got - want))) / (float(np.max(np.abs(want)))
                                                + 1e-12)


@pytest.mark.parametrize("name", ["mlp_mnist", "lenet5_mnist"])
def test_config_entries_equal_reference_field_for_field(name):
    got, want = tconfigs.get_config(name), jconfigs.get_config(name)
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_dataset_table_equals_reference():
    assert TDATASETS == JDATASETS


@pytest.mark.parametrize("shape,stride,padding", [
    ((2, 28, 28, 1), 1, "SAME"), ((2, 14, 14, 3), 1, "SAME"),
    ((2, 9, 9, 3), 2, "SAME"), ((2, 9, 9, 3), 1, "VALID"),
])
def test_conv2d_nhwc_hwio_matches_reference(shape, stride, padding):
    rng = np.random.default_rng(1)
    x = rng.standard_normal(shape).astype(np.float32)
    p = {"w": (0.2 * rng.standard_normal((5, 5, shape[-1], 6)))
         .astype(np.float32),
         "b": rng.standard_normal(6).astype(np.float32)}
    want = np.asarray(jnn.conv2d({k: jnp.asarray(v) for k, v in p.items()},
                                 jnp.asarray(x), stride=stride,
                                 padding=padding))
    got = tnn.conv2d(params_from_jax(p), torch.from_numpy(x), stride=stride,
                     padding=padding).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_max_pool_and_flatten_keep_nhwc_order():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 14, 14, 64)).astype(np.float32)
    want = np.asarray(jnn.flatten(jnn.max_pool(jnp.asarray(x), 2)))
    got = tnn.flatten(tnn.max_pool(torch.from_numpy(x), 2)).numpy()
    # flatten runs over (h, w, c): an NCHW flatten would scramble fc1 rows
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("init,want_std", [
    ("fan_in_trunc_normal", 0.8796 / 16.0),  # 2-sigma truncation shrinks std
    ("he_normal", (2.0 / 256) ** 0.5),
    ("xavier_uniform", (6.0 / (256 + 512)) ** 0.5 / 3 ** 0.5),
])
def test_initializers_match_reference_distribution(init, want_std):
    """Same family as the reference (the bits differ: other generators)."""
    shape = (256, 512)
    got = getattr(tnn, init)(torch.Generator().manual_seed(0), shape)
    ref = np.asarray(getattr(jnn, init)(jax.random.PRNGKey(0), shape))
    assert tuple(got.shape) == shape and got.dtype == torch.float32
    for sample in (got.numpy(), ref):
        assert abs(float(sample.mean())) < 0.02 * want_std
        assert float(sample.std()) == pytest.approx(want_std, rel=0.02)
    assert float(got.abs().max()) <= float(np.abs(ref).max()) * 1.05


@pytest.mark.parametrize("name", ["mlp", "lenet5"])
def test_init_shapes_match_reference(name):
    sample = np.zeros((1, 28, 28, 1), np.float32)
    jp, _ = jget_model(name).init(jax.random.PRNGKey(0), jnp.asarray(sample))
    tp, ts = tget_model(name).init(torch.Generator().manual_seed(0),
                                   torch.from_numpy(sample))
    assert ts == {}
    assert jax.tree.map(lambda a: tuple(a.shape), jp) == \
        {k: {n: tuple(t.shape) for n, t in v.items()} for k, v in tp.items()}


def _forward_pair(monkeypatch, name, dtype, quantized, n=32, seed=0):
    """(port logits, JAX logits) on the same params and images."""
    monkeypatch.setattr(jquant, "FUSED_MATMUL", "pallas")
    jkw, tkw = {}, {}
    if dtype is not None:
        jkw["compute_dtype"] = getattr(jnp, dtype)
        tkw["compute_dtype"] = getattr(torch, dtype)
    jmodel, tmodel = jget_model(name, **jkw), tget_model(name, **tkw)
    jparams, _ = jmodel.init(jax.random.PRNGKey(seed),
                             jnp.zeros((1, 28, 28, 1)))
    tparams = params_from_jax(jax.device_get(jparams))
    if quantized:
        jparams, tparams = (jquant.quantize_tree(jparams),
                            tquant.quantize_tree(tparams))
    x = _images(n, seed=seed).astype(np.float32) / np.float32(255.0)
    want, _ = jmodel.apply(jparams, {}, jnp.asarray(x))
    got, _ = tmodel.apply(tparams, {}, torch.from_numpy(x))
    assert got.dtype == torch.float32
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("name,dtype,quantized", [
    ("lenet5", "float32", False), ("lenet5", "float32", True),
    ("mlp", None, False), ("mlp", None, True),
])
def test_f32_forward_matches_reference(monkeypatch, name, dtype, quantized):
    """f32 compute: only summation order differs (conv and GEMM
    algorithms), so 1e-4 relative to the largest logit."""
    got, want = _forward_pair(monkeypatch, name, dtype, quantized)
    assert got.shape == want.shape == (32, 10)
    assert _rel_err(got, want) <= 1e-4


@pytest.mark.parametrize("quantized", [False, True])
def test_bf16_lenet_forward_matches_reference(monkeypatch, quantized):
    """bf16 compute rounds at other places in the two frameworks: logits
    within the zoo's bf16 bound (0.04 abs) and the same top-1 on >= 98%
    of rows."""
    got, want = _forward_pair(monkeypatch, "lenet5", None, quantized, n=64)
    assert float(np.max(np.abs(got - want))) <= 0.04
    assert float(np.mean(got.argmax(-1) == want.argmax(-1))) >= 0.98


def test_params_from_jax_keeps_layouts_and_values():
    jparams, _ = jget_model("lenet5").init(jax.random.PRNGKey(3),
                                           jnp.zeros((1, 28, 28, 1)))
    host = jax.device_get(jparams)
    tparams = params_from_jax(host)
    for layer, leaves in host.items():
        for leaf, arr in leaves.items():
            t = tparams[layer][leaf]
            assert t.dtype == torch.float32 and tuple(t.shape) == arr.shape
            np.testing.assert_array_equal(t.numpy(), arr)
