"""The port's CUDA kernels and served path on the card.

Every test here needs an NVIDIA GPU and `nvcc` and skips without one. The
file imports no JAX, because the machine with the card has none; run it
there without the JAX fixtures of `conftest.py`:

    python -m pytest --noconftest tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same CUDA
inputs, in the working dtype.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from dist_mnist_tpu_torch.ops import quant as tquant
from dist_mnist_tpu_torch.ops.kernels.quant_matmul import (
    quant_matmul,
    quant_matmul_reference,
)
from dist_mnist_tpu_torch.serve import (
    InferenceEngine,
    load_for_serving,
    make_images,
)

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max()) / (float(want.abs().max())
                                              + 1e-12)


def _operands(m, d, h, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    qa = tquant.quantize(torch.from_numpy(
        rng.standard_normal((d, h)).astype(np.float32)).to(device))
    x = torch.from_numpy(rng.standard_normal((m, d)).astype(np.float32))
    return x.to(device, dtype), qa


@pytest.mark.parametrize("m,d,h,dtype,tol", [
    # the served shapes: LeNet-5 fc1/fc2 in bf16, the MLP in f32
    (1, 3136, 512, torch.bfloat16, 1e-2),
    (7, 3136, 512, torch.bfloat16, 1e-2),
    (64, 3136, 512, torch.bfloat16, 1e-2),
    (64, 512, 10, torch.bfloat16, 1e-2),
    (33, 784, 100, torch.float32, 2e-5),
    # ragged on every axis: several row blocks, a partial K chunk
    (130, 200, 37, torch.bfloat16, 1e-2),
    (33, 100, 10, torch.float32, 2e-5),
])
def test_kernel_matches_plain_version(cuda, m, d, h, dtype, tol):
    x, qa = _operands(m, d, h, dtype, cuda, seed=m * d + h)
    before = quant_matmul.launches
    got = quant_matmul(x, qa.q, qa.scale)
    torch.cuda.synchronize()
    assert quant_matmul.launches == before + 1
    want = quant_matmul_reference(x, qa.q, qa.scale)
    assert got.dtype == dtype and got.shape == want.shape == (m, h)
    assert _rel_err(got, want) <= tol


def test_kernel_keeps_lead_dims_and_stream(cuda):
    x, qa = _operands(6, 784, 100, torch.float32, cuda, seed=1)
    x = x.reshape(2, 3, 784)
    want = quant_matmul_reference(x, qa.q, qa.scale)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = quant_matmul(x, qa.q, qa.scale.reshape(-1))
    torch.cuda.synchronize()
    assert got.shape == (2, 3, 100)
    assert _rel_err(got, want) <= 2e-5
    # an empty batch launches nothing
    before = quant_matmul.launches
    assert quant_matmul(x[:0], qa.q, qa.scale).shape == (0, 3, 100)
    assert quant_matmul.launches == before


def test_wrapper_rejects_mixed_devices(cuda):
    x, qa = _operands(4, 64, 8, torch.float32, cuda)
    with pytest.raises(ValueError, match="different devices"):
        quant_matmul(x, qa.q.cpu(), qa.scale)


@pytest.mark.parametrize("shape,zero_channel", [
    ((3136, 512), False), ((5, 5, 32, 64), False), ((5, 5, 32, 64), True)])
def test_quantize_on_card_bitwise_equal_to_cpu(cuda, shape, zero_channel):
    """The CPU result is pinned bitwise to the JAX package's
    (tests/test_torch_quant.py), so this holds the card to it too."""
    rng = np.random.default_rng(7)
    w = (0.05 * rng.standard_normal(shape)).astype(np.float32)
    if zero_channel:
        w[..., 3] = 0.0
    want = tquant.quantize(torch.from_numpy(w))
    got = tquant.quantize(torch.from_numpy(w).to(cuda))
    assert got.mode == want.mode == ("tensor" if zero_channel else "channel")
    assert torch.equal(got.q.cpu(), want.q)
    assert torch.equal(got.scale.cpu().view(torch.int32),
                       want.scale.view(torch.int32))


def test_engine_on_card_matches_cpu_engine(cuda):
    """The served path on the card (kernel) against the same weights on
    the CPU (plain version): bf16 logits within the bound the JAX
    package's tests use for bf16 (0.04 abs), and the same top-1."""
    engines = {}
    for device in ("cpu", cuda):
        bundle = load_for_serving("lenet5_mnist", device, quant="int8")
        engines[str(device)] = InferenceEngine(
            bundle.model, bundle.params, bundle.model_state, device=device,
            image_shape=bundle.image_shape, max_bucket=64)
    images = make_images((28, 28, 1), seed=5, n=37)
    before = quant_matmul.launches
    got = engines[str(cuda)].predict(images)
    assert quant_matmul.launches == before + 2  # fc1, fc2
    want = engines["cpu"].predict(images)
    assert got.shape == want.shape == (37, 10)
    assert float(np.max(np.abs(got - want))) <= 0.04
    assert float(np.mean(got.argmax(-1) == want.argmax(-1))) >= 0.98
