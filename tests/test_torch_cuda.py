"""The port's CUDA kernels and served path on the card.

Every test here needs an NVIDIA GPU and `nvcc` and skips without one. The
file imports no JAX, because the machine with the card has none; run it
there without the JAX fixtures of `conftest.py`:

    python -m pytest --noconftest tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same CUDA
inputs, in the working dtype.
"""

from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from dist_mnist_tpu_torch import bench
from dist_mnist_tpu_torch import optim as topt
from dist_mnist_tpu_torch.data.datasets import load_dataset
from dist_mnist_tpu_torch.models.vit import ViTTiny
from dist_mnist_tpu_torch.ops import nn as tnn
from dist_mnist_tpu_torch.ops import quant as tquant
from dist_mnist_tpu_torch.ops.kernels import flash_attention as tflash
from dist_mnist_tpu_torch.ops.kernels import fused_adam as tadam
from dist_mnist_tpu_torch.ops.kernels.fused_adam import (
    fused_adam_clip_wd_update,
    fused_adam_clip_wd_update_leaves,
    fused_adam_clip_wd_update_reference,
    fused_adam_update,
    fused_adam_update_leaves,
    fused_adam_update_reference,
)
from dist_mnist_tpu_torch.ops.kernels.masked_flash import (
    masked_flash_attention,
    masked_flash_attention_backward,
    masked_flash_attention_backward_probe,
    masked_flash_attention_forward,
    masked_flash_attention_forward_reference,
    masked_flash_attention_launch_floor,
    masked_flash_attention_probe,
    masked_flash_attention_reference,
    masked_forward_body,
)
from dist_mnist_tpu_torch.ops.kernels.paged_attention import (
    decode_launch_plan,
    paged_attention,
    paged_attention_launch_floor,
    paged_attention_probe,
    paged_attention_reference,
)
from dist_mnist_tpu_torch.ops.kernels import quant_matmul as tqmm
from dist_mnist_tpu_torch.ops.kernels.quant_matmul import (
    quant_matmul,
    quant_matmul_reference,
    route_tile,
    split_k_plan,
)
from dist_mnist_tpu_torch.serve import (
    DecodeScheduler,
    InferenceEngine,
    build_decode_engine,
    load_for_serving,
    make_images,
    run_decode_loadgen,
)
from dist_mnist_tpu_torch.train import TrainState, make_train_step
from dist_mnist_tpu_torch.utils.tree import tree_map

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


#: bf16 split-K shapes: LeNet-5's fc1 and fc2, a K that the split size
#: does not divide, and one whose rows are not 16-byte aligned (K % 8, H %
#: 16), staged by plain loads
QMM_BF16_SHAPES = [(3136, 512), (512, 10), (1000, 96), (1001, 40)]


@pytest.mark.parametrize("d,h", QMM_BF16_SHAPES)
@pytest.mark.parametrize("m", [1, 7, 16, 17, 64, 65, 200])
def test_bf16_split_k_kernel_matches_plain_version(cuda, m, d, h):
    """The tensor-core split-K kernel against the plain version: within
    one bf16 ulp (1e-2) of the largest output, one launch per call."""
    x, qa = _operands(m, d, h, torch.bfloat16, cuda, seed=m + d + h)
    before = quant_matmul.launches
    got = quant_matmul(x, qa.q, qa.scale)
    torch.cuda.synchronize()
    assert quant_matmul.launches == before + 1
    want = quant_matmul_reference(x, qa.q, qa.scale)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape == (m, h)
    assert _rel_err(got, want) <= 1e-2


@pytest.mark.parametrize("m", [7, 64, 200])
def test_bf16_split_k_reduction_is_bitwise_repeatable(cuda, m):
    """The partials are summed in split order whichever block arrives
    last: the same inputs give the same bits, again and under another
    stream, and every launch leaves its arrival counters at zero."""
    x, qa = _operands(m, 3136, 512, torch.bfloat16, cuda, seed=5)
    # the reduction runs
    assert split_k_plan(m, 3136, 512, route_tile(torch.bfloat16, m))[1] > 1
    before = quant_matmul.launches
    first = quant_matmul(x, qa.q, qa.scale)
    again = quant_matmul(x, qa.q, qa.scale)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        other = quant_matmul(x, qa.q, qa.scale)
    torch.cuda.synchronize()
    assert quant_matmul.launches == before + 3
    assert torch.equal(first.view(torch.int16), again.view(torch.int16))
    assert torch.equal(first.view(torch.int16), other.view(torch.int16))
    assert all(int(buf.abs().sum()) == 0
               for buf in tqmm._arrival_buffers.values())


#: f32 split-K shapes: the MLP's hidden and output layers, a K that the
#: split size does not divide, and one whose x rows take plain loads (K %
#: 4) and whose H is not a multiple of 16
QMM_F32_SHAPES = [(784, 100), (100, 10), (1000, 96), (1001, 40)]


@pytest.mark.parametrize("d,h", QMM_F32_SHAPES)
@pytest.mark.parametrize("m", [1, 2, 4, 7, 8, 16, 17, 32, 64, 65, 200])
def test_f32_split_k_kernel_matches_plain_version(cuda, m, d, h):
    """The CUDA-core split-K kernel against the plain version: within
    2e-5 of the largest output (f32 sums in another order), one launch
    per call, counted as an f32 launch."""
    x, qa = _operands(m, d, h, torch.float32, cuda, seed=m + d + h)
    before = quant_matmul.launches, quant_matmul.f32_launches
    got = quant_matmul(x, qa.q, qa.scale)
    torch.cuda.synchronize()
    assert (quant_matmul.launches, quant_matmul.f32_launches) == (
        before[0] + 1, before[1] + 1)
    want = quant_matmul_reference(x, qa.q, qa.scale)
    assert got.dtype == torch.float32 and got.shape == want.shape == (m, h)
    assert _rel_err(got, want) <= 2e-5


@pytest.mark.parametrize("m", [1, 7, 64, 200])
def test_f32_split_k_reduction_is_bitwise_repeatable(cuda, m):
    """The f32 route sums its partials in split order too: at the MLP's
    hidden layer the same inputs give the same bits, again and under
    another stream, and the arrival counters are left at zero."""
    x, qa = _operands(m, 784, 100, torch.float32, cuda, seed=6)
    assert split_k_plan(m, 784, 100, route_tile(torch.float32, m))[1] > 1
    first = quant_matmul(x, qa.q, qa.scale)
    again = quant_matmul(x, qa.q, qa.scale)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        other = quant_matmul(x, qa.q, qa.scale)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int32), again.view(torch.int32))
    assert torch.equal(first.view(torch.int32), other.view(torch.int32))
    assert all(int(buf.abs().sum()) == 0
               for buf in tqmm._arrival_buffers.values())


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


@pytest.mark.parametrize("spec,x_shape,dtype", [
    ("bsk,kh->bsh", (4, 16, 784), torch.float32),
    ("bk,kh->bh", (64, 784), torch.float32),
    ("bsk,kh->bsh", (2, 33, 784), torch.bfloat16)])
def test_q_einsum_matmul_spec_runs_the_kernel(cuda, spec, x_shape, dtype):
    """`q_einsum` on a last-axis matmul spec with mlp/hid's int8 weight
    launches `quant_matmul` once and agrees with the plain version on the
    same inputs (2e-5 of the largest output in f32, 1e-2 in bf16); a
    non-matmul spec takes the dequantized einsum and launches nothing."""
    rng = np.random.default_rng(11)
    w = tquant.quantize(torch.from_numpy(
        (0.05 * rng.standard_normal((784, 100))).astype(np.float32)).to(cuda))
    x = torch.from_numpy(rng.standard_normal(x_shape).astype(np.float32)).to(
        cuda, dtype)
    before = quant_matmul.launches
    got = tquant.q_einsum(spec, x, w)
    assert quant_matmul.launches - before == 1
    want = quant_matmul_reference(x, w.q, w.scale)
    assert got.shape == want.shape == (*x_shape[:-1], 100)
    tol = 2e-5 if dtype == torch.float32 else 1e-2
    assert _rel_err(got, want) <= tol
    before = quant_matmul.launches
    outer = tquant.q_einsum("bk,kh->hb", x.reshape(-1, 784), w)
    assert quant_matmul.launches == before
    assert _rel_err(outer.t(), want.reshape(-1, 100)) <= tol


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


def test_normalize_images_on_card_is_ieee_division(cuda):
    """All 256 byte values, bit for bit against numpy's f32 division: the
    card must not divide by multiplying with a reciprocal."""
    b = np.arange(256, dtype=np.uint8)
    got = tnn.normalize_images(torch.from_numpy(b).to(cuda)).cpu().numpy()
    want = b.astype(np.float32) / np.float32(255)
    assert got.view(np.int32).tolist() == want.view(np.int32).tolist()


#: LeNet-5's 8 leaf sizes, and sizes that leave a tail after float4 loads
ADAM_SIZES = [32, 800, 64, 51200, 512, 1605632, 10, 5120, 1, 7, 129]


def _adam_operands(n, device, seed):
    rng = np.random.default_rng(seed)
    g, m, p = (torch.from_numpy(rng.standard_normal(n).astype(np.float32)
                                ).to(device) for _ in range(3))
    v = torch.from_numpy(rng.random(n).astype(np.float32)).to(device)
    return g, m, v, p


@pytest.mark.parametrize("n", ADAM_SIZES)
def test_fused_adam_kernels_match_plain_versions(cuda, n):
    """Kernel against its plain version on the same card inputs: m' and v'
    within 1e-6 and delta within 1e-5 of the largest value (both round
    each operation once, in the same order, so they agree bit for bit
    unless torch's own kernels contract or reorder)."""
    g, m, v, p = _adam_operands(n, cuda, seed=n)
    lr_t = torch.full((), 3e-3, device=cuda)
    scalars = torch.tensor([3e-3, 0.37, 1e-5], device=cuda)
    before = (fused_adam_update.launches, fused_adam_clip_wd_update.launches)
    got1 = fused_adam_update(g, m, v, lr_t)
    got2 = fused_adam_clip_wd_update(g, m, v, p, scalars)
    torch.cuda.synchronize()
    assert (fused_adam_update.launches,
            fused_adam_clip_wd_update.launches) == (before[0] + 1,
                                                   before[1] + 1)
    want1 = fused_adam_update_reference(g, m, v, lr_t)
    want2 = fused_adam_clip_wd_update_reference(g, m, v, p, scalars)
    for got, want in ((got1, want1), (got2, want2)):
        for out, ref, tol in zip(got, want, (1e-5, 1e-6, 1e-6)):
            assert out.shape == ref.shape and out.dtype == torch.float32
            assert _rel_err(out, ref) <= tol


def test_fused_adam_kernel_takes_unaligned_views(cuda):
    """A view that starts off a 16-byte boundary takes the scalar loop."""
    g, m, v, _ = _adam_operands(1001, cuda, seed=3)
    lr_t = torch.full((1,), 1e-3, device=cuda)
    got = fused_adam_update(g[1:], m[1:], v[1:], lr_t)
    want = fused_adam_update_reference(g[1:], m[1:], v[1:], lr_t)
    torch.cuda.synchronize()
    for out, ref in zip(got, want):
        assert _rel_err(out, ref) <= 1e-5


def test_fused_adam_wrapper_rejects_mixed_devices(cuda):
    g, m, v, _ = _adam_operands(8, cuda, seed=1)
    with pytest.raises(ValueError, match="different devices"):
        fused_adam_update(g, m, v, torch.full((), 1e-3))


def _leaves_against_one_leaf(leaves, cuda, tables):
    """Both kernels over `leaves` ((g, m, v, p) each) in `tables`
    launches: every leaf's delta, m' and v' the bits of the one-leaf
    launch on it."""
    lr_t = torch.full((), 3e-3, device=cuda)
    scalars = torch.tensor([3e-3, 0.37, 1e-5], device=cuda)
    g, m, v, p = (list(x) for x in zip(*leaves))
    for fn, one, args, extra, counter in (
            (fused_adam_update_leaves, fused_adam_update, (g, m, v), (lr_t,),
             fused_adam_update),
            (fused_adam_clip_wd_update_leaves, fused_adam_clip_wd_update,
             (g, m, v, p), (scalars,), fused_adam_clip_wd_update)):
        before = counter.launches
        got = fn(*args, *extra)
        torch.cuda.synchronize()
        assert counter.launches == before + tables
        for i in range(len(g)):
            want = one(*(a[i] for a in args), *extra)
            for out, ref in zip((x[i] for x in got), want):
                assert out.shape == ref.shape and out.is_contiguous()
                assert out.data_ptr() % 16 == 0  # the next step's float4 loop
                assert torch.equal(out, ref)


def test_fused_adam_leaves_equal_one_leaf_kernel_bitwise(cuda):
    """Every ADAM_SIZES leaf in one launch: the same bits as one launch
    per leaf (each held to the plain version above)."""
    _leaves_against_one_leaf([_adam_operands(n, cuda, seed=n)
                              for n in ADAM_SIZES], cuda, tables=1)


def test_fused_adam_leaves_take_an_unaligned_leaf(cuda):
    """One leaf whose views start off a 16-byte boundary (the scalar loop)
    among aligned ones (the float4 loop), in one launch."""
    leaves = [_adam_operands(n, cuda, seed=n) for n in (5120, 1001, 129)]
    leaves[1] = tuple(t[1:] for t in leaves[1])
    assert leaves[1][0].data_ptr() % 16 != 0
    _leaves_against_one_leaf(leaves, cuda, tables=1)


def test_fused_adam_leaves_past_one_table(cuda):
    """150 leaves, more than one table holds (ViT-Tiny has 152): one
    launch per table of `TABLE_LEAVES`."""
    sizes = [(7 * i) % 300 + 1 for i in range(150)]
    tables = len(tadam.adam_leaf_plan(sizes).tables)
    assert tables == -(-150 // tadam.TABLE_LEAVES) > 1
    _leaves_against_one_leaf([_adam_operands(n, cuda, seed=i)
                              for i, n in enumerate(sizes)], cuda, tables)


def test_fused_adam_table_is_the_size_the_plan_counts(cuda):
    assert tadam._entry("dmt_fused_adam_table_bytes")() == tadam.TABLE_BYTES


def test_ten_training_steps_on_card_launch_the_fused_kernel(cuda,
                                                           monkeypatch):
    """The headline training function on the card, tiny: every Adam
    update goes through the kernel, one launch over all of LeNet-5's
    leaves per step, and the loss falls."""
    ds = load_dataset("mnist", "/nonexistent", seed=0,
                      synthetic_sizes=(2000, 500), cache_synthetic=False)
    monkeypatch.setattr(bench, "CHUNK", 2)
    fused_adam_update.launches = 0
    run = bench.run_headline(cuda, topt.adam(1e-3, fused=True), dataset=ds,
                             race_rounds=1, timed_steps=4)
    torch.cuda.synchronize()
    assert run.steps == 2 * 2 + 2 + 4  # race round, warm-up, timed
    assert fused_adam_update.launches == run.steps
    assert np.isfinite(run.final_loss) and run.final_loss < run.first_loss
    assert run.record["extra"]["device_kind"] == \
        torch.cuda.get_device_name(cuda)


# -- decode serving: paged attention, masked flash attention ---------------

def _kv_pool(rng, pages, t, h, d, device):
    x = torch.from_numpy(rng.standard_normal((pages, t, h, d))
                         .astype(np.float32)).to(device)
    q, scale = tquant.quantize_kv(x)
    return tquant.QuantizedArray(q, scale, "kv_head")


@pytest.mark.parametrize("n,t,h,d,dtype", [
    (1, 32, 8, 16, torch.float32), (4, 32, 8, 16, torch.float32),
    (128, 32, 8, 16, torch.float32), (3, 8, 2, 128, torch.float32),
    (2, 200, 2, 64, torch.bfloat16),  # a page longer than one tile
])
def test_paged_attention_kernel_matches_plain_version(cuda, n, t, h, d,
                                                      dtype):
    rng = np.random.default_rng(n + t + d)
    rows, pages = 9, max(2 * n, 8)
    kp, vp = (_kv_pool(rng, pages, t, h, d, cuda) for _ in range(2))
    q = torch.from_numpy(rng.standard_normal((rows, 1, h, d))
                         .astype(np.float32)).to(cuda, dtype)
    table = torch.from_numpy(np.stack([
        rng.choice(pages, size=n, replace=False) for _ in range(rows)])
        .astype(np.int32)).to(cuda)
    lens = rng.integers(1, n * t + 1, size=rows).astype(np.int32)
    lens[:3] = [1, n * t, min(t + 1, n * t)]
    lengths = torch.from_numpy(lens).to(cuda)
    before = paged_attention.launches
    got, visits = paged_attention_probe(q, kp, vp, table, lengths)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    want = paged_attention_reference(q, kp, vp, table, lengths)
    assert got.dtype == dtype and got.shape == want.shape
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    assert _rel_err(got, want) <= tol
    pages_in = np.minimum(-(-lens // t), n).astype(np.float32)
    assert np.array_equal(visits.cpu().numpy(),
                          np.repeat(pages_in[:, None], h, axis=1))


@pytest.mark.parametrize("b,sq,sk,dtype", [
    (9, 1, 64, torch.float32), (9, 1, 4096, torch.float32),
    (2, 7, 256, torch.float32), (2, 128, 256, torch.float32),
    (3, 5, 100, torch.bfloat16),
])
def test_masked_flash_kernel_matches_plain_version(cuda, b, sq, sk, dtype):
    rng = np.random.default_rng(b * sq + sk)
    h, d = 8, 16
    q, k, v = (torch.from_numpy(rng.standard_normal(shape)
                                .astype(np.float32)).to(cuda, dtype)
               for shape in ((b, sq, h, d), (b, sk, h, d), (b, sk, h, d)))
    lens = rng.integers(1, sk + 1, size=b).astype(np.int32)
    lens[0], lens[-1] = 1, sk
    lengths = torch.from_numpy(lens).to(cuda)
    before = masked_flash_attention.launches
    got, visits = masked_flash_attention_probe(q, k, v, lengths)
    torch.cuda.synchronize()
    assert masked_flash_attention.launches == before + 1
    want = masked_flash_attention_reference(q, k, v, lengths)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    assert got.dtype == dtype and _rel_err(got, want) <= tol
    blocks = (-(-lens // 32)).astype(np.float32)
    assert np.array_equal(visits.cpu().numpy(),
                          np.broadcast_to(blocks[:, None, None], (b, h, sq)))


def _paged_case(rng, t, d, dtype, device, lens, n=3, h=2):
    """q, pools of 2n pages and a table of width n for rows of `lens`."""
    pages = 2 * n
    kp, vp = (_kv_pool(rng, pages, t, h, d, device) for _ in range(2))
    q = torch.from_numpy(rng.standard_normal((len(lens), 1, h, d))
                         .astype(np.float32)).to(device, dtype)
    table = torch.from_numpy(np.stack([
        rng.choice(pages, size=n, replace=False) for _ in lens])
        .astype(np.int32)).to(device)
    return q, kp, vp, table, torch.tensor(lens, dtype=torch.int32,
                                          device=device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("t", [8, 32, 200])
def test_paged_attention_decode_kernel_page_sizes(cuda, t, d, dtype):
    """The warp-per-(row, head) kernel at every page size the wrapper
    takes: a slice of 32 // lanes tokens spans pages (T = 8), is one page
    (T = 32 at D = 16) or ends inside one (T = 200); lengths 1, T, T + 1
    and n * T."""
    n = 3
    lens = [1, t, t + 1, n * t]
    ops = _paged_case(np.random.default_rng(t * d), t, d, dtype, cuda, lens,
                      n=n)
    got, visits = paged_attention_probe(*ops)
    torch.cuda.synchronize()
    want = paged_attention_reference(*ops)
    assert got.dtype == dtype and got.shape == want.shape
    assert _rel_err(got, want) <= (1e-2 if dtype == torch.bfloat16 else 1e-5)
    pages_in = np.minimum(-(-np.asarray(lens) // t), n).astype(np.float32)
    assert np.array_equal(visits.cpu().numpy(),
                          np.repeat(pages_in[:, None], 2, axis=1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 64, 128])
def test_masked_decode_kernel_out_and_lse(cuda, d, dtype):
    """Sq = 1 takes the decode kernel: out within the dtype's limit and
    lse within 1e-5 of the plain version's on the same card inputs."""
    rng = np.random.default_rng(d)
    b, sk, h = 4, 300, 2
    assert masked_forward_body(1, sk, dtype) == "masked_flash_decode_kernel"
    q, k, v = (torch.from_numpy(rng.standard_normal(shape)
                                .astype(np.float32)).to(cuda, dtype)
               for shape in ((b, 1, h, d), (b, sk, h, d), (b, sk, h, d)))
    lengths = torch.tensor([1, 32, 33, sk], dtype=torch.int32, device=cuda)
    before = masked_flash_attention.launches
    out, lse = masked_flash_attention_forward(q, k, v, lengths)
    torch.cuda.synchronize()
    assert masked_flash_attention.launches == before + 1
    want_out, want_lse = masked_flash_attention_forward_reference(
        q, k, v, lengths)
    assert out.dtype == dtype and lse.shape == want_lse.shape == (b, h, 1)
    assert _rel_err(out, want_out) <= (1e-2 if dtype == torch.bfloat16
                                       else 1e-5)
    assert _rel_err(lse, want_lse) <= 1e-5


def _same_bits(a, b) -> bool:
    return torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["paged", "masked"])
def test_decode_kernels_bitwise_twice_and_on_another_stream(cuda, kernel,
                                                            dtype):
    """No atomics, fixed butterflies: the same inputs give the same bits
    on a second call and under a second stream."""
    rng = np.random.default_rng(21)
    if kernel == "paged":
        ops = _paged_case(rng, 32, 16, dtype, cuda, [1, 31, 33, 64, 96], n=3,
                          h=8)

        def call():
            return paged_attention(*ops)
    else:
        q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(cuda, dtype)
            for shape in ((9, 1, 8, 16), (9, 512, 8, 16), (9, 512, 8, 16)))
        lengths = torch.tensor([1, 31, 32, 33, 64, 512, 1, 200, 33],
                               dtype=torch.int32, device=cuda)

        def call():
            return masked_flash_attention(q, k, v, lengths)
    first, again = call(), call()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        other = call()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    assert _same_bits(first, again) and _same_bits(first, other)


def _masked_case(rng, b, sq, sk, h, d, dtype, device, lens=None):
    """q, k, v and lengths (1 and Sk among them unless given)."""
    q, k, v = (torch.from_numpy(rng.standard_normal(shape)
                                .astype(np.float32)).to(device, dtype)
               for shape in ((b, sq, h, d), (b, sk, h, d), (b, sk, h, d)))
    if lens is None:
        lens = rng.integers(1, sk + 1, size=b)
        lens[0], lens[-1] = 1, sk
    return q, k, v, np.asarray(lens, dtype=np.int32)


def _check_masked_forward(q, k, v, lens, device):
    """One probe and one forward: out within the dtype's limit and lse
    within 1e-5 of the plain version's, visits ceil(len / 32) for every
    query row, one launch each on the masked counter and none on the
    flash forward's."""
    b, sq, h, _ = q.shape
    lengths = torch.from_numpy(lens).to(device)
    before = (masked_flash_attention.launches,
              tflash.flash_attention_forward.launches)
    got, visits = masked_flash_attention_probe(q, k, v, lengths)
    out, lse = masked_flash_attention_forward(q, k, v, lengths)
    torch.cuda.synchronize()
    assert (masked_flash_attention.launches,
            tflash.flash_attention_forward.launches) == (before[0] + 2,
                                                         before[1])
    want_out, want_lse = masked_flash_attention_forward_reference(
        q, k, v, lengths)
    tol = 1e-2 if q.dtype == torch.bfloat16 else 1e-5
    assert got.dtype == q.dtype and lse.shape == (b, h, sq)
    assert _rel_err(got, want_out) <= tol and _rel_err(out, want_out) <= tol
    assert _rel_err(lse, want_lse) <= 1e-5
    blocks = (-(-lens // 32)).astype(np.float32)
    assert np.array_equal(visits.cpu().numpy(),
                          np.broadcast_to(blocks[:, None, None], (b, h, sq)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_forward_sq2_takes_the_flash_forward(cuda, dtype):
    """Sq = 2 takes the flash forward's kernels with the lengths (bf16:
    the one-pass tensor-core kernel at Sk = 100; f32: the register-tiled
    one): out within the dtype's limit, lse within 1e-5, visits
    ceil(len / 32) for both query rows."""
    assert masked_forward_body(2, 100, dtype) == (
        "flash_fwd_mma_onepass" if dtype == torch.bfloat16
        else "flash_fwd_f32")
    rng = np.random.default_rng(2)
    _check_masked_forward(*_masked_case(rng, 3, 2, 100, 2, 16, dtype, cuda,
                                        lens=[1, 33, 100]), cuda)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,h,d", [
    (64, 65, 65, 3, 64),   # ViT's shape, the one-pass kernel
    (64, 33, 33, 3, 64),   # the zoo's height-16 bucket: keys padded to 48
    (8, 300, 300, 3, 64),  # above 128 keys: the tiled kernel
    (3, 5, 200, 2, 64),    # Sq != Sk, tiled
    (2, 200, 128, 3, 64),  # Sq > 128 against Sk <= 128: two blocks of rows
    (2, 129, 33, 2, 64),
    (4, 65, 65, 2, 16), (4, 65, 65, 2, 40), (4, 65, 65, 2, 128),
    (4, 7, 300, 2, 16), (4, 7, 300, 2, 40), (4, 130, 300, 2, 128),
])
def test_masked_forward_sq_gt1_matches_plain_version(cuda, b, sq, sk, h, d,
                                                     dtype):
    """The masked forward at Sq > 1 on both routes of each dtype, at Sk
    up to 128 and above it, Sq above 128 against Sk at most 128, and
    every padded head dim: out, lse and visits against the plain
    version, lengths 1 and Sk among the rows."""
    rng = np.random.default_rng(b * sq + sk + d)
    _check_masked_forward(*_masked_case(rng, b, sq, sk, h, d, dtype, cuda),
                          cuda)


def _chip_smoke():
    """The repo's `chip_smoke.py` as a module (its limits and helpers)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("b,s", [(64, 33), (64, 65), (3, 128), (8, 17),
                                 (32, 9), (32, 17)])
def test_masked_onepass_bf16_share_equal_to_plain_version(cuda, b, s):
    """At Sk <= 128 the one-pass kernel's single tile is the reference's
    one 128-key block, so at least `chip_smoke.MASKED_MATCH_MIN` of its
    bf16 outputs equal the plain version's (the reference's streamed
    rule) bit for bit."""
    smoke = _chip_smoke()
    rng = np.random.default_rng(b + s)
    q, k, v, lens = _masked_case(rng, b, s, s, 3, 64, torch.bfloat16, cuda)
    lengths = torch.from_numpy(lens).to(cuda)
    assert masked_forward_body(s, s, torch.bfloat16) == \
        "flash_fwd_mma_onepass"
    got = masked_flash_attention(q, k, v, lengths)
    want = masked_flash_attention_reference(q, k, v, lengths)
    torch.cuda.synchronize()
    assert smoke.bf16_match_share([got], [want]) >= smoke.MASKED_MATCH_MIN


def test_seeded_init_on_card_machine_equals_the_cpu_tests(cuda):
    """The truncated normal of LeNet-5's and the MLP's fresh init draws
    on this machine's torch what it draws for the CPU tests
    (tests/test_torch_models.py pins the same values): one seed, one
    model, wherever the port runs."""
    got = tnn.truncated_normal(torch.Generator().manual_seed(0), (6,), 1.0)
    assert got.tolist() == [1.5409960746765137, -0.293428897857666,
                            -0.7192575931549072, 0.5684312582015991,
                            -1.0845223665237427, -1.3985954523086548]
    bundle = load_for_serving("mlp_mnist", cuda, quant="int8")
    assert [int(bundle.params[k]["w"].q.abs().sum()) for k in ("hid", "sm")
            ] == [3620061, 50513]


def test_zoo_engine_on_card_runs_each_cell_and_counts_launches(cuda):
    """A small flash ViT (depth 2, bf16) behind the zoo's auto height
    ladder on the card: prewarm runs every cell once, each masked cell's
    batch launches the masked forward once a layer and the dense native
    cell's the flash forward, and traffic over the grid after prewarm
    runs no cell for the first time."""
    from dist_mnist_tpu_torch.configs import get_config
    from dist_mnist_tpu_torch.serve import build_zoo_engine

    cfg = get_config("vit_tiny_cifar_flash")
    cfg = dataclasses.replace(cfg, model_kwargs={
        **cfg.model_kwargs, "dim": 64, "depth": 2, "heads": 2})
    eng = build_zoo_engine(load_for_serving(cfg, cuda), cuda,
                           model_name="vit", max_bucket=4,
                           seq_buckets="auto")
    masked_flash_attention.launches = 0
    tflash.flash_attention_forward.launches = 0
    cells = eng.prewarm()
    torch.cuda.synchronize()
    n_heights = len(eng.seq_grid.heights)
    assert cells == len(eng.buckets()) * (1 + n_heights) == eng.misses
    assert masked_flash_attention.launches == 2 * len(eng.buckets()) \
        * n_heights
    assert tflash.flash_attention_forward.launches == 2 * len(eng.buckets())
    rng = np.random.default_rng(0)
    for n, h in ((3, 4), (1, 12), (4, 32), (2, 20), (4, 7)):
        images = rng.integers(0, 256, size=(n, h, 32, 3), dtype=np.uint8)
        out = eng.predict(images)
        assert out.shape == (n, 10) and np.isfinite(out).all()
    torch.cuda.synchronize()
    assert eng.misses == cells
    runs = eng.cache_stats()["per_cell"]
    assert masked_flash_attention.launches == 2 * sum(
        r for c, r in runs.items() if c.endswith("/masked"))
    assert tflash.flash_attention_forward.launches == 2 * sum(
        r for c, r in runs.items() if c.endswith("/dense"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk", [(65, 65), (300, 300)])
def test_masked_forward_sq_gt1_bitwise_twice_and_on_another_stream(
        cuda, sq, sk, dtype):
    """No atomics in the flash forward: out and lse keep their bits on a
    second call and under a second stream."""
    rng = np.random.default_rng(23)
    q, k, v, lens = _masked_case(rng, 8, sq, sk, 3, 64, dtype, cuda)
    lengths = torch.from_numpy(lens).to(cuda)

    def call():
        return masked_flash_attention_forward(q, k, v, lengths)
    first, again = call(), call()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        other = call()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    for a, b2, c in zip(first, again, other):
        assert _same_bits(a, b2) and _same_bits(a, c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,h,d", [
    (64, 65, 65, 3, 64), (8, 300, 300, 3, 64), (3, 5, 100, 2, 16),
    (2, 200, 128, 3, 40), (1, 2, 129, 1, 128), (1024, 1000, 1000, 8, 64),
])
def test_forward_plan_agrees_with_the_c_entry(cuda, b, sq, sk, h, d,
                                              dtype):
    """The forward's C entry launches the plan the wrapper's
    `forward_plan` computes: grid, threads, shared memory, rows a block
    owns and the keys it stages at a time."""
    import ctypes

    from dist_mnist_tpu_torch.ops.kernels import build

    entry = build.load("flash_attention").dmt_flash_forward_plan
    out = (ctypes.c_int * 7)()
    entry(b, sq, sk, h, d, int(dtype == torch.bfloat16), out)
    assert tuple(out) == tflash.forward_plan(b, sq, sk, h, d, dtype)


@pytest.mark.parametrize("rows,heads,d", [(9, 8, 16), (9, 8, 17), (3, 2, 64),
                                          (1, 1, 128), (1025, 3, 40)])
def test_decode_plan_agrees_with_the_c_entries(cuda, rows, heads, d):
    """Both C entries launch the plan the wrapper's `decode_launch_plan`
    computes: lanes per token, the grid (heads, rows), threads."""
    import ctypes

    from dist_mnist_tpu_torch.ops.kernels import build

    for lib, name in (("paged_attention", "dmt_paged_attention_plan"),
                      ("masked_flash_attention",
                       "dmt_masked_flash_decode_plan")):
        entry = getattr(build.load(lib), name)
        out = (ctypes.c_int * 4)()
        entry(rows, heads, d, out)
        assert tuple(out) == decode_launch_plan(rows, heads, d), name


def test_launch_floors_write_and_count_nothing(cuda):
    rng = np.random.default_rng(5)
    ops = _paged_case(rng, 32, 16, torch.float32, cuda, [1, 40])
    q, k, v = (torch.zeros(2, s, 2, 16, device=cuda) for s in (1, 64, 64))
    lengths = torch.tensor([1, 64], dtype=torch.int32, device=cuda)
    counts = (paged_attention.launches, masked_flash_attention.launches,
              tflash.flash_attention_forward.launches)
    paged_attention_launch_floor(*ops)
    masked_flash_attention_launch_floor(q, k, v, lengths)
    for dtype in (torch.float32, torch.bfloat16):  # Sq > 1: the flash forward's
        masked_flash_attention_launch_floor(*(t.to(dtype) for t in (
            torch.zeros(2, 65, 2, 16, device=cuda), k, v)), lengths)
    torch.cuda.synchronize()
    assert (paged_attention.launches, masked_flash_attention.launches,
            tflash.flash_attention_forward.launches) == counts


def test_quantize_kv_on_card_bitwise_equal_to_cpu(cuda):
    """The CPU result is pinned bitwise to the JAX package's
    (tests/test_torch_paged.py), so this holds the card to it too."""
    x = np.random.default_rng(11).standard_normal((9, 32, 8, 16)) \
        .astype(np.float32)
    x[2, 5, 3] = 0.0  # a zero token: the eps floor
    want_q, want_s = tquant.quantize_kv(torch.from_numpy(x))
    got_q, got_s = tquant.quantize_kv(torch.from_numpy(x).to(cuda))
    assert torch.equal(got_q.cpu(), want_q)
    assert torch.equal(got_s.cpu().view(torch.int32),
                       want_s.view(torch.int32))


@pytest.mark.parametrize("overrides,kernel", [
    (dict(cache_layout="paged", kv_page_tokens=8, kv_quant="int8"),
     paged_attention),
    (dict(attention_impl="flash"), masked_flash_attention),
])
def test_decode_engine_on_card_launches_its_kernel(cuda, overrides, kernel):
    """A small engine on the card: every decode step launches the
    layout's kernel once per layer, and every request completes."""
    eng = build_decode_engine(cuda, max_slots=4, vocab_size=64, dim=32,
                              heads=2, depth=2, max_seq=64, **overrides)
    kernel.launches = 0
    eng.prewarm()
    with DecodeScheduler(eng) as sched:
        res = run_decode_loadgen(sched, n_requests=12, concurrency=6,
                                 seed=3)
    torch.cuda.synchronize()
    assert res["ok"] == 12 and res["errors"] == 0
    assert kernel.launches == 2 * eng.decode_steps > 0


def test_incremental_decode_bit_matches_full_forward_on_card(cuda):
    """The model's decode contract holds on the card too: every sum of
    the `"xla"` path is index-ordered (`ops.nn.ordered_sum`) and softmax
    rows have one length, so an incremental decode equals the full
    forward bit for bit at every position."""
    from dist_mnist_tpu_torch.models.causal_lm import CausalLMTiny
    from dist_mnist_tpu_torch.utils.tree import tree_map

    model = CausalLMTiny(vocab_size=64, dim=32, depth=2, heads=2, max_seq=64)
    params, _ = model.init(torch.Generator().manual_seed(0))
    params = tree_map(lambda t: t.to(cuda), params)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, 64, size=(3, 20), dtype=np.int32)).to(cuda)
    with torch.no_grad():
        full, _ = model.apply(params, {}, tokens)
        cache = model.init_cache(3, device=cuda)
        for pos in range(20):
            logits, _ = model.decode_step(
                params, cache, tokens[:, pos],
                torch.full((3,), pos, dtype=torch.int32, device=cuda))
            assert torch.equal(logits, full[:, pos]), f"position {pos}"


# -- ViT training: flash attention forward and backward ---------------------

def _qkv(b, s, h, d, dtype, device, seed, fused=True):
    """q, k, v ``[B, S, H, D]``: with `fused`, the strided views of one
    ``[B, S, 3, H, D]`` projection, as ViT makes them."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, s, 3, h, d))
                         .astype(np.float32)).to(device, dtype)
    if fused:
        return x.unbind(2)
    return tuple(x[:, :, i].contiguous() for i in range(3))


#: bf16 outputs are rounded once from f32 sums taken in another order: one
#: bf16 ulp (2^-8) of the largest value. f32: the forward 1e-5; the
#: backward's dS = P (dP - delta) cancels, 1e-4.
FLASH_TOL = {torch.bfloat16: (1e-2, 1e-2), torch.float32: (1e-5, 1e-4)}


@pytest.mark.parametrize("b,s,h,d,dtype,block_k,fused", [
    (64, 65, 3, 64, torch.bfloat16, None, True),  # ViT-Tiny's shape
    (64, 65, 3, 64, torch.float32, None, True),
    (7, 65, 3, 64, torch.float32, None, True),
    (1, 65, 3, 64, torch.float32, None, True),
    (1, 65, 3, 64, torch.bfloat16, None, False),
    (2, 17, 2, 16, torch.float32, None, True),
    (1, 300, 2, 16, torch.float32, 128, True),   # the streamed rounding
    (2, 300, 2, 16, torch.bfloat16, 128, False),
    (2, 33, 2, 128, torch.float32, None, True),   # > 48 KB of smem
])
def test_flash_kernels_match_plain_versions(cuda, b, s, h, d, dtype,
                                            block_k, fused):
    q, k, v = _qkv(b, s, h, d, dtype, cuda, seed=b * s + d, fused=fused)
    rng = np.random.default_rng(s)
    do = torch.from_numpy(rng.standard_normal((b, s, h, d))
                          .astype(np.float32)).to(cuda, dtype)
    bk = tflash.quantize_block_k(block_k, s)
    before = (tflash.flash_attention_forward.launches,
              tflash.flash_attention_dq.launches,
              tflash.flash_attention_dkv.launches)
    out, lse = tflash.flash_attention_forward(q, k, v, bk)
    delta = tflash.attention_delta(out, do)
    dq = tflash.flash_attention_dq(q, k, v, do, lse, delta)
    dk, dv = tflash.flash_attention_dkv(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    assert (tflash.flash_attention_forward.launches,
            tflash.flash_attention_dq.launches,
            tflash.flash_attention_dkv.launches) == tuple(
                n + 1 for n in before)
    want_out, want_lse = tflash.flash_attention_forward_reference(q, k, v, bk)
    want = tflash.flash_attention_backward_reference(q, k, v, do, lse, delta)
    fwd_tol, bwd_tol = FLASH_TOL[dtype]
    assert out.dtype == dtype and out.is_contiguous()
    assert _rel_err(out, want_out) <= fwd_tol
    assert _rel_err(lse, want_lse) <= 1e-5
    for got, ref in zip((dq, dk, dv), want):
        assert got.dtype == dtype and got.shape == ref.shape
        assert _rel_err(got, ref) <= bwd_tol


def _check_forward(q, k, v, block_k):
    """One forward launch against the plain version: out within the
    dtype's `FLASH_TOL` and lse within 1e-5 of the largest value."""
    bk = tflash.quantize_block_k(block_k, q.shape[1])
    before = tflash.flash_attention_forward.launches
    out, lse = tflash.flash_attention_forward(q, k, v, bk)
    torch.cuda.synchronize()
    assert tflash.flash_attention_forward.launches == before + 1
    want_out, want_lse = tflash.flash_attention_forward_reference(q, k, v,
                                                                  bk)
    assert out.dtype == q.dtype and out.shape == want_out.shape
    assert lse.shape == want_lse.shape
    assert _rel_err(out, want_out) <= FLASH_TOL[q.dtype][0]
    assert _rel_err(lse, want_lse) <= 1e-5


FORWARD_DTYPES = [torch.bfloat16, torch.float32]


@pytest.mark.parametrize("dtype", FORWARD_DTYPES)
@pytest.mark.parametrize("block_k", [None, 128])
@pytest.mark.parametrize("s", [1, 17, 65, 128, 129, 300])
def test_flash_forward_matches_plain_version(cuda, s, block_k, dtype):
    """Both forward routes on the fused projection's strided views: bf16
    the tensor-core kernel (one pass up to S = 128, key tiles above), f32
    the register-tiled one (one tile of every key up to S = 128, tiles of
    64 above); block_k = 128 streams at S = 129 and 300 and is the full-K
    rule below."""
    _check_forward(*_qkv(3, s, 2, 64, dtype, cuda, seed=s), block_k)


@pytest.mark.parametrize("dtype", FORWARD_DTYPES)
@pytest.mark.parametrize("s,block_k", [(65, None), (300, None), (300, 128)])
@pytest.mark.parametrize("d", [16, 40, 64, 128])
def test_flash_forward_head_dims(cuda, d, s, block_k, dtype):
    """Contiguous q, k, v at every padded head dim, D = 40 zero-padded to
    64; D = 128 at S = 300 takes the most shared memory of an f32 tile."""
    _check_forward(*_qkv(2, s, 2, d, dtype, cuda, seed=d + s, fused=False),
                   block_k)


@pytest.mark.parametrize("dtype", FORWARD_DTYPES)
@pytest.mark.parametrize("s,block_k", [(65, None), (129, None), (129, 128)])
def test_flash_forward_unaligned_views(cuda, s, block_k, dtype):
    """Views one element off their buffers' 16-byte starts take the
    plain-load staging, with the same answers."""
    b, h, d = 2, 3, 64
    n = b * s * h * d
    bufs = [torch.from_numpy(np.random.default_rng(i).standard_normal(
        n + 1).astype(np.float32)).to(cuda, dtype) for i in range(3)]
    q, k, v = (t[1:].view(b, s, h, d) for t in bufs)
    assert not tflash.views_aligned16(q, k, v)
    _check_forward(q, k, v, block_k)


def _check_backward(q, k, v, seed, lengths=None):
    """One dQ and one dK/dV launch (bf16: the tensor-core kernels, f32: the
    register-tiled CUDA-core ones) against the plain version, from the
    plain forward's lse and delta: dq, dk, dv within the dtype's
    `FLASH_TOL` of the largest value of the same gradient, or of 2^-8 of
    the call's largest gradient where that is larger (at S = 1 dq and dk
    are 0 in exact arithmetic, and the kernel's f32 dP - delta, summed in
    another order than delta, leaves ~1e-7 there). Returns the grads."""
    b, sq, h, d = q.shape
    rng = np.random.default_rng(seed)
    do = torch.from_numpy(rng.standard_normal((b, sq, h, d))
                          .astype(np.float32)).to(q.device, q.dtype)
    if lengths is None:
        out, lse = tflash.flash_attention_forward_reference(q, k, v)
    else:
        out, lse = masked_flash_attention_forward(q, k, v, lengths)
    delta = tflash.attention_delta(out, do)
    lse = lse.contiguous()
    before = masked_flash_attention_backward.launches
    if lengths is None and sq == k.shape[1]:
        counts = (tflash.flash_attention_dq.launches,
                  tflash.flash_attention_dkv.launches)
        grads = (tflash.flash_attention_dq(q, k, v, do, lse, delta),
                 *tflash.flash_attention_dkv(q, k, v, do, lse, delta))
        assert (tflash.flash_attention_dq.launches,
                tflash.flash_attention_dkv.launches) == tuple(
                    n + 1 for n in counts)
    elif lengths is None:  # Sq != Sk: the leaves' launches, unmasked
        grads = (tflash.launch_dq(q, k, v, do, lse, delta),
                 *tflash.launch_dkv(q, k, v, do, lse, delta))
    else:
        grads = masked_flash_attention_backward(q, k, v, lengths, do, lse,
                                                delta)
        assert masked_flash_attention_backward.launches == before + 2
    torch.cuda.synchronize()
    want = tflash.flash_attention_backward_reference(q, k, v, do, lse, delta,
                                                     lengths)
    tol = FLASH_TOL[q.dtype][1]
    top = max(float(w.float().abs().max()) for w in want)
    for got, ref in zip(grads, want):
        assert got.dtype == q.dtype and got.shape == ref.shape
        scale = max(float(ref.float().abs().max()), top / 256)
        assert float((got.float() - ref.float()).abs().max()) <= tol * scale
    return grads


BACKWARD_DTYPES = [torch.bfloat16, torch.float32]


@pytest.mark.parametrize("dtype", BACKWARD_DTYPES)
@pytest.mark.parametrize("s", [1, 17, 65, 128, 129, 300])
def test_flash_backward_matches_plain_version(cuda, s, dtype):
    """Both backward routes on the fused projection's strided views: the
    whole other axis staged up to S = 128, tiles of 64 above."""
    _check_backward(*_qkv(3, s, 2, 64, dtype, cuda, seed=s), seed=s + 1)


@pytest.mark.parametrize("dtype", BACKWARD_DTYPES)
@pytest.mark.parametrize("s", [65, 300])
@pytest.mark.parametrize("d", [16, 40, 128])
def test_flash_backward_head_dims(cuda, d, s, dtype):
    """Contiguous q, k, v at the padded head dims, D = 40 zero-padded to
    64, D = 128 past 48 KB of shared memory at S = 300."""
    _check_backward(*_qkv(2, s, 2, d, dtype, cuda, seed=d + s, fused=False),
                    seed=d)


@pytest.mark.parametrize("dtype", BACKWARD_DTYPES)
@pytest.mark.parametrize("s", [65, 129])
def test_flash_backward_unaligned_views(cuda, s, dtype):
    """Views one element off their buffers' 16-byte starts: the backward
    stages them by plain loads, with the same answers."""
    b, h, d = 2, 3, 64
    n = b * s * h * d
    bufs = [torch.from_numpy(np.random.default_rng(i).standard_normal(
        n + 1).astype(np.float32)).to(cuda, dtype) for i in range(3)]
    q, k, v = (t[1:].view(b, s, h, d) for t in bufs)
    assert not tflash.views_aligned16(q, k, v)
    _check_backward(q, k, v, seed=s)


@pytest.mark.parametrize("layout,d,offset,expect", [
    ("fused", 64, 0, True), ("contiguous", 64, 0, True),
    ("contiguous", 64, 1, False), ("contiguous", 64, 8, True),
    ("fused", 40, 0, True), ("contiguous", 40, 0, True),
    ("fused", 36, 0, False), ("contiguous", 36, 0, False)])
def test_backward_staging_rule_agrees_with_views_aligned16(
        cuda, layout, d, offset, expect):
    """The bf16 backward's C entry points decide 16-byte staging by their
    own rule (`dmt_flash_aligned16`); on every view it agrees with
    `views_aligned16`, which decides for the forward: the fused
    projection's strided views and contiguous ones, views `offset`
    elements past a buffer's start, D = 40 (80 bytes) and D = 36."""
    b, s, h = 2, 65, 2
    n = b * s * 3 * h * d if layout == "fused" else b * s * h * d
    buf = torch.zeros(n + offset, dtype=torch.bfloat16, device=cuda)[offset:]
    views = (buf.view(b, s, 3, h, d).unbind(2) if layout == "fused"
             else (buf.view(b, s, h, d),))
    rule = tflash._entry("dmt_flash_aligned16")
    for t in views:
        got = bool(rule(t.data_ptr(), *tflash._strides(t), d))
        assert got == tflash.views_aligned16(t) == expect


@pytest.mark.parametrize("b,h", [(1, 1), (2, 2), (64, 3), (1024, 8)])
def test_f32_backward_plan_agrees_with_the_c_entry(cuda, b, h):
    """The C entry points compute the f32 backward's plans themselves
    (`dmt_flash_f32_backward_plan`); at every shape they are the
    wrapper's `f32_backward_plan`."""
    import ctypes

    rule = tflash._entry("dmt_flash_f32_backward_plan")
    for sq, sk in ((1, 1), (65, 65), (128, 128), (129, 129), (300, 300),
                   (1, 4096), (7, 200), (130, 65)):
        for d in (16, 40, 64, 128):
            out = (ctypes.c_int * 6)()
            rule(b, sq, sk, h, d, out)
            want = tflash.f32_backward_plan(b, sq, sk, h, d)
            assert tuple(out) == (*want[0], *want[1]), (b, sq, sk, h, d)


@pytest.mark.parametrize("dtype", BACKWARD_DTYPES)
@pytest.mark.parametrize("sq,sk,masked", [(7, 200, False), (130, 65, False),
                                          (1, 300, True), (70, 33, True)])
def test_flash_backward_takes_sq_ne_sk(cuda, sq, sk, masked, dtype):
    """The kernels take Sq and Sk apart (the masked decode shapes): a dQ
    block walks Sk keys, a dK/dV block Sq queries."""
    b, h, d = 3, 2, 64
    rng = np.random.default_rng(sq + sk)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, n, h, d)).astype(
        np.float32)).to(cuda, dtype) for n in (sq, sk, sk))
    lengths = (torch.tensor([1, sk // 2, sk], dtype=torch.int32, device=cuda)
               if masked else None)
    _check_backward(q, k, v, seed=sq, lengths=lengths)


@pytest.mark.parametrize("dtype", BACKWARD_DTYPES)
def test_flash_backward_is_bitwise_repeatable(cuda, dtype):
    """No atomics: at ViT's shape dq, dk and dv are the same bits twice
    and under another stream, unmasked and masked."""
    q, k, v = _qkv(64, 65, 3, 64, dtype, cuda, seed=5)
    lengths = torch.arange(2, 66, dtype=torch.int32, device=cuda)
    for lens in (None, lengths):
        qc, kc, vc = ((q, k, v) if lens is None
                      else (t.contiguous() for t in (q, k, v)))
        first = _check_backward(qc, kc, vc, seed=6, lengths=lens)
        again = _check_backward(qc, kc, vc, seed=6, lengths=lens)
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            other = _check_backward(qc, kc, vc, seed=6, lengths=lens)
        torch.cuda.current_stream().wait_stream(stream)
        torch.cuda.synchronize()
        for a, b2, c in zip(first, again, other):
            assert torch.equal(a, b2) and torch.equal(a, c)


@pytest.mark.parametrize("block", ["own", "shifted"])
def test_flash_attention_lse_at_the_ring_block_with_dlse(cuda, block):
    """The ring's local call (`parallel/ring_attention.py`, ViT-Tiny at
    seq = 2: B = 128, 32 tokens, 3 heads of 64, bf16; q a strided view of
    the fused projection, K and V the rank's own strided block or a
    shifted contiguous one) through `flash_attention_lse`'s autograd
    Function with a random nonzero lse cotangent, as the ring's merge
    gives it: out, lse and the q, k, v gradients against the plain
    versions on the same inputs."""
    q, k, v = _qkv(128, 32, 3, 64, torch.bfloat16, cuda, seed=11)
    if block == "shifted":
        _, k, v = (t.contiguous() for t in _qkv(128, 32, 3, 64,
                                                torch.bfloat16, cuda,
                                                seed=12))
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out, lse = tflash.flash_attention_lse(*leaves)
    rng = np.random.default_rng(13)
    w_out = torch.from_numpy(rng.standard_normal(out.shape).astype(
        np.float32)).to(cuda, torch.bfloat16)
    w_lse = torch.from_numpy(rng.standard_normal(lse.shape).astype(
        np.float32)).to(cuda)
    grads = torch.autograd.grad((out, lse), leaves,
                                grad_outputs=(w_out, w_lse))
    with torch.no_grad():
        r_out, r_lse = tflash.flash_attention_forward_reference(q, k, v)
        want = tflash.flash_attention_backward_reference(
            q, k, v, w_out, r_lse, tflash.attention_delta(r_out, w_out,
                                                          w_lse))
    fwd_tol, bwd_tol = FLASH_TOL[torch.bfloat16]
    assert _rel_err(out, r_out) <= fwd_tol
    assert _rel_err(lse, r_lse) <= 1e-5
    for got, ref in zip(grads, want):
        assert _rel_err(got, ref) <= bwd_tol


def test_flash_attention_at_ulysses_head_dim_48(cuda):
    """Ulysses' local call (ViT-Tiny at 4 heads over seq = 2: B = 128,
    S = 64, 2 heads of 48, bf16), which the kernels run as their D = 64
    instantiation: out and the q, k, v gradients against the plain
    versions on the same inputs."""
    assert tflash.padded_head_dim(48) == 64
    q, k, v = (t.detach().requires_grad_() for t in _qkv(
        128, 64, 2, 48, torch.bfloat16, cuda, seed=14, fused=False))
    out = tflash.flash_attention(q, k, v)
    rng = np.random.default_rng(15)
    g = torch.from_numpy(rng.standard_normal(out.shape).astype(
        np.float32)).to(cuda, torch.bfloat16)
    grads = torch.autograd.grad(out, (q, k, v), grad_outputs=g)
    with torch.no_grad():
        r_out, r_lse = tflash.flash_attention_forward_reference(q, k, v)
        want = tflash.flash_attention_backward_reference(
            q, k, v, g, r_lse, tflash.attention_delta(r_out, g))
    fwd_tol, bwd_tol = FLASH_TOL[torch.bfloat16]
    assert _rel_err(out, r_out) <= fwd_tol
    for got, ref in zip(grads, want):
        assert _rel_err(got, ref) <= bwd_tol


def test_flash_attention_lse_backward_takes_dlse_on_card(cuda):
    """The autograd Function on the card against the plain versions on
    the CPU, a nonzero lse cotangent included."""
    grads = {}
    for device in ("cpu", cuda):
        q, k, v = (t.detach().requires_grad_() for t in _qkv(
            3, 65, 3, 64, torch.float32, device, seed=3, fused=False))
        out, lse = tflash.flash_attention_lse(q, k, v)
        rng = np.random.default_rng(4)
        w_out = torch.from_numpy(rng.standard_normal(out.shape)
                                 .astype(np.float32)).to(device)
        w_lse = torch.from_numpy(rng.standard_normal(lse.shape)
                                 .astype(np.float32)).to(device)
        ((out * w_out).sum() + (lse * w_lse).sum()).backward()
        grads[str(device)] = [t.cpu() for t in (out, lse, q.grad, k.grad,
                                                v.grad)]
    for got, want in zip(grads[str(cuda)], grads["cpu"]):
        assert _rel_err(got, want) <= 1e-4


@pytest.mark.parametrize("dtype", BACKWARD_DTYPES)
def test_masked_backward_zero_past_length_on_card(cuda, dtype):
    """ViT's shape with lengths 1 .. 65, both routes: dK and dV past each
    row's length are exact zeros, the kernels entered exactly ceil(len /
    tile) key tiles, and the grads match the plain version."""
    b, s, h, d = 65, 65, 3, 64
    q, k, v = (t.contiguous() for t in _qkv(b, s, h, d, dtype, cuda, seed=9))
    lens = np.arange(1, b + 1, dtype=np.int32)
    lengths = torch.from_numpy(lens).to(cuda)
    do = torch.randn(b, s, h, d, generator=torch.Generator().manual_seed(2)
                     ).to(cuda, dtype)
    before = masked_flash_attention_backward.launches
    dq, dk, dv, dq_vis, dkv_vis = masked_flash_attention_backward_probe(
        q, k, v, lengths, do)
    torch.cuda.synchronize()
    assert masked_flash_attention_backward.launches == before + 2
    for g in (dk, dv):
        for row, n in enumerate(lens):
            assert torch.count_nonzero(g[row, n:]) == 0
            assert torch.count_nonzero(g[row, :n]) > 0
    assert np.array_equal(dq_vis.cpu().numpy(), np.broadcast_to(
        (-(-lens // tflash.TILE)).astype(np.float32)[:, None, None],
        (b, h, s)))
    assert np.array_equal(dkv_vis.cpu().numpy(), np.broadcast_to(
        (-(-lens // tflash.KEY_BLOCK)).astype(np.float32)[:, None], (b, h)))
    out, lse = masked_flash_attention_forward(q, k, v, lengths)
    delta = tflash.attention_delta(out, do)
    want = tflash.flash_attention_backward_reference(q, k, v, do, lse, delta,
                                                     lengths)
    for got, ref in zip((dq, dk, dv), want):
        assert _rel_err(got, ref) <= FLASH_TOL[dtype][1]


def test_vit_remat_step_launch_counts(cuda):
    """One `dots_no_batch` remat step of the flash ViT on the card: the
    forward kernel runs twice per layer (the forward and its recompute),
    dQ and dK/dV once per layer, and no other kernel."""
    depth = 3
    model = ViTTiny(depth=depth, attention_impl="flash", scan_blocks=True)
    params, _ = model.init(torch.Generator().manual_seed(0),
                           torch.zeros(1, 32, 32, 3))
    params = tree_map(lambda t: t.to(cuda), params)
    opt = topt.adamw(1e-3, weight_decay=0.05)
    state = TrainState(torch.zeros((), dtype=torch.int32, device=cuda),
                       params, {}, opt.init(params),
                       torch.Generator(device=cuda).manual_seed(1))
    rng = np.random.default_rng(0)
    batch = {"image": torch.from_numpy(rng.integers(
                 0, 256, (64, 32, 32, 3), dtype=np.uint8)).to(cuda),
             "label": torch.from_numpy(rng.integers(
                 0, 10, 64, dtype=np.int32)).to(cuda)}
    counters = (tflash.flash_attention_forward, tflash.flash_attention_dq,
                tflash.flash_attention_dkv, masked_flash_attention,
                masked_flash_attention_backward, fused_adam_update,
                fused_adam_clip_wd_update)
    for fn in counters:
        fn.launches = 0
    step = make_train_step(model, opt, remat=True, augment=True)
    state, out = step(state, batch)
    torch.cuda.synchronize()
    assert [fn.launches for fn in counters] == [2 * depth, depth, depth,
                                                0, 0, 0, 0]
    assert np.isfinite(float(out["loss"]))


def test_checkpoint_round_trip_of_a_cuda_state(cuda, tmp_path):
    """A LeNet-5 state on the card, its CUDA generator advanced, through
    the CheckpointManager (async write): params, Adam slots and step come
    back on the card bit for bit, and the generator's state too, so the
    draws after the restore are the saved generator's."""
    from dist_mnist_tpu_torch.checkpoint import CheckpointManager
    from dist_mnist_tpu_torch.models.registry import get_model
    from dist_mnist_tpu_torch.train import create_train_state
    from dist_mnist_tpu_torch.utils.tree import flatten_with_path

    sample = np.zeros((1, 28, 28, 1), np.uint8)
    model, opt = get_model("lenet5"), topt.adam(1e-3)
    state = create_train_state(model, opt, 0, sample, cuda)
    torch.rand(1000, generator=state.rng, device=cuda)
    state = dataclasses.replace(
        state, step=torch.tensor(17, dtype=torch.int32, device=cuda))
    mgr = CheckpointManager(tmp_path)
    mgr.save(state)
    mgr.wait()
    restored = CheckpointManager(tmp_path).restore(
        create_train_state(model, opt, 1, sample, cuda))
    assert restored.step_int == 17 and restored.step.device.type == "cuda"
    for tree in ("params", "opt_state"):
        for (path, got), (_, want) in zip(
                flatten_with_path(getattr(restored, tree)),
                flatten_with_path(getattr(state, tree))):
            assert got.device.type == "cuda" and torch.equal(got, want), path
    assert restored.rng.device.type == "cuda"
    assert torch.equal(restored.rng.get_state(), state.rng.get_state())
    assert torch.equal(torch.rand(64, generator=restored.rng, device=cuda),
                       torch.rand(64, generator=state.rng, device=cuda))


def test_prefetcher_on_a_side_stream_equals_the_sync_feed(cuda):
    """100 batches through the DevicePrefetcher (pinned copies on a side
    stream, the consumer's stream waiting on each copy's event) equal the
    synchronous feed, each batch read by a kernel on the loop's stream."""
    from dist_mnist_tpu_torch.data.datasets import Dataset
    from dist_mnist_tpu_torch.data.pipeline import ShardedBatcher
    from dist_mnist_tpu_torch.data.prefetch import DevicePrefetcher

    rng = np.random.default_rng(0)
    ds = Dataset("mnist", rng.integers(0, 256, (6000, 28, 28, 1),
                                       dtype=np.uint8),
                 rng.integers(0, 10, 6000).astype(np.int32),
                 np.zeros((1, 28, 28, 1), np.uint8), np.zeros(1, np.int32))

    def sums(batches):
        out = []
        it = iter(batches)
        try:
            for _ in range(100):
                b = next(it)
                # work on the loop's stream that reads the fresh batch
                out.append(b["image"].to(torch.int64).sum()
                           + b["label"].to(torch.int64).sum())
        finally:
            if hasattr(it, "close"):
                it.close()
        return torch.stack(out).cpu()

    sync = sums(ShardedBatcher(ds, 200, cuda, seed=3))
    pre = sums(DevicePrefetcher(ShardedBatcher(ds, 200, cuda, seed=3),
                                depth=3))
    assert torch.equal(sync, pre)


def test_fork_state_on_card_survives_in_place_updates(cuda, tmp_path):
    """`fork_state` of a state on the card, then in-place updates of the
    originals on the same stream (the optimizer's kind) and a generator
    draw: the fork keeps the values it was taken with, and the
    snapshotter writes exactly those (its writer waits on the fork's
    event before the copy to the host)."""
    from dist_mnist_tpu_torch.checkpoint import (
        AsyncSnapshotter,
        CheckpointManager,
        fork_state,
    )
    from dist_mnist_tpu_torch.models.registry import get_model
    from dist_mnist_tpu_torch.train import create_train_state
    from dist_mnist_tpu_torch.utils.tree import flatten_with_path

    sample = np.zeros((1, 28, 28, 1), np.uint8)
    model, opt = get_model("lenet5"), topt.adam(1e-3)
    state = create_train_state(model, opt, 0, sample, cuda)
    want = {path: leaf.cpu() for path, leaf in
            flatten_with_path(state.params)}
    want_rng = state.rng.get_state()
    fork = fork_state(state)
    snap = AsyncSnapshotter(CheckpointManager(tmp_path, async_save=False))
    assert snap.save(state)
    for _ in range(20):
        for _, leaf in flatten_with_path(state.params):
            leaf.mul_(3.0).add_(1.0)
    torch.rand(1000, generator=state.rng, device=cuda)
    snap.wait()
    snap.close()
    for path, leaf in flatten_with_path(fork.params):
        assert leaf.device.type == "cuda" and torch.equal(leaf.cpu(),
                                                          want[path]), path
    assert torch.equal(fork.rng.get_state(), want_rng)
    restored = CheckpointManager(tmp_path).restore(
        create_train_state(model, opt, 1, sample, cuda))
    for path, leaf in flatten_with_path(restored.params):
        assert torch.equal(leaf.cpu(), want[path]), path
