"""The port's native C++ layer against the JAX package's, on the CPU: the
prefetching loader (`data/native`) and the parameter-server demo
(`parallel/ps_demo`), both built from the port's own sources with g++
into `build/torch_native/`.

- Loader: 10 batches at seed 7 and batch 64 equal the reference
  `NativeBatcher`'s bit for bit (the reference on the conftest CPU mesh,
  its library built by its own helper); an epoch covers each row at most
  once and every batch's rows are distinct; a batch larger than the
  dataset raises; `at_step(k)` equals the stream advanced by k; on four
  gloo ranks (data 2 x model 2) the two data ranks' slices are disjoint
  and join to the one-rank global batch, and the two model ranks of a
  data rank get the same rows; iterating yields tensors on the mesh's
  device through a `DevicePrefetcher`.
- PS: the port's `ParameterServer` and the reference's, given the same
  init, push_async, push_sync and chief_sync_once sequence, pull the same
  bits; its Adam is within 1e-6 of the port's plain `optim.adam`; the
  demo's gradient of the reference's flat params (laid out in
  `ravel_pytree`'s order) is within 1e-5 of the reference's; `run_demo`
  on the CPU reaches the reference test's accuracy floors in both modes.
- The library is named by the digest of its source, under
  `build/torch_native/`, never beside the source.
"""

from __future__ import annotations

import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from dist_mnist_tpu.models import get_model as jget_model
from dist_mnist_tpu.ops import losses as jlosses
from dist_mnist_tpu_torch import optim
from dist_mnist_tpu_torch.convert import params_from_jax
from dist_mnist_tpu_torch.data.datasets import Dataset
from dist_mnist_tpu_torch.data.native import NativeBatcher, build_library
from dist_mnist_tpu_torch.parallel.ps_demo import ParameterServer, run_demo
from dist_mnist_tpu_torch.parallel.ps_demo import build_library as build_ps
from dist_mnist_tpu_torch.parallel.ps_demo.demo import make_grad_fn, ravel
from dist_mnist_tpu_torch.utils import native_build

import torch_native_cases as cases
import torch_ranks

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


def _indexed(n: int = 1000) -> Dataset:
    """A dataset whose row i holds i in its first two pixels (and its
    label i % 10), so a batch names the rows it took."""
    images = np.zeros((n, 28, 28, 1), np.uint8)
    images[:, 0, 0, 0] = np.arange(n) % 256
    images[:, 0, 1, 0] = np.arange(n) // 256
    labels = (np.arange(n) % 10).astype(np.int32)
    return Dataset("mnist", images, labels, images[:10], labels[:10])


def _rows(images: np.ndarray) -> np.ndarray:
    return (images[:, 0, 0, 0].astype(np.int64)
            + 256 * images[:, 0, 1, 0].astype(np.int64))


# -- the loader ---------------------------------------------------------------


def test_libraries_build_by_digest_outside_the_source_tree():
    for path, src in ((build_library(), "loader.cc"),
                      (build_ps(), "ps_server.cc")):
        assert path.parent == native_build.BUILD_DIR
        assert path.parent == ROOT / "build" / "torch_native"
        assert path.name.startswith(f"lib{Path(src).stem}-")
        assert path.exists()
    port = ROOT / "dist_mnist_tpu_torch"
    assert not list(port.rglob("*.so"))


def test_loader_batches_equal_the_reference(mesh8, small_mnist):
    from dist_mnist_tpu.data.native import NativeBatcher as JNativeBatcher

    ref = JNativeBatcher(small_mnist, 64, mesh8, seed=7)
    ours = NativeBatcher(small_mnist, 64, None, seed=7)
    try:
        for _ in range(10):
            ri, rl, rs = ref.next_local()
            ti, tl, ts = ours.next_local()
            assert rs == ts
            np.testing.assert_array_equal(ri, ti)
            np.testing.assert_array_equal(rl, tl)
    finally:
        ref.close()
        ours.close()


def test_loader_epoch_takes_each_row_once():
    ds = _indexed()
    batch = 96
    nb = NativeBatcher(ds, batch, None, seed=3)
    try:
        rows = np.concatenate([_rows(nb.next_local()[0])
                               for _ in range(1000 // batch)])
    finally:
        nb.close()
    assert len(rows) == len(set(rows.tolist())) == (1000 // batch) * batch


def test_loader_rejects_bad_batch(small_mnist):
    with pytest.raises(ValueError):
        NativeBatcher(small_mnist, 1 << 20, None)


def test_at_step_equals_the_advanced_stream():
    ds = _indexed()
    a = NativeBatcher(ds, 64, None, seed=5)
    b = a.at_step(17)
    try:
        for _ in range(17):
            a.next_local()
        for _ in range(20):  # past the epoch boundary (15 batches)
            ai, al, as_ = a.next_local()
            bi, bl, bs = b.next_local()
            assert as_ == bs
            np.testing.assert_array_equal(ai, bi)
            np.testing.assert_array_equal(al, bl)
    finally:
        a.close()
        b.close()


def test_iterating_yields_tensors_through_the_prefetcher():
    ds = _indexed()
    nb = NativeBatcher(ds, 32, None, seed=1)
    want = NativeBatcher(ds, 32, None, seed=1)
    it = iter(nb)
    try:
        for _ in range(3):
            batch = next(it)
            img, lab, _ = want.next_local()
            assert batch["image"].device == torch.device("cpu")
            assert torch.equal(batch["image"], torch.from_numpy(img))
            assert torch.equal(batch["label"], torch.from_numpy(lab))
    finally:
        it.close()
        nb.close()
        want.close()


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return torch_ranks.run_ranks(cases.native_slices, 4,
                                 tmp_path_factory.mktemp("native"),
                                 _indexed(), 64, 5,
                                 {"data": 2, "model": 2}, timeout=120)


def test_data_ranks_split_the_global_batch(four_ranks):
    one = NativeBatcher(_indexed(), 64, None, seed=7)
    try:
        whole = [one.next_local() for _ in range(5)]
    finally:
        one.close()
    by_data = {}
    for r in four_ranks:
        by_data.setdefault(r["data"], r)
    for step, (img, lab, s) in enumerate(whole):
        d0 = by_data[0]["batches"][step]
        d1 = by_data[1]["batches"][step]
        assert d0[2] == d1[2] == s
        assert not set(_rows(d0[0]).tolist()) & set(_rows(d1[0]).tolist())
        np.testing.assert_array_equal(np.concatenate([d0[0], d1[0]]), img)
        np.testing.assert_array_equal(np.concatenate([d0[1], d1[1]]), lab)


def test_model_ranks_get_the_same_rows(four_ranks):
    for d in (0, 1):
        pair = [r for r in four_ranks if r["data"] == d]
        assert sorted(r["model"] for r in pair) == [0, 1]
        for (ai, al, _), (bi, bl, _) in zip(pair[0]["batches"],
                                             pair[1]["batches"]):
            np.testing.assert_array_equal(ai, bi)
            np.testing.assert_array_equal(al, bl)


# -- the parameter server -----------------------------------------------------


def _ps_sequence(cls) -> list:
    """The same calls on a PS of `cls`: what each pull returns."""
    rng = np.random.default_rng(0)
    pulls = []
    ps = cls([37, 5], lr=0.01, staleness_bound=2)
    ps.init(rng.normal(size=42).astype(np.float32))
    for i in range(6):
        ps.push_async(rng.normal(size=42).astype(np.float32), i // 2)
        pulls.append(ps.pull())
    pulls.append(("dropped", ps.dropped))
    sync = cls([42], lr=0.05, replicas_to_aggregate=2)
    sync.init(rng.normal(size=42).astype(np.float32))
    for step in range(3):
        for _ in range(2):
            sync.push_sync(rng.normal(size=42).astype(np.float32), step)
        sync.push_sync(rng.normal(size=42).astype(np.float32), step - 1)
        assert sync.chief_sync_once(tokens_per_step=2) == step + 1
        assert [sync.dequeue_token() for _ in range(2)] == [step + 1] * 2
        pulls.append(sync.pull())
    pulls.append(("dropped", sync.dropped))
    ps.close()
    sync.close()
    return pulls


def test_ps_pulls_the_reference_bits():
    from dist_mnist_tpu.parallel.ps_demo.bindings import (
        ParameterServer as JParameterServer,
    )

    ours, ref = _ps_sequence(ParameterServer), _ps_sequence(JParameterServer)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        if isinstance(a[0], np.ndarray):
            np.testing.assert_array_equal(a[0], b[0])
            assert a[1] == b[1]
        else:
            assert a == b


def test_ps_adam_matches_the_plain_adam():
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(37,)).astype(np.float32)
    grads = [rng.normal(size=(37,)).astype(np.float32) for _ in range(4)]
    ps = ParameterServer([37], lr=0.01)
    ps.init(p0)
    for i, g in enumerate(grads):
        assert ps.push_async(g, local_step=i)
    native, step = ps.pull()
    assert step == 4
    opt = optim.adam(0.01)
    params = {"w": torch.from_numpy(p0.copy())}
    state = opt.init(params)
    for g in grads:
        updates, state = opt.update({"w": torch.from_numpy(g)}, state,
                                    params)
        params = optim.apply_updates(params, updates)
    np.testing.assert_allclose(native, params["w"].numpy(), rtol=0,
                               atol=1e-6)


def test_demo_gradient_matches_the_reference(small_mnist):
    model = jget_model("mlp", hidden_units=100)
    params0, _ = model.init(jax.random.PRNGKey(0),
                            small_mnist.train_images[:1])
    flat0, unravel_j = ravel_pytree(params0)

    def loss_of(flat, x, y):
        logits, _ = model.apply(unravel_j(flat), {}, x, train=False)
        return jlosses.clipped_softmax_cross_entropy(logits, y)

    x_u8 = small_mnist.train_images[:100]
    y = small_mnist.train_labels[:100]
    xj = jnp.asarray(x_u8, jnp.float32) / 255.0
    want = np.asarray(jax.grad(loss_of)(flat0, xj, jnp.asarray(y)))

    from dist_mnist_tpu_torch.models.mlp import MLP
    from dist_mnist_tpu_torch.ops.nn import normalize_images

    flat, layout = ravel(params_from_jax(jax.device_get(params0)))
    np.testing.assert_array_equal(flat, np.asarray(flat0))
    grad_fn = make_grad_fn(MLP(hidden_units=100), layout, torch.device("cpu"))
    got = grad_fn(flat, normalize_images(torch.from_numpy(x_u8)),
                  torch.from_numpy(y.astype(np.int64)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode,floor", [("sync", 0.8), ("async", 0.6)])
def test_run_demo_on_cpu_reaches_the_reference_floors(small_mnist, mode,
                                                      floor):
    out = run_demo(mode=mode, num_workers=2, train_steps=120,
                   dataset=small_mnist, device="cpu")
    assert out["global_step"] >= 120
    assert out["test_accuracy"] > floor
    assert sum(out["per_worker_applies"]) > 0
    assert out["device"] == "cpu"


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_run_demo_raises_a_worker_error_after_joining(small_mnist,
                                                       monkeypatch, mode):
    """A worker that fails stops the run: the error reaches the caller
    and no demo thread is left (sync: the chief blocked on a take)."""
    import threading

    from dist_mnist_tpu_torch.parallel.ps_demo import demo

    def failing(*_):
        def grad_fn(*_):
            raise RuntimeError("gradient failed")
        return grad_fn

    monkeypatch.setattr(demo, "make_grad_fn", failing)
    with pytest.raises(RuntimeError, match="gradient failed"):
        run_demo(mode=mode, num_workers=2, train_steps=50,
                 dataset=small_mnist, device="cpu")
    assert not [t for t in threading.enumerate()
                if t.name.startswith("ps-demo")]
