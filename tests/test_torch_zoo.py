"""The zoo's classifier half and the classifier serving benches on the
CPU, against the JAX package where it has a counterpart.

`SeqGrid`, `default_seq_grid`, `parse_seq_buckets`, `supports_mask`,
`per_device_state_bytes` and the variable-height image pool are held
equal to the reference's on the same inputs. A small ViT (depth 2, dim
32, f32) behind the (batch, height) grid, with "xla" and with "flash"
attention, runs every cell, the masked native-shaped one included, and
its logits match the JAX package's `build_zoo_engine` on one CPU device
within 1e-4 of the largest logit (the JAX flash path runs its Pallas
kernels in interpret mode; the port's takes the kernels' plain versions
on the CPU). The benches run at a few dozen requests with their hard
gates.
"""

from __future__ import annotations

import dataclasses
import json
import tempfile
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_mnist_tpu.models import get_model as jget_model
from dist_mnist_tpu.ops import quant as jquant
from dist_mnist_tpu.parallel.sharding import resolve_rules
from dist_mnist_tpu.serve import loadgen as jloadgen
from dist_mnist_tpu.serve import zoo as jzoo
from dist_mnist_tpu_torch import bench
from dist_mnist_tpu_torch.cli import serve as tcli
from dist_mnist_tpu_torch.cluster.mesh import MeshSpec
from dist_mnist_tpu_torch.configs import get_config
from dist_mnist_tpu_torch.convert import params_from_jax
from dist_mnist_tpu_torch.models.registry import get_model as tget_model
from dist_mnist_tpu_torch.ops import quant as tquant
from dist_mnist_tpu_torch.serve import (
    InferenceEngine,
    InferenceServer,
    SeqGrid,
    ServeConfig,
    ServingBundle,
    build_zoo_engine,
    default_seq_grid,
    load_for_serving,
    make_varlen_images,
    parse_seq_buckets,
    per_device_state_bytes,
    run_longctx_loadgen,
    supports_mask,
)

#: the small zoo: 16 x 16 RGB images in patches of 4 (heights 4, 8, 16;
#: 4, 8 and 16 patch tokens, and CLS), batch buckets 1, 2, 4
IMAGE_SHAPE = (16, 16, 3)
SMALL_VIT = dict(depth=2, dim=32, heads=2, patch=4, dropout_rate=0.0)
MAX_BUCKET = 4


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


def _images(n, h, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(n, h, *IMAGE_SHAPE[1:]),
                        dtype=np.uint8)


# -- the planning layer against the reference ---------------------------------

@pytest.mark.parametrize("image_shape,patch", [
    ((16, 16, 3), 4), ((32, 32, 3), 4), ((28, 28, 1), 1), ((28, 28, 1), 7),
    ((20, 8, 1), 4)])
def test_seq_grid_matches_reference(image_shape, patch):
    """`default_seq_grid`'s ladder, `bucket_for` over every height,
    `n_tokens` and `mask`, the same as the reference's."""
    got = default_seq_grid(image_shape, patch)
    want = jzoo.default_seq_grid(image_shape, patch)
    assert got.heights == want.heights and got.native_only == \
        want.native_only
    native = image_shape[0]
    for h in range(1, native + 1):
        assert got.bucket_for(h) == want.bucket_for(h)
        assert got.n_tokens(h) == want.n_tokens(h)
    for bad in (0, native + 1):
        with pytest.raises(ValueError):
            got.bucket_for(bad)
        with pytest.raises(ValueError):
            want.bucket_for(bad)
    rng = np.random.default_rng(native + patch)
    for b in got.heights:
        real = rng.integers(1, b + 1, size=7)
        np.testing.assert_array_equal(got.mask(real, b), want.mask(real, b))


@pytest.mark.parametrize("spec", [None, "", "auto", "8", "4,8", "8,4,16",
                                  "16", "4,4,12"])
def test_parse_seq_buckets_matches_reference(spec):
    got = parse_seq_buckets(spec, IMAGE_SHAPE, 4)
    want = jzoo.parse_seq_buckets(spec, IMAGE_SHAPE, 4)
    if want is None:
        assert got is None
    else:
        assert dataclasses.astuple(got) == dataclasses.astuple(want)


@pytest.mark.parametrize("heights", [(6, 16), (0, 16), (2, 16)])
def test_seq_grid_refuses_what_the_reference_refuses(heights):
    for cls in (SeqGrid, jzoo.SeqGrid):
        with pytest.raises(ValueError):
            cls(native_height=16, width=16, channels=3, patch=4,
                heights=heights)


@pytest.mark.parametrize("name,kwargs", [
    ("vit_tiny", {}), ("vit_tiny", {"attention_impl": "flash"}),
    ("mlp", {}), ("lenet5", {})])
def test_supports_mask_matches_reference(name, kwargs):
    assert supports_mask(tget_model(name, **kwargs)) == \
        jzoo.supports_mask(jget_model(name, **kwargs))


@pytest.mark.parametrize("impl,pipeline", [("ring", 0), ("ulysses_flash", 0),
                                           ("xla", 2)])
def test_supports_mask_refuses_unmaskable_attention(impl, pipeline):
    """Ring and Ulysses attention and a block pipeline take no mask: the
    port's real ViTs against the reference's (the block pipeline's since
    the model-parallel slice; it was a stand-in carrying the fields both
    functions read)."""
    kw = ({"attention_impl": impl} if not pipeline
          else {"attention_impl": impl, "block_pipeline": pipeline,
                "scan_blocks": True})
    assert supports_mask(tget_model("vit_tiny", **kw)) is \
        jzoo.supports_mask(jget_model("vit_tiny", **kw)) is False


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("name", ["mlp", "lenet5", "vit_tiny"])
def test_per_device_state_bytes_matches_reference(name, quantized):
    """The same params, float or int8 (each package quantizing its own
    copy): the same resident bytes, int8 leaves at one byte plus their
    f32 scales."""
    shape = IMAGE_SHAPE if name == "vit_tiny" else (28, 28, 1)
    kwargs = SMALL_VIT if name == "vit_tiny" else {}
    jparams, _ = jget_model(name, **kwargs).init(
        jax.random.PRNGKey(1), jnp.zeros((1, *shape)))
    tparams = params_from_jax(jax.device_get(jparams))
    if quantized:
        jparams, tparams = (jquant.quantize_tree(jparams),
                            tquant.quantize_tree(tparams))
    assert per_device_state_bytes(tparams, {}) == \
        jzoo.per_device_state_bytes(jparams, {})


def test_make_varlen_images_matches_reference():
    for seed in (0, 1):
        got = make_varlen_images((32, 32, 3), 4, seed=seed)
        want = jloadgen.make_varlen_images((32, 32, 3), 4, seed=seed)
        assert len(got) == len(want) == 256
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


# -- a small ViT zoo engine against the JAX package's -------------------------

def _engines(mesh1, impl):
    """(port zoo engine on the CPU, JAX zoo engine on one CPU device): the
    small f32 ViT with `impl` attention behind the auto height ladder,
    the same params."""
    jmodel = jget_model("vit_tiny", compute_dtype=jnp.float32,
                        attention_impl=impl, **SMALL_VIT)
    tmodel = tget_model("vit_tiny", compute_dtype=torch.float32,
                        attention_impl=impl, **SMALL_VIT)
    jparams, _ = jmodel.init(jax.random.PRNGKey(3),
                             jnp.zeros((1, *IMAGE_SHAPE)))
    jparams = jax.device_get(jparams)
    jbundle = types.SimpleNamespace(
        model=jmodel, params=jparams, model_state={}, image_shape=IMAGE_SHAPE,
        rules=resolve_rules("dp"), quant=None, quant_report=None)
    tbundle = ServingBundle(
        model=tmodel, params=params_from_jax(jparams), model_state={},
        image_shape=IMAGE_SHAPE, step=0, restored=False)
    jeng = jzoo.build_zoo_engine(jbundle, mesh1, model_name=f"zoo_{impl}",
                                 max_bucket=MAX_BUCKET, seq_buckets="auto")
    teng = build_zoo_engine(tbundle, "cpu", model_name=f"zoo_{impl}",
                            max_bucket=MAX_BUCKET, seq_buckets="auto")
    return teng, jeng


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_zoo_engine_every_cell_matches_jax(mesh1, impl):
    """Every (batch, height) cell: a batch that fills its bucket, images
    of each height bucket with rows of several real heights inside it,
    through both engines; the native bucket twice, all rows full (the
    dense maskless cell) and some short (the masked native-shaped cell).
    Logits within 1e-4 of the largest; the port's engine ran every cell
    once, and traffic after its prewarm runs none for the first time."""
    teng, jeng = _engines(mesh1, impl)
    assert teng.grid() == jeng.grid()
    cells = len(teng.buckets()) * (1 + len(teng.seq_grid.heights))
    assert teng.prewarm() == cells and teng.prewarm() == 0
    assert teng.misses == cells
    rng = np.random.default_rng(11)
    low = {4: 1, 8: 5, 16: 9}
    for bucket in teng.buckets():
        n = bucket if bucket == 1 else bucket - 1  # padded batch rows too
        for h in teng.seq_grid.heights:
            images = _images(n, h, seed=bucket * 100 + h)
            for heights in (None, rng.integers(low[h], h + 1, size=n)):
                if heights is not None:
                    heights[0] = low[h]
                    for row, r in enumerate(heights):
                        images[row, r:] = 0
                got = teng.predict(images, heights=heights)
                want = np.asarray(jeng.predict(images, heights=heights))
                assert got.shape == want.shape == (n, 10)
                err = float(np.max(np.abs(got - want)))
                assert err <= 1e-4 * float(np.max(np.abs(want))), (
                    bucket, h, heights)
    assert teng.misses == cells  # traffic ran no cell for the first time
    stats = teng.cache_stats()
    assert set(stats["per_cell"]) == {
        f"{b}x{h}/masked" for b in teng.buckets()
        for h in teng.seq_grid.heights} | {
        f"{b}x16/dense" for b in teng.buckets()}
    assert stats["misses"] == cells
    assert stats["hits"] == stats["execute_count"] - cells
    assert teng.seq_bucket_counts == {
        h: 2 * len(teng.buckets()) for h in teng.seq_grid.heights}


def test_variant_contract_and_refusals():
    """Full-height rows take the dense cell, a short row in the native
    bucket the masked native-shaped one; the seq grid must match the
    image shape; a height the engine cannot serve raises."""
    model = tget_model("vit_tiny", compute_dtype=torch.float32, **SMALL_VIT)
    params, state = model.init(torch.Generator().manual_seed(0),
                               torch.zeros(1, *IMAGE_SHAPE))
    eng = InferenceEngine(model, params, state, device="cpu",
                          image_shape=IMAGE_SHAPE, max_bucket=4,
                          seq_grid=default_seq_grid(IMAGE_SHAPE, 4))
    images = _images(3, 16, seed=0)
    full = eng.predict(images)
    short = eng.predict(images, heights=[16, 12, 16])
    assert eng.cache_stats()["per_cell"] == {"4x16/dense": 1,
                                             "4x16/masked": 1}
    np.testing.assert_allclose(short[[0, 2]], full[[0, 2]], rtol=0,
                               atol=1e-5 * float(np.abs(full).max()))
    with pytest.raises(ValueError, match="native"):
        eng.predict(_images(1, 20, seed=1))
    with pytest.raises(ValueError, match="seq_grid"):
        InferenceEngine(model, params, state, device="cpu",
                        image_shape=(32, 32, 3),
                        seq_grid=default_seq_grid(IMAGE_SHAPE, 4))
    plain = InferenceEngine(model, params, state, device="cpu",
                            image_shape=IMAGE_SHAPE, max_bucket=4)
    with pytest.raises(ValueError, match="seq grid"):
        plain.predict(_images(2, 8, seed=2))
    with pytest.raises(ValueError, match="seq grid"):
        plain.predict(images, heights=[16, 12, 16])
    assert plain.grid() == [(1, 16), (2, 16), (4, 16)]
    assert "per_cell" not in plain.cache_stats()


@pytest.mark.parametrize("kwargs,item", [
    ({"moe_capacity_factor": 1.5}, "no moe_capacity_factor field"),
    ({"memory_budget_mb": 64.0}, "items 13 and 15"),
    ({"store": object()}, "items 13 and 15")])
def test_build_zoo_engine_refuses_later_arguments(kwargs, item):
    bundle = load_for_serving("mlp_mnist", "cpu")
    with pytest.raises(ValueError, match=item):
        build_zoo_engine(bundle, "cpu", model_name="mlp", **kwargs)


@pytest.mark.parametrize("mesh", [MeshSpec(data=1),
                                  MeshSpec(data=1, model=1)])
def test_build_zoo_engine_on_a_one_rank_mesh_serves_the_plain_engine(mesh):
    """A mesh spec of the one process's rank (the sharded placement's
    tests spawn ranks: tests/test_torch_zoo_sharded.py) serves the plain
    engine's logits, unsharded."""
    bundle = load_for_serving("mlp_mnist", "cpu")
    eng = build_zoo_engine(bundle, "cpu", model_name="mlp", max_bucket=8,
                           mesh=mesh)
    plain = build_zoo_engine(bundle, "cpu", model_name="mlp", max_bucket=8)
    images = np.random.default_rng(1).integers(0, 256, (3, 28, 28, 1),
                                               dtype=np.uint8)
    assert eng.mesh is None and eng.buckets() == plain.buckets()
    np.testing.assert_array_equal(eng.predict(images), plain.predict(images))


def test_unmaskable_model_collapses_to_native_grid(caplog):
    bundle = load_for_serving("mlp_mnist", "cpu")
    eng = build_zoo_engine(bundle, "cpu", model_name="mlp", max_bucket=8,
                           seq_buckets="auto", mesh=MeshSpec())
    assert eng.seq_grid.heights == (28,) and "cannot honor" in caplog.text
    assert eng.prewarm() == 4  # the dense native cells alone
    q = build_zoo_engine(load_for_serving("mlp_mnist", "cpu", quant="int8"),
                         "cpu", model_name="mlp")
    assert q.quant == "int8" and q.seq_grid is None


# -- loadgen, batcher and server over the grid --------------------------------

def _small_vit_bundle(impl="xla"):
    model = tget_model("vit_tiny", compute_dtype=torch.float32,
                       attention_impl=impl, **SMALL_VIT)
    params, state = model.init(torch.Generator().manual_seed(0),
                               torch.zeros(1, *IMAGE_SHAPE))
    return ServingBundle(model=model, params=params, model_state=state,
                         image_shape=IMAGE_SHAPE, step=0, restored=False)


def test_longctx_loadgen_routing_counts_follow_the_buckets():
    """One request in flight at a time, so each request is its own batch:
    the routing counts are the pool's heights mapped to their buckets,
    the mixed heights of a window each run in their own cell, and no
    cell runs for the first time after prewarm."""
    eng = build_zoo_engine(_small_vit_bundle(), "cpu", model_name="zoo",
                           max_bucket=4, seq_buckets="auto")
    n = 40
    server = InferenceServer(eng, ServeConfig(max_batch=4, max_wait_ms=0.5))
    with server:
        summary = run_longctx_loadgen(server, n_requests=n, concurrency=1,
                                      seed=3)
    pool = make_varlen_images(IMAGE_SHAPE, 4, seed=3)
    want = {}
    for img in pool[:n]:
        b = str(eng.seq_grid.bucket_for(img.shape[0]))
        want[b] = want.get(b, 0) + 1
    assert summary["ok"] == n and summary["errors"] == 0
    assert summary["seq_bucket_counts"] == want
    assert summary["recompiles_during_traffic"] == 0
    assert summary["n_batches"] == n
    occupancy = np.mean([eng.seq_grid.n_tokens(i.shape[0])
                         / eng.seq_grid.n_tokens(eng.seq_grid.bucket_for(
                             i.shape[0])) for i in pool[:n]])
    assert summary["mean_seq_occupancy"] == pytest.approx(occupancy)


def test_batcher_groups_a_window_by_shape():
    """A window of mixed heights: each shape its own engine batch, every
    request answered with its own image's logits."""
    eng = build_zoo_engine(_small_vit_bundle(), "cpu", model_name="zoo",
                           max_bucket=4, seq_buckets="auto")
    images = [_images(1, h, seed=h)[0] for h in (4, 16, 8, 4, 16, 12, 4, 4,
                                                 4, 4)]
    server = InferenceServer(eng, ServeConfig(max_batch=16, max_wait_ms=50))
    with server:
        futures = [server.submit(img) for img in images]
        results = [f.result(timeout=60) for f in futures]
    for img, res in zip(images, results):
        np.testing.assert_allclose(res.logits, eng.predict(img[None])[0],
                                   rtol=0, atol=1e-5)
    assert server.stats()["failed"] == 0


# -- the benches and the CLI ---------------------------------------------------

def test_run_serve_quant_gates_pass_on_cpu():
    bytes_rec, p99_rec = bench.run_serve_quant(torch.device("cpu"), 48, 16)
    assert bytes_rec["metric"] == "quant_resident_bytes_ratio"
    assert bytes_rec["value"] <= 0.30
    extra = p99_rec["extra"]
    assert p99_rec["metric"] == "quant_p99_ms" and extra["ok"] == 48
    assert extra["top1_agreement"] >= 0.99
    assert extra["p99_within_1_10x"] == (extra["p99_ratio_vs_float"] <= 1.10)
    assert extra["batches_run"]["int8"] == extra["cache"]["execute_count"]
    record = bench.run_serve(torch.device("cpu"), 48, 16)
    assert record["metric"] == "serve_p99_latency_ms"
    assert record["extra"]["ok"] == 48


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_run_serve_longctx_gates_pass_on_cpu(impl):
    name = "vit_tiny_cifar" if impl == "xla" else "vit_tiny_cifar_flash"
    cfg = get_config(name)
    cfg = dataclasses.replace(cfg, model_kwargs={
        **cfg.model_kwargs, "dim": 32, "depth": 2, "heads": 2})
    record = bench.run_serve_longctx(torch.device("cpu"), 48, 16, config=cfg)
    extra = record["extra"]
    assert record["metric"] == "longctx_p99_ms" and extra["ok"] == 48
    assert extra["seq_buckets"] == [4, 8, 16, 32]
    assert extra["recompiles_during_traffic"] == 0
    assert sum(extra["seq_bucket_counts"].values()) >= 48 // 16
    assert len(extra["cache"]["per_cell"]) == 6 * 5  # buckets 1..32 x cells


def test_bench_serve_flags(capsys):
    with pytest.raises(SystemExit, match="takes --serve"):
        bench.main(["--quant", "--device=cpu"])
    with pytest.raises(SystemExit, match="one serving mode"):
        bench.main(["--serve", "--quant", "--longctx", "--device=cpu"])
    with pytest.raises(SystemExit):  # argparse: not a flag of the port's
        bench.main(["--serve", "--fleet", "--device=cpu"])
    records = bench.main(["--serve", "--quant", "--device=cpu",
                          "--requests=32", "--concurrency=8"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert [r["metric"] for r in lines] == [r["metric"] for r in records] \
        == ["quant_resident_bytes_ratio", "quant_p99_ms"]


def test_cli_seq_buckets_on_cpu(capsys):
    summary = tcli.main(["--config=mlp_mnist", "--device=cpu",
                         "--seq_buckets=auto", "--requests=32",
                         "--concurrency=8", "--max_batch=8"])
    assert summary["ok"] == 32 and summary["errors"] == 0
    assert summary["seq_buckets"] == [28]  # the MLP cannot mask tokens
    assert sum(summary["seq_bucket_counts"].values()) == summary["n_batches"]
    assert summary["serve_state_bytes_per_device"]["total_bytes"] > 0
    assert "seq_buckets" not in tcli.main([
        "--config=mlp_mnist", "--device=cpu", "--requests=8",
        "--concurrency=4", "--max_batch=4"])
    capsys.readouterr()
