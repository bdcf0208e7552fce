"""The compile cache (`compilecache/`) and the attribution benches on the
CPU: the store's key, a real g++ build of the native loader through the
store (cold build, warm hit, a truncated entry quarantined and rebuilt;
three builds in this file), a soft save failure, the key fields against
the reference's, the startup clock and its hook, the loop's compile
bucket, the launcher's forwarding of `--compile_cache_dir`, the journal's
`compile_cache` outcomes against the reference's, and `bench --input`,
`--memory`, `--overlap` (one rank) and `--coldstart` at a few steps."""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import io
import os
import shutil
import sys
import tempfile
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from dist_mnist_tpu import configs as jconfigs
from dist_mnist_tpu.cli.train import run_config as jrun_config
from dist_mnist_tpu.cluster.mesh import MeshSpec as JMeshSpec
from dist_mnist_tpu.cluster.mesh import make_mesh as jmake_mesh
from dist_mnist_tpu.compilecache.key_fields import (
    compile_cache_key_fields as jkey_fields,
)
from dist_mnist_tpu_torch import bench
from dist_mnist_tpu_torch.cli import launch as launch_mod
from dist_mnist_tpu_torch.cli import train as cli
from dist_mnist_tpu_torch.cluster.mesh import Mesh
from dist_mnist_tpu_torch.compilecache import (
    StartupClock,
    StartupHook,
    cache_key,
    enable_persistent_cache,
)
from dist_mnist_tpu_torch.compilecache import store as store_mod
from dist_mnist_tpu_torch.compilecache.key_fields import (
    compile_cache_key_fields,
)
from dist_mnist_tpu_torch.configs import get_config
from dist_mnist_tpu_torch.data import datasets
from dist_mnist_tpu_torch.obs import events
from dist_mnist_tpu_torch.train import TrainState
from dist_mnist_tpu_torch.train.loop import TrainLoop
from dist_mnist_tpu_torch.utils import native_build

LOADER = (Path(__file__).resolve().parents[1] / "dist_mnist_tpu_torch"
          / "data" / "native" / "loader.cc")


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


@pytest.fixture(autouse=True)
def _no_port_leaks():
    """The port's own state after each test: no store temp file pending,
    no launched child alive, no store left enabled."""
    yield
    assert not store_mod._PENDING_TMP, store_mod._PENDING_TMP
    assert not [p for p in launch_mod._LIVE_CHILDREN if p.poll() is None]
    assert store_mod.active() is None


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory) -> str:
    """A small MNIST twin (2,048 train / 500 test) both packages read."""
    path = tmp_path_factory.mktemp("mnist-data")
    datasets._write_synth_cache(path, "mnist",
                                datasets._synth("mnist", 2048, 500, 0))
    return str(path)


# -- the key -----------------------------------------------------------------

def test_cache_key_is_stable():
    fields = {"kind": "native", "stem": "loader", "digest": "ab"}
    assert cache_key(fields) == cache_key(dict(reversed(fields.items())))
    assert len(cache_key(fields)) == 32


@pytest.mark.parametrize("field,value", [
    ("digest", "cd"), ("torch_version", "0.0"), ("cuda_version", "99.9"),
    ("capability", [8, 0]), ("compiler", "gcc (other) 1.0"),
])
def test_cache_key_changes_with_every_field(field, value):
    """The source's digest, and each part of the runtime's identity the
    key merges in (torch, its CUDA, the card's capability, the
    compiler's version line), changes the key."""
    fields = {"kind": "native", "stem": "loader", "digest": "ab"}
    assert cache_key({**fields, field: value}) != cache_key(fields)


@pytest.mark.parametrize("name,over", [
    ("mlp_mnist", {}),
    ("resnet20_cifar_fsdp", {"overlap": True, "overlap_bucket_mb": 0.25}),
    ("resnet20_cifar_fsdp", {"overlap": True, "overlap_chunk": "ring"}),
    ("vit_tiny_cifar_fsdp_tp", {"train_steps": 7}),
])
def test_key_fields_equal_the_reference(name, over):
    """`compile_cache_key_fields` of the same config (overlap knobs
    included) on a one-rank mesh is the reference's dict."""
    jmesh = jmake_mesh(JMeshSpec(data=1), devices=jax.devices()[:1])
    mesh = Mesh(shape={"data": 1, "model": 1, "seq": 1, "pipe": 1})
    want = jkey_fields(dataclasses.replace(jconfigs.get_config(name), **over),
                       jmesh, scan_chunk=4, input_pipeline="device")
    got = compile_cache_key_fields(
        dataclasses.replace(get_config(name), **over), mesh, scan_chunk=4,
        input_pipeline="device")
    assert got == want
    assert cli.compile_cache_key_fields is compile_cache_key_fields


# -- the store, with a real g++ build ----------------------------------------

def _build(out: Path) -> None:
    native_build._compile(LOADER, out)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The loader built cold into a store (build 1), loaded warm, then
    its entry replaced by a truncated copy (a new file: the process maps
    the old one) and loaded again: quarantined and rebuilt (build 2).
    Each step's stats, events and handle."""
    root = tmp_path_factory.mktemp("store")
    journal = events.RunJournal(root / "journal.jsonl")
    prev = events.set_journal(journal)
    try:
        store = store_mod.ExecutableStore(root / "native")
        key = native_build.store_key(LOADER)
        out = {"key": key, "store": store}
        for tag in ("cold", "warm"):
            lib, path = store_mod.open_library(store, key, _build,
                                               ctypes.CDLL)
            out[tag] = {"lib": lib, "path": path, "stats": store.stats()}
        entry = store.path(key)
        data = entry.read_bytes()
        out["entry_bytes"] = data
        trunc = entry.with_name("truncated")
        trunc.write_bytes(data[:len(data) // 2])
        os.replace(trunc, entry)
        lib, path = store_mod.open_library(store, key, _build, ctypes.CDLL)
        out["healed"] = {"lib": lib, "path": path, "stats": store.stats()}
    finally:
        events.set_journal(prev)
        journal.close()
    out["events"] = [r for r in events.read_journal(root / "journal.jsonl")
                     if r["event"] == "compile_cache"]
    return out


def test_cold_process_builds_and_saves(built):
    st = built["cold"]["stats"]
    assert (st["misses"], st["builds"], st["hits"], st["entries"]) == (
        1, 1, 0, 1)
    assert st["build_ms"] > 0 and st["bytes_written"] > 0
    assert built["cold"]["lib"].loader_create  # the symbols resolve
    assert [r["outcome"] for r in built["events"]][:2] == ["miss", "save"]


def test_warm_load_hits_and_reports_the_build_saved(built):
    st = built["warm"]["stats"]
    assert (st["hits"], st["builds"]) == (1, 1)
    assert st["compile_ms_saved"] == built["cold"]["stats"]["build_ms"]
    assert built["warm"]["lib"].loader_next
    assert built["events"][2]["outcome"] == "hit"


def test_truncated_entry_is_quarantined_and_rebuilt(built):
    """The truncated entry never reaches dlopen: it is renamed to
    ``*.corrupt``, a `corrupt` event is journaled, the library is rebuilt
    and the new entry is whole again."""
    st = built["healed"]["stats"]
    assert (st["corrupt"], st["builds"], st["misses"]) == (1, 2, 2)
    entry = built["store"].path(built["key"])
    assert entry.with_name(entry.name + ".corrupt").exists()
    assert store_mod._read_entry(entry.read_bytes())[1]["bytes"] > 0
    assert built["healed"]["lib"].loader_destroy
    assert [r["outcome"] for r in built["events"]][3:] == [
        "corrupt", "save"]


def test_foreign_file_is_a_quarantined_miss(built, tmp_path):
    """A file without the store's trailer, or with a digest that does
    not match it, is a miss (quarantined), never handed to dlopen."""
    store = store_mod.ExecutableStore(tmp_path)
    lib, meta = store_mod._read_entry(built["entry_bytes"])
    for i, blob in enumerate((b"\x7fELF not a library",
                              built["entry_bytes"][:-40] + b"x" * 40,
                              bytes([lib[0] ^ 0xFF]) + built[
                                  "entry_bytes"][1:])):
        key = f"k{i}"
        store.path(key).write_bytes(blob)
        assert store.get(key) is None
        assert store.path(key).with_name(f"{key}.so.corrupt").exists()
    assert store.stats()["corrupt"] == 3


def test_a_failed_save_is_soft(built, tmp_path, monkeypatch, caplog):
    """A save that fails (a full disk) logs, returns None and leaves no
    temp file; the library built for it still loads."""
    store = store_mod.ExecutableStore(tmp_path)
    lib_bytes, _ = store_mod._read_entry(built["entry_bytes"])

    def copy_build(out: Path) -> None:  # the build, without a compiler
        out.write_bytes(lib_bytes)

    def full_disk(*a, **k):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(store_mod.os, "replace", full_disk)
    lib, path = store_mod.open_library(store, "key", copy_build, ctypes.CDLL)
    assert lib.loader_create and not path.exists()
    assert "continuing uncached" in caplog.text
    assert store.stats()["entries"] == 0 and store.stats()["builds"] == 1
    assert list(tmp_path.iterdir()) == []


def test_enable_points_the_native_builder_at_the_store(built, tmp_path):
    """`enable_persistent_cache(dir)`: `native_build` loads through
    ``dir/native`` (a warm entry there is a hit, no build) and the step's
    `consume_compile_s` drains the seconds the load took."""
    from dist_mnist_tpu_torch.models.mlp import MLP
    from dist_mnist_tpu_torch.optim import adam
    from dist_mnist_tpu_torch.train import make_train_step

    (tmp_path / "native").mkdir()
    shutil.copy(built["store"].path(built["key"]),
                tmp_path / "native" / f"{built['key']}.so")
    prev = store_mod.set_active(None)
    cache = enable_persistent_cache(tmp_path)
    saved = dict(native_build._loaded)
    native_build._loaded.clear()
    try:
        native_build.consume_build_s()
        lib = native_build.load_lib(LOADER, {})
        step = make_train_step(MLP(), adam(1e-3))
        assert step.consume_compile_s() > 0
        assert step.consume_compile_s() == 0.0
    finally:
        native_build._loaded.clear()
        native_build._loaded.update(saved)
        store_mod.set_active(prev)
    assert lib.loader_create
    st = cache.stats()
    assert (st["hits"], st["builds"], st["entries"]) == (1, 0, 1)


# -- startup attribution -----------------------------------------------------

def test_startup_clock_buckets_and_residual():
    clock = StartupClock(t0=100.0)
    clock.note("import", 0.5)
    clock.note("init", 1.25)
    clock.note("restore", -3.0)  # negative durations are clamped to 0
    with clock.phase("compile"):
        pass
    snap = clock.snapshot()
    assert "time_to_first_step_ms" not in snap
    assert (snap["import_ms"], snap["init_ms"], snap["restore_ms"]) == (
        500.0, 1250.0, 0.0)
    clock.t0 = clock.t0 - 100.0  # anchor far enough back: ttfs > buckets
    clock.first_step_done()
    first = clock.time_to_first_step_s
    clock.first_step_done()  # the first call wins
    assert clock.time_to_first_step_s == first
    snap = clock.snapshot()
    attributed = sum(snap[f"{b}_ms"] for b in ("import", "init", "restore",
                                              "compile"))
    assert snap["first_step_ms"] == pytest.approx(
        snap["time_to_first_step_ms"] - attributed)


class _Writer:
    def __init__(self):
        self.batches = []

    def scalars(self, values, step):
        self.batches.append((step, dict(values)))


class _Store:
    def stats(self):
        return {"hits": 2, "builds": 1}


def _fake_step(state, batch):
    return (dataclasses.replace(state, step=state.step + 1),
            {"loss": torch.tensor(batch, dtype=torch.float32)})


def test_loop_charges_compile_and_startup_hook_publishes():
    """The step's `consume_compile_s` (the builds or loads the first call
    paid) lands in the goodput compile bucket before `after_step`, and
    `StartupHook` publishes ``startup/*`` and ``compile_cache/*`` once,
    with that compile time."""
    paid = [0.25]

    def step(state, batch):
        return _fake_step(state, batch)

    step.consume_compile_s = lambda: paid.pop() if paid else 0.0
    writer = _Writer()
    hook = StartupHook(writer, StartupClock(), store=_Store())
    state = TrainState(step=torch.tensor(0, dtype=torch.int32), params={},
                       model_state={}, opt_state={},
                       rng=torch.Generator().manual_seed(0))
    loop = TrainLoop(step, state, iter([1.0] * 3), [hook])
    loop.run()
    assert loop.goodput.compile_s == 0.25
    assert len(writer.batches) == 1
    step_no, values = writer.batches[0]
    assert step_no == 1
    assert values["startup/compile_ms"] == pytest.approx(250.0)
    assert values["compile_cache/hits"] == 2.0
    assert {"startup/time_to_first_step_ms", "startup/first_step_ms",
            "startup/import_ms"} <= set(values)
    assert hook.last["cache_builds"] == 1


# -- the launcher forwards an explicit store to every generation ------------

STUB = textwrap.dedent("""\
    import os, sys
    args = dict(a.split("=", 1) for a in sys.argv[1:]
                if a.startswith("--") and "=" in a)
    gen = os.environ.get("DIST_MNIST_TPU_GENERATION", "0")
    with open(args["--stub_log"], "a") as f:
        f.write(f"gen={gen} cache={args.get('--compile_cache_dir', '-')}\\n")
    sys.exit(3 if gen == "0" and args["--process_id"] == "1" else 0)
""")


@pytest.mark.parametrize("cache", ["/x/cache", None], ids=["explicit",
                                                           "none"])
def test_launcher_forwards_the_store_to_every_generation(tmp_path, cache):
    """A supervised launch whose rank 1 fails in generation 0: both
    generations' children get an explicit `--compile_cache_dir`; without
    one, nothing is injected."""
    stub = tmp_path / "stub.py"
    stub.write_text(STUB)
    log = tmp_path / "stub.log"
    with contextlib.redirect_stdout(io.StringIO()):
        rc = launch_mod.launch(2, [f"--stub_log={log}"], platform="cpu",
                               child_command=[sys.executable, str(stub)],
                               max_restarts=1, restart_backoff_s=0.05,
                               journal=str(tmp_path / "j.jsonl"),
                               compile_cache_dir=cache)
    assert rc == 0
    lines = sorted(log.read_text().split("\n")[:-1])
    assert lines == sorted(f"gen={g} cache={cache or '-'}"
                           for g in (0, 0, 1, 1))


# -- the journal's outcomes against the reference's -------------------------

def test_compile_cache_events_match_the_reference(tmp_path, data_dir, mesh8):
    """A cold then a warm run through each package's `run_config` with a
    store: the cold journal's `compile_cache` outcomes are {miss, save},
    the warm one's {hit}, in both (the reference's store holds its step
    programs; the port's the native loader, built by g++: build 3)."""
    steps = 4
    outcomes = {}
    for pkg in ("reference", "port"):
        for run in ("cold", "warm"):
            journal = tmp_path / f"{pkg}_{run}.jsonl"
            cache = str(tmp_path / f"{pkg}_cache")
            if pkg == "reference":
                jrun_config(jconfigs.get_config("mlp_mnist",
                                                train_steps=steps,
                                                eval_every=0),
                            mesh=mesh8, data_dir=data_dir,
                            compile_cache_dir=cache, journal=str(journal))
            else:
                saved = dict(native_build._loaded)
                native_build._loaded.clear()  # a fresh process's view
                try:
                    cli.run_config(get_config("mlp_mnist", train_steps=steps,
                                              eval_every=0),
                                   device="cpu", data_dir=data_dir,
                                   input_pipeline="native",
                                   compile_cache_dir=cache,
                                   journal=str(journal))
                finally:
                    native_build._loaded.clear()
                    native_build._loaded.update(saved)
            outcomes[pkg, run] = {r["outcome"] for r in events.read_journal(
                journal) if r["event"] == "compile_cache"}
    assert outcomes["port", "cold"] == outcomes["reference", "cold"] == {
        "miss", "save"}
    assert outcomes["port", "warm"] == outcomes["reference", "warm"] == {
        "hit"}


# -- the attribution benches on the CPU ---------------------------------------

def test_bench_input_trajectory_gate(data_dir):
    rec = bench.main(["--input", "--device=cpu", "--steps=6",
                      f"--data_dir={data_dir}"])
    ex = rec["extra"]
    assert rec["metric"] == "input_stall_ms_per_step" and rec["value"] >= 0
    assert ex["trajectory_identical"] and ex["loss_sync"] == ex[
        "loss_prefetched"]
    assert ex["global_batch"] == 1024 and ex["depth"] == 2
    assert {"sync_stall_ms_per_step", "prefetched_stall_ms_per_step",
            "stall_reduction_ms_per_step", "sync_steps_per_sec",
            "prefetched_steps_per_sec", "mean_ring_occupancy",
            "h2d_mbytes_per_step"} <= set(ex)


def test_bench_memory_and_overlap_on_one_rank(data_dir):
    """One rank: fsdp holds what dp holds (nothing splits), and the
    overlap bench reports the reference's honest zero."""
    rec = bench.main(["--memory", "--device=cpu", f"--data_dir={data_dir}"])
    ex = rec["extra"]
    assert rec["metric"] == "fsdp_per_device_state_bytes"
    assert ex["config"] == "lenet5_mnist" and ex["chips"] == 1
    assert ex["reduction_x"] == 1.0 and ex["dp"] == ex["fsdp"]
    assert "step_peak" not in ex["dp"]  # the card only
    rec = bench.main(["--overlap", "--device=cpu", f"--data_dir={data_dir}"])
    assert rec["metric"] == "comm_exposed_ms_per_step"
    assert rec["value"] == 0.0 and rec["extra"]["single_chip"]


def test_bench_coldstart_schema_on_the_cpu(data_dir):
    """Two child processes share a fresh pair directory (removed after):
    the record's schema, the trajectory gate, and on the CPU ``builds:
    0`` with the store gates reported as not applicable."""
    before = set(Path(tempfile.gettempdir()).glob(
        f"{bench.COLDSTART_PREFIX}*"))
    rec = bench.main(["--coldstart", "--device=cpu", "--coldstart-steps=2",
                      f"--data_dir={data_dir}"])
    ex = rec["extra"]
    assert rec["metric"] == "time_to_first_step_ms"
    assert rec["value"] == ex["warm_ms"] > 0 and ex["cold_ms"] > 0
    assert ex["builds"] == 0 and ex["trajectory_identical"]
    assert ex["hit_gate"] == ex["warm_beats_cold_gate"] == \
        bench.NOT_APPLICABLE
    for side in ("cold_startup", "warm_startup"):
        assert {"import_ms", "init_ms", "compile_ms", "first_step_ms",
                "time_to_first_step_ms"} <= set(ex[side])
    assert {"restart_compile_saved_ms", "ttfs_saved_ms"} <= set(ex)
    assert set(Path(tempfile.gettempdir()).glob(
        f"{bench.COLDSTART_PREFIX}*")) == before
    assert np.isfinite(ex["ttfs_saved_ms"])
