"""The port's CheckpointManager (`dist_mnist_tpu_torch/checkpoint/
manager.py`): the round trip bit for bit (the generator's state too),
restore_or_init, dedupe, retention, commit markers and legacy adoption,
the fallback ladder with each kind of read corruption, structure healing,
the weights-only restore and the async write; then a checkpoint the JAX
package wrote, carried into the port by `convert.train_state_from_jax`,
saved and restored by the port and served by its loader."""

from __future__ import annotations

import dataclasses
import errno
import json
import pickle
import shutil
import tempfile
import threading
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_mnist_tpu import optim as joptim
from dist_mnist_tpu.checkpoint import CheckpointManager as JaxManager
from dist_mnist_tpu.models import get_model as jget_model
from dist_mnist_tpu.train import create_train_state as jcreate_train_state
from dist_mnist_tpu_torch import optim
from dist_mnist_tpu_torch.checkpoint import CheckpointManager
from dist_mnist_tpu_torch.checkpoint.manager import (
    StructureMismatch,
    _is_read_corruption,
)
from dist_mnist_tpu_torch.convert import train_state_from_jax
from dist_mnist_tpu_torch.models.registry import get_model
from dist_mnist_tpu_torch.obs import events
from dist_mnist_tpu_torch.train import create_train_state
from dist_mnist_tpu_torch.utils.tree import flatten_with_path, leaves

MNIST = np.zeros((1, 28, 28, 1), np.uint8)
CIFAR = np.zeros((1, 32, 32, 3), np.uint8)


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


def _mlp_state(seed=0, opt=None):
    opt = opt or optim.chain(optim.clip_by_global_norm(1.0),
                             optim.adamw(0.01, weight_decay=0.1))
    state = create_train_state(get_model("mlp", hidden_units=16), opt, seed,
                               MNIST, "cpu")
    # advance the generator and give the slots nonzero values
    torch.rand(17, generator=state.rng)
    state.opt_state[1]["m"]["hid"]["w"].normal_(
        generator=torch.Generator().manual_seed(seed))
    state.opt_state[1]["count"].fill_(5)
    return state


@pytest.fixture()
def state():
    return _mlp_state()


def _at(state, step):
    return dataclasses.replace(state, step=torch.tensor(step,
                                                        dtype=torch.int32))


def _same_bits(a, b) -> bool:
    fa, fb = flatten_with_path(a), flatten_with_path(b)
    return [p for p, _ in fa] == [p for p, _ in fb] and all(
        x.dtype == y.dtype and torch.equal(x, y)
        for (_, x), (_, y) in zip(fa, fb))


def _save_steps(mgr, state, steps):
    for s in steps:
        mgr.save(_at(state, s))
    mgr.wait()


def test_save_restore_roundtrip_bitwise_with_the_generator(tmp_path, state):
    mgr = CheckpointManager(tmp_path, async_save=False)
    assert mgr.latest_step() is None
    assert mgr.save(_at(state, 7))
    assert mgr.latest_step() == 7
    target = _mlp_state(seed=3)
    restored = mgr.restore(target)
    assert restored.step_int == 7 and restored.step.dtype == torch.int32
    assert _same_bits(restored.params, state.params)
    assert _same_bits(restored.opt_state, state.opt_state)
    assert isinstance(restored.opt_state, tuple)  # the chain, rebuilt
    assert torch.equal(restored.rng.get_state(), state.rng.get_state())
    # the draws continue where the saved generator left off
    assert torch.equal(torch.rand(5, generator=restored.rng),
                       torch.rand(5, generator=state.rng))
    mgr.close()


def test_state_file_loads_with_weights_only_and_meta_lists_leaves(
        tmp_path, state):
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(state)
    payload = torch.load(tmp_path / "0" / "state.pt", weights_only=True)
    assert set(payload) == {"step", "params", "model_state", "opt_state",
                            "rng"}
    assert payload["rng"]["device"] == "cpu"
    meta = json.loads((tmp_path / "0" / "meta.json").read_text())
    assert meta["tree"]["params"]["hid"]["w"] == {
        "leaf": True, "shape": [784, 16], "dtype": "float32"}
    assert meta["tree"]["opt_state"][1]["count"]["dtype"] == "int32"


def test_restore_or_init(tmp_path, state):
    mgr = CheckpointManager(tmp_path, async_save=False)
    out, restored = mgr.restore_or_init(state)
    assert not restored and out is state
    mgr.save(state)
    out, restored = mgr.restore_or_init(_mlp_state(seed=1))
    assert restored and _same_bits(out.params, state.params)


def test_dedupe_same_step(tmp_path, state):
    mgr = CheckpointManager(tmp_path, async_save=False)
    assert mgr.save(state)
    assert not mgr.save(state)
    # a fresh manager dedupes against what is on disk
    assert not CheckpointManager(tmp_path, async_save=False).save(state)


def test_kill_resume_cycle(tmp_path, state):
    mgr1 = CheckpointManager(tmp_path, async_save=False)
    mgr1.save(_at(state, 123))
    mgr1.close()
    mgr2 = CheckpointManager(tmp_path, async_save=False)
    resumed, was_restored = mgr2.restore_or_init(_mlp_state(seed=9))
    assert was_restored and resumed.step_int == 123
    assert _same_bits(resumed.params, state.params)


def test_max_to_keep(tmp_path, state):
    mgr = CheckpointManager(tmp_path, max_to_keep=2, async_save=False)
    _save_steps(mgr, state, [1, 2, 3, 4])
    assert mgr.all_steps() == [3, 4]
    assert sorted(p.name for p in (tmp_path / "commits").iterdir()) == [
        "3.committed", "4.committed"]
    assert mgr.latest_step() == 4


def test_async_save_is_durable_after_wait_and_copied_before_return(
        tmp_path, state):
    mgr = CheckpointManager(tmp_path)  # async by default
    mgr.save(_at(state, 4))
    want = state.params["hid"]["w"].clone()
    state.params["hid"]["w"].add_(1.0)  # an in-place update after save()
    mgr.wait()
    assert (tmp_path / "commits" / "4.committed").exists()
    assert not any(t.name.startswith("SnapshotWriter")
                   for t in threading.enumerate())
    restored = CheckpointManager(tmp_path).restore(_mlp_state(seed=2))
    assert torch.equal(restored.params["hid"]["w"], want)


def test_async_marker_lands_on_flush_once_written(tmp_path, state):
    mgr = CheckpointManager(tmp_path)
    mgr.save(_at(state, 3))
    assert mgr.latest_step() == 3  # an in-process async save counts
    mgr._thread.join()
    assert not (tmp_path / "commits" / "3.committed").exists()
    mgr.flush_commits()
    assert (tmp_path / "commits" / "3.committed").exists()
    mgr.close()


def test_async_writer_error_surfaces_at_wait(tmp_path, state, monkeypatch):
    mgr = CheckpointManager(tmp_path)

    def broken(step, payload, meta):
        raise OSError(errno.ENOSPC, "no space left")

    monkeypatch.setattr(mgr, "_write_step", broken)
    mgr.save(state)
    with pytest.raises(OSError, match="no space"):
        mgr.wait()


def test_legacy_directory_is_adopted(tmp_path, state):
    mgr = CheckpointManager(tmp_path, async_save=False)
    _save_steps(mgr, state, [1, 2])
    shutil.rmtree(tmp_path / "commits")  # a directory from before markers
    mgr2 = CheckpointManager(tmp_path, async_save=False)
    assert mgr2.latest_step() == 2
    assert (tmp_path / "commits" / "1.committed").exists()


def test_step_without_marker_is_quarantined_without_a_fallback(
        tmp_path, state):
    """A writer that died between the rename and the marker: the step is
    quarantined up front, and even with max_restore_fallbacks=0 the
    committed step before it restores."""
    mgr = CheckpointManager(tmp_path, async_save=False,
                            max_restore_fallbacks=0)
    _save_steps(mgr, state, [1, 2])
    (tmp_path / "commits" / "2.committed").unlink()
    assert mgr.latest_step() == 1
    restored = mgr.restore(state)
    assert restored.step_int == 1
    assert (tmp_path / "quarantine" / "step_2").exists()
    assert not (tmp_path / "2").exists()


def _truncate_to(n):
    def f(path):
        path.write_bytes(path.read_bytes()[:n])
    return f


def _entry_signature(name, sig):
    """Overwrite the local-header signature of zip entry `name`."""
    def f(path):
        with zipfile.ZipFile(path) as z:
            off = next(i.header_offset for i in z.infolist()
                       if i.filename.endswith(name))
        data = bytearray(path.read_bytes())
        data[off:off + len(sig)] = sig
        path.write_bytes(bytes(data))
    return f


def _flip_tensor_bytes(path):
    with zipfile.ZipFile(path) as z:
        info = max(z.infolist(), key=lambda i: i.file_size)
    data = bytearray(path.read_bytes())
    at = info.header_offset + 30 + len(info.filename) + 128
    data[at:at + 8] = bytes(b ^ 0xFF for b in data[at:at + 8])
    path.write_bytes(bytes(data))


#: (case, what it does to state.pt (or meta.json), the error it raises)
CORRUPTIONS = [
    ("truncated_short", "state.pt", _truncate_to(100), RuntimeError,
     "failed finding central directory"),
    ("entry_header_mangled", "state.pt", _entry_signature("data/0", b"XXXX"),
     RuntimeError, "invalid header or archive is corrupted"),
    ("empty", "state.pt", _truncate_to(0), EOFError, None),
    ("pickle_header_garbage", "state.pt",
     _entry_signature("data.pkl", b"garbage!"), pickle.UnpicklingError,
     None),
    ("pickle_mangled", "state.pt", _entry_signature("data.pkl", b"XXXX"),
     UnicodeDecodeError, None),
    ("tensor_bytes_flipped", "state.pt", _flip_tensor_bytes, OSError,
     "crc32"),
    ("state_missing", "state.pt", lambda p: p.unlink(), FileNotFoundError,
     None),
    ("meta_garbage", "meta.json", lambda p: p.write_text("{not json"),
     json.JSONDecodeError, None),
]


@pytest.mark.parametrize("case,name,corrupt,exc,match", CORRUPTIONS,
                         ids=[c[0] for c in CORRUPTIONS])
def test_corrupt_latest_falls_back_and_quarantines(
        tmp_path, state, case, name, corrupt, exc, match):
    mgr = CheckpointManager(tmp_path, async_save=False)
    _save_steps(mgr, state, [0, 1])
    corrupt(tmp_path / "1" / name)
    restored = mgr.restore(state)
    assert restored is not None and restored.step_int == 0
    assert (tmp_path / "quarantine" / "step_1").exists()
    assert not (tmp_path / "1").exists()
    # the manager stays usable: save after quarantine, restore the new one
    _save_steps(mgr, state, [2])
    assert mgr.latest_step(refresh=True) == 2
    assert mgr.restore(state).step_int == 2


@pytest.mark.parametrize("case,name,corrupt,exc,match", CORRUPTIONS,
                         ids=[c[0] for c in CORRUPTIONS])
def test_corrupt_only_checkpoint_raises_original_error(
        tmp_path, state, case, name, corrupt, exc, match):
    mgr = CheckpointManager(tmp_path, async_save=False)
    _save_steps(mgr, state, [0])
    corrupt(tmp_path / "0" / name)
    with pytest.raises(exc, match=match) as info:
        mgr.restore(state)
    assert _is_read_corruption(info.value)
    assert (tmp_path / "0").exists()  # nothing to fall back to: kept


def test_each_zip_reader_marker_counts_and_others_do_not():
    for msg in ("PytorchStreamReader failed reading file data/3: x",
                "failed finding central directory",
                "invalid header or archive is corrupted"):
        assert _is_read_corruption(RuntimeError(msg))
    assert not _is_read_corruption(RuntimeError("CUDA out of memory"))
    assert not _is_read_corruption(StructureMismatch("shape"))
    assert not _is_read_corruption(KeyError("params"))
    assert not _is_read_corruption(ValueError("some logic error"))


def test_max_restore_fallbacks_zero_disables_ladder(tmp_path, state):
    mgr = CheckpointManager(tmp_path, async_save=False,
                            max_restore_fallbacks=0)
    _save_steps(mgr, state, [0, 1])
    _truncate_to(100)(tmp_path / "1" / "state.pt")
    with pytest.raises(RuntimeError, match="central directory"):
        mgr.restore(state)
    assert (tmp_path / "1").exists()  # nothing quarantined


def test_structural_mismatch_never_quarantines(tmp_path, state):
    mgr = CheckpointManager(tmp_path, async_save=False)
    _save_steps(mgr, state, [0, 1])
    other = create_train_state(get_model("mlp", hidden_units=8),
                               optim.chain(optim.clip_by_global_norm(1.0),
                                           optim.adamw(0.01,
                                                       weight_decay=0.1)),
                               0, MNIST, "cpu")
    with pytest.raises(StructureMismatch, match="shape"):
        mgr.restore(other)
    assert (tmp_path / "1").exists()
    assert not (tmp_path / "quarantine").exists()


def test_io_error_skips_healing_ladder(tmp_path, state, monkeypatch):
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(state)
    calls = []
    monkeypatch.setattr(mgr, "_restore_with_structure_healing",
                        lambda *a, **k: calls.append(1))
    monkeypatch.setattr(
        mgr, "_restore_into",
        lambda *a, **k: (_ for _ in ()).throw(OSError("disk on fire")))
    with pytest.raises(OSError, match="disk on fire"):
        mgr.restore(state)
    assert not calls


def test_hopeless_target_raises_the_original_structure_error(tmp_path,
                                                             state):
    vit = create_train_state(
        get_model("vit_tiny", depth=2, dim=32, heads=4, patch=8,
                  pool="mean", compute_dtype=torch.float32),
        optim.adam(0.01), 0, CIFAR, "cpu")
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(state)
    with pytest.raises(StructureMismatch, match="structure differs"):
        mgr.restore(vit)


def _vit_state(scan_blocks: bool, seed: int):
    model = get_model("vit_tiny", depth=2, dim=32, heads=4, patch=8,
                      pool="mean", compute_dtype=torch.float32,
                      scan_blocks=scan_blocks)
    return create_train_state(model, optim.adam(0.01), seed, CIFAR, "cpu")


def test_block_layout_flip_on_restore(tmp_path):
    """An unrolled ViT checkpoint restores into a scanned target (params
    AND Adam slots converted), and the reverse."""
    u_state, s_state = _vit_state(False, 0), _vit_state(True, 1)
    mgr = CheckpointManager(tmp_path / "a", async_save=False)
    mgr.save(u_state)
    restored = mgr.restore(s_state)
    assert "blocks" in restored.params and "block0" not in restored.params
    for i in range(2):
        assert torch.equal(restored.params["blocks"]["attn"]["qkv"]["w"][i],
                           u_state.params[f"block{i}"]["attn"]["qkv"]["w"])
    assert "blocks" in restored.opt_state["m"]
    rev_mgr = CheckpointManager(tmp_path / "b", async_save=False)
    rev_mgr.save(s_state)
    rev = rev_mgr.restore(u_state)
    assert "block0" in rev.params
    assert torch.equal(rev.params["block1"]["attn"]["qkv"]["w"],
                       s_state.params["blocks"]["attn"]["qkv"]["w"][1])


def _with_metrics(state, names):
    return dataclasses.replace(state, model_state={
        n: torch.tensor(float(i + 1)) for i, n in enumerate(names)})


def test_older_metric_set_heals_and_refills_from_the_target(tmp_path,
                                                            state):
    """The `_metric` rungs: a checkpoint with an older (partial) metric
    model-state set restores into a target with more, the missing entry
    taking the target's value; with no metrics on disk the strip rung."""
    mgr = CheckpointManager(tmp_path / "partial", async_save=False)
    mgr.save(_with_metrics(state, ["a_metric"]))
    target = _with_metrics(_mlp_state(seed=4), ["a_metric", "b_metric"])
    restored = mgr.restore(target)
    assert float(restored.model_state["a_metric"]) == 1.0  # from disk
    assert float(restored.model_state["b_metric"]) == 2.0  # the target's
    mgr2 = CheckpointManager(tmp_path / "none", async_save=False)
    mgr2.save(state)
    restored = mgr2.restore(target)
    assert sorted(restored.model_state) == ["a_metric", "b_metric"]
    assert _same_bits(restored.params, state.params)


def test_flipped_layout_plus_partial_metrics_heals(tmp_path):
    u_state = _with_metrics(_vit_state(False, 0), ["a_metric"])
    s_state = _with_metrics(_vit_state(True, 0), ["a_metric", "b_metric"])
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(u_state)
    restored = mgr.restore(s_state)
    assert sorted(restored.model_state) == ["a_metric", "b_metric"]
    assert "blocks" in restored.params
    assert torch.equal(restored.params["blocks"]["attn"]["qkv"]["w"][0],
                       u_state.params["block0"]["attn"]["qkv"]["w"])


def test_restore_weights_builds_no_optimizer(tmp_path, state, monkeypatch):
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(_at(state, 11))
    monkeypatch.setattr(optim, "adam", lambda *a, **k: pytest.fail("adam"))
    fresh = get_model("mlp", hidden_units=16).init(
        torch.Generator().manual_seed(5), torch.zeros(1, 28, 28, 1))
    step, params, model_state = mgr.restore_weights(*fresh)
    assert step == 11 and model_state == {}
    assert _same_bits(params, state.params)
    assert CheckpointManager(tmp_path / "empty").restore_weights({}, {}) \
        is None


def test_restore_weights_of_an_uncommitted_step_refuses(tmp_path, state):
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(state)
    with pytest.raises(FileNotFoundError, match="not a committed step"):
        mgr.restore_weights(state.params, {}, step=5)


def test_checkpoint_events_carry_the_references_fields(tmp_path, state):
    journal = events.RunJournal(tmp_path / "j.jsonl")
    prev = events.set_journal(journal)
    try:
        mgr = CheckpointManager(tmp_path / "ck", async_save=False)
        _save_steps(mgr, state, [0, 1])
        _truncate_to(0)(tmp_path / "ck" / "1" / "state.pt")
        mgr.restore(state)
    finally:
        events.set_journal(prev)
        journal.close()
    recs = [(r["event"], r.get("step")) for r in
            events.read_journal(tmp_path / "j.jsonl")]
    assert recs == [("checkpoint_commit", 0), ("checkpoint_save", 0),
                    ("checkpoint_commit", 1), ("checkpoint_save", 1),
                    ("checkpoint_quarantine", 1), ("checkpoint_restore", 0)]
    last = events.read_journal(tmp_path / "j.jsonl")[-1]
    assert last["source"] == "store" and last["dur_ms"] >= 0


# -- a checkpoint the JAX package wrote ---------------------------------------

def test_checkpoint_written_by_the_jax_package_continues_in_the_port(
        tmp_path, mesh1):
    """The JAX manager saves a trained-looking MLP state (AdamW behind a
    clip, nonzero slots, count 9) and reads it back; the port converts it,
    saves and restores it bit for bit, and its loader serves it with
    logits within the f32 serving tolerance of the JAX model's."""
    jmodel = jget_model("mlp", hidden_units=16)
    jopt = joptim.chain(joptim.clip_by_global_norm(1.0),
                        joptim.adamw(0.01, weight_decay=0.1))
    with mesh1:
        jstate = jcreate_train_state(jmodel, jopt, jax.random.PRNGKey(0),
                                     MNIST)
    rng = np.random.default_rng(0)
    jstate = dataclasses.replace(
        jstate, step=jnp.int32(9),
        params=jax.tree.map(lambda p: p + 0.01 * rng.standard_normal(
            p.shape).astype(np.float32), jstate.params),
        opt_state=jax.tree.map(lambda s: s + 1 if s.dtype == jnp.int32
                               else s + 0.001, jstate.opt_state))
    jmgr = JaxManager(tmp_path / "jax", async_save=False)
    jmgr.save(jstate)
    jmgr.wait()
    from_disk = jmgr.restore(jstate)
    jmgr.close()
    host = jax.device_get(from_disk)
    port_state = train_state_from_jax(host, seed=42)
    assert port_state.step_int == 9
    assert int(port_state.opt_state[1]["count"]) == 1
    for (_, got), want in zip(flatten_with_path(port_state.opt_state),
                              jax.tree.leaves(host.opt_state)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    mgr = CheckpointManager(tmp_path / "port", async_save=False)
    mgr.save(port_state)
    target = create_train_state(get_model("mlp", hidden_units=16),
                                optim.chain(optim.clip_by_global_norm(1.0),
                                            optim.adamw(0.01,
                                                        weight_decay=0.1)),
                                42, MNIST, "cpu")
    restored = mgr.restore(target)
    assert _same_bits(restored.params, port_state.params)
    assert _same_bits(restored.opt_state, port_state.opt_state)

    from dist_mnist_tpu_torch.configs import get_config
    from dist_mnist_tpu_torch.serve import InferenceEngine, load_for_serving
    from dist_mnist_tpu_torch.serve.loadgen import make_images

    cfg = get_config("mlp_mnist", model_kwargs={"hidden_units": 16})
    bundle = load_for_serving(cfg, "cpu", checkpoint_dir=tmp_path / "port")
    assert bundle.restored and bundle.step == 9
    engine = InferenceEngine(bundle.model, bundle.params, bundle.model_state,
                             device="cpu", image_shape=bundle.image_shape,
                             max_bucket=8)
    images = make_images((28, 28, 1), seed=3, n=8)
    got = engine.predict(images)
    x = jnp.asarray(images, jnp.float32) / 255.0
    want, _ = jmodel.apply(host.params, host.model_state, x, train=False)
    want = np.asarray(want)
    assert float(np.max(np.abs(got - want))) <= \
        1e-4 * float(np.max(np.abs(want)))
    assert leaves(bundle.params)[0].dtype == torch.float32
