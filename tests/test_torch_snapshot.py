"""The port's write-behind snapshotter and peer ring
(`checkpoint/snapshot.py`, `checkpoint/peer.py`) on the CPU, as the
reference's tests/test_snapshot.py drives its own: the fork, the bounded
window (block attributes the stall, drop_oldest never abandons the write
in flight, a writer error surfaces in `wait`), the commit events, the
preemption drain through the wrapper, the ring's layout and restores
(newest covered step, staleness, temp files, a dead peer, bf16), the
snapshotter's peer-first restore, and across two gloo ranks: a DP and an
FSDP state saved at 2 ranks through the snapshotter and its ring, restored
at 2 ranks from the ring and the store, and at 1 rank (host 1 lost) from
the ring equal to the store's restore bit for bit. `ring_peer` and the
alive-host list are held against the JAX package's. Ends with
``bench --ckpt``'s JSON line and gates.
"""

from __future__ import annotations

import dataclasses
import json
import tempfile
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dist_mnist_tpu.cluster import membership as jmembership
from dist_mnist_tpu_torch import bench, optim
from dist_mnist_tpu_torch.checkpoint import (
    AsyncSnapshotter,
    CheckpointManager,
    PeerReplicator,
    fork_state,
    restore_from_peers,
)
from dist_mnist_tpu_torch.checkpoint import peer as peer_mod
from dist_mnist_tpu_torch.cluster.membership import ENV_ALIVE_HOSTS, ring_peer
from dist_mnist_tpu_torch.cluster.mesh import MeshSpec, make_mesh
from dist_mnist_tpu_torch.data import datasets
from dist_mnist_tpu_torch.faults.goodput import GoodputClock
from dist_mnist_tpu_torch.models.mlp import MLP
from dist_mnist_tpu_torch.obs import events as events_mod
from dist_mnist_tpu_torch.train import TrainState, create_train_state
from dist_mnist_tpu_torch.utils.tree import flatten_with_path

import torch_ranks
import torch_resilience_cases as cases


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
def _no_resilience_leaks():
    """No snapshot writer, grow timer or launcher child outlives a test,
    no peer temp file stays pending, no supervisor temp dir is left."""
    root = Path(tempfile.gettempdir())
    before = set(root.glob("dist_mnist_torch_supervisor_*"))
    yield
    left = cases.wait_unleaked(root, before)
    assert left == [], f"leaked: {left}"


@pytest.fixture()
def state():
    return create_train_state(MLP(hidden_units=16), optim.adam(0.01), 0,
                              np.zeros((1, 28, 28, 1), np.uint8), "cpu")


def _at_step(state, step):
    return dataclasses.replace(state, step=torch.tensor(step,
                                                        dtype=torch.int32))


def _leaf_bytes(state) -> list[bytes]:
    out = []
    for part in ("params", "model_state", "opt_state"):
        out += [x.detach().contiguous().reshape(-1).view(torch.uint8)
                .numpy().tobytes()
                for _, x in flatten_with_path(getattr(state, part))]
    return out + [state.rng.get_state().numpy().tobytes()]


@pytest.fixture()
def journal(tmp_path):
    path = tmp_path / "journal.jsonl"
    prev = events_mod.set_journal(events_mod.RunJournal(path))
    yield path
    events_mod.set_journal(prev).close()


# -- the fork -------------------------------------------------------------

def test_fork_state_is_a_copy_in_fresh_buffers(state):
    fork = fork_state(state)
    assert _leaf_bytes(fork) == _leaf_bytes(state)
    assert fork.params["hid"]["w"] is not state.params["hid"]["w"]
    assert (fork.params["hid"]["w"].data_ptr()
            != state.params["hid"]["w"].data_ptr())
    # an in-place update of the original leaves the fork as it was
    want = fork.params["hid"]["w"].clone()
    state.params["hid"]["w"].add_(1.0)
    state.rng.manual_seed(123)
    assert torch.equal(fork.params["hid"]["w"], want)
    assert not torch.equal(fork.rng.get_state(), state.rng.get_state())
    assert type(fork.opt_state) is type(state.opt_state)


# -- the snapshotter over the real store ----------------------------------

def test_async_snapshotter_roundtrip_and_commit_events(tmp_path, state,
                                                       journal):
    snap = AsyncSnapshotter(CheckpointManager(tmp_path / "ckpt",
                                              async_save=False))
    assert snap.save(state)
    assert not snap.save(state)  # deduped by step at the fork layer
    snap.wait()
    assert snap.latest_step() == 0
    snap.close()
    mgr = CheckpointManager(tmp_path / "ckpt", async_save=False)
    restored = mgr.restore(_at_step(state, 9))
    mgr.close()
    assert _leaf_bytes(restored) == _leaf_bytes(state)
    records = events_mod.read_journal(journal)
    names = [r["event"] for r in records]
    assert "snapshot_fork" in names
    commits = [r for r in records if r["event"] == "checkpoint_commit"]
    assert len(commits) == 1 and commits[0]["step"] == 0
    assert commits[0]["dur_ms"] >= 0  # back-dated to the fork


def _SlowState(step):
    """An empty state at `step`, for the writer-stub tests."""
    return TrainState(step=torch.tensor(step, dtype=torch.int32), params={},
                      model_state={}, opt_state={}, rng=torch.Generator())


class _SlowWriter:
    """A manager stub whose collective-free write blocks `delay` s."""

    def __init__(self, delay=0.3, fail=False):
        self.delay, self.fail = delay, fail
        self.saved: list = []
        self.started = threading.Event()
        self.closed = False

    def is_fresh(self, step):
        return step not in self.saved

    def write_full(self, step, state, *, dispatch_ts=None):
        self.started.set()
        if self.fail:
            raise OSError("disk on fire")
        time.sleep(self.delay)
        self.saved.append(step)

    def wait(self):
        pass

    def close(self):
        self.closed = True

    def latest_step(self, *, refresh=False):
        return self.saved[-1] if self.saved else None


def test_write_behind_window_blocks_and_attributes_stall():
    writer = _SlowWriter(delay=0.3)
    snap = AsyncSnapshotter(writer, window=1, policy="block")
    t0 = time.monotonic()
    snap.save(_SlowState(1))
    assert writer.started.wait(2.0)
    snap.save(_SlowState(2))  # the window is full: this save blocks
    assert time.monotonic() - t0 >= 0.2
    assert snap.save_stall_s > 0.0
    snap.wait()
    assert writer.saved == [1, 2] and snap.dropped == 0
    stall = snap.consume_save_stall_s()
    assert stall > 0.0 and snap.consume_save_stall_s() == 0.0
    snap.close()
    assert writer.closed


def test_write_behind_drop_oldest_never_abandons_inflight():
    writer = _SlowWriter(delay=0.4)
    snap = AsyncSnapshotter(writer, window=1, policy="drop_oldest")
    snap.save(_SlowState(1))
    assert writer.started.wait(2.0)
    t0 = time.monotonic()
    snap.save(_SlowState(2))  # admitted as an overshoot beside the write
    snap.save(_SlowState(3))  # drops the queued 2, never the in-flight 1
    assert time.monotonic() - t0 < 0.3
    snap.wait()
    assert writer.saved == [1, 3] and snap.dropped == 1
    assert snap.save_stall_s == 0.0
    snap.close()


def test_writer_error_surfaces_in_wait():
    writer = _SlowWriter(fail=True)
    snap = AsyncSnapshotter(writer, window=4)
    snap.save(_SlowState(1))
    with pytest.raises(RuntimeError, match="snapshot writer failed"):
        snap.wait()
    snap.close()  # close after a writer error must not hang
    assert writer.closed


def test_unknown_policy_is_refused():
    with pytest.raises(ValueError, match="policy"):
        AsyncSnapshotter(_SlowWriter(), policy="yolo")


def test_drain_on_preemption_durable_before_exit(tmp_path, state):
    """The preemption handshake through the snapshotter: the loop saves
    at the boundary step and the drain makes it durable AND committed
    before the loop returns."""
    from dist_mnist_tpu_torch import hooks as hooks_lib
    from dist_mnist_tpu_torch.data.pipeline import ShardedBatcher
    from dist_mnist_tpu_torch.faults.preemption import PreemptionNotice
    from dist_mnist_tpu_torch.train import make_train_step
    from dist_mnist_tpu_torch.train.loop import TrainLoop

    ds = datasets.load_dataset("mnist", "/nonexistent", seed=0,
                               synthetic_sizes=(512, 64),
                               cache_synthetic=False)
    notice = PreemptionNotice()

    class NotifyAt:
        def begin(self, loop):
            pass

        def before_step(self, step):
            pass

        def after_step(self, step, state, outputs):
            if step == 4:
                notice.notify("test preemption")

        def end(self, state):
            pass

    manager = AsyncSnapshotter(CheckpointManager(tmp_path, async_save=False))
    loop = TrainLoop(make_train_step(MLP(hidden_units=16), optim.adam(1e-3)),
                     state, ShardedBatcher(ds, 64, "cpu", seed=0),
                     [hooks_lib.StopAtStepHook(last_step=12), NotifyAt(),
                      hooks_lib.CheckpointHook(manager, every_steps=3)],
                     checkpoint_manager=manager, preemption=notice)
    loop.run()
    manager.close()
    assert loop.preempted_at == 4
    mgr = CheckpointManager(tmp_path, async_save=False)
    assert mgr.latest_step() == 4
    assert (tmp_path / "commits" / "4.committed").exists()
    mgr.close()


def test_checkpoint_hook_begin_skips_existing_restore_point():
    from dist_mnist_tpu_torch.hooks.builtin import CheckpointHook

    class _Mgr:
        def __init__(self, latest):
            self._latest = latest
            self.saves = []

        def latest_step(self):
            return self._latest

        def save(self, state):
            self.saves.append(state)
            return True

    loop = SimpleNamespace(initial_step=5, state="STATE")
    for latest, want in ((5, []), (None, ["STATE"]), (3, ["STATE"])):
        mgr = _Mgr(latest)
        CheckpointHook(mgr, every_steps=3).begin(loop)
        assert mgr.saves == want


def test_goodput_save_bucket():
    g = GoodputClock()
    g.start()
    g.add_save(0.25)
    g.add_save(0.5)
    g.close()
    assert g.snapshot()["save_s"] == pytest.approx(0.75)


# -- the peer ring --------------------------------------------------------

@pytest.mark.parametrize("host,hosts", [(0, [0, 1, 2]), (2, [0, 1, 2]),
                                        (1, [2, 0, 1]), (0, [0]), (5, [0, 1]),
                                        (3, [0, 3, 7])])
def test_ring_peer_equals_the_reference(host, hosts):
    assert ring_peer(host, hosts) == jmembership.ring_peer(host, hosts)


def test_alive_hosts_from_env(monkeypatch):
    monkeypatch.delenv(ENV_ALIVE_HOSTS, raising=False)
    assert peer_mod.alive_hosts_from_env(default=[0, 1]) == [0, 1]
    monkeypatch.setenv(ENV_ALIVE_HOSTS, "2,0")
    assert peer_mod.alive_hosts_from_env() == [0, 2]
    monkeypatch.setenv(ENV_ALIVE_HOSTS, "x")
    assert peer_mod.alive_hosts_from_env(default=[3]) == [3]
    assert ENV_ALIVE_HOSTS == jmembership.ENV_ALIVE_HOSTS


def _fleet_write(root, state, hosts=(0, 1, 2)):
    """Every host of a fake fleet pushes the (replicated) state to its
    own dir and its ring peer's."""
    for h in hosts:
        PeerReplicator(root, h, hosts).write(state.step_int, state)


def test_peer_layout_and_newest_covered_step_wins(tmp_path, state):
    old, new = _at_step(state, 3), _at_step(fork_state(state), 9)
    new.params["hid"]["w"].add_(1.0)
    _fleet_write(tmp_path, old)
    _fleet_write(tmp_path, new)
    names = sorted(str(p.relative_to(tmp_path))
                   for p in tmp_path.rglob("*.peer"))
    assert names == [f"h{h}/s{s}/step_{n}.peer" for h, s in
                     ((0, 0), (0, 2), (1, 0), (1, 1), (2, 1), (2, 2))
                     for n in (3, 9)]
    got = restore_from_peers(tmp_path, _at_step(state, 0),
                             alive={0, 1, 2})
    restored, step, _ = got
    assert step == 9 and _leaf_bytes(restored) == _leaf_bytes(new)


def test_peer_restore_min_step_tmp_files_and_corruption(tmp_path, state):
    src = _at_step(state, 7)
    _fleet_write(tmp_path, src, hosts=(0, 1))
    target = _at_step(fork_state(state), 0)
    # staler than the store frontier: not worth assembling
    assert restore_from_peers(tmp_path, target, alive={0, 1},
                              min_step=8) is None
    # a kill mid-replication leaves a temp file no restore considers
    (tmp_path / "h0" / "s0" / "step_99.peer.tmp-12345").write_bytes(b"xx")
    got = restore_from_peers(tmp_path, target, alive={0, 1})
    assert got is not None and got[1] == 7
    # a flipped byte fails the crc32: the file is unreadable
    for f in tmp_path.rglob("step_7.peer"):
        raw = bytearray(f.read_bytes())
        raw[-3] ^= 0xFF
        f.write_bytes(bytes(raw))
    assert restore_from_peers(tmp_path, target, alive={0, 1}) is None


def test_peer_restore_none_when_owner_and_peer_are_dead(tmp_path):
    """FSDP-like slices on a fake 3-host fleet: host 1's half lives on h1
    and its ring peer h2; with both dead nothing covers it."""
    full = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    base = create_train_state(MLP(hidden_units=16), optim.sgd(0.1), 0,
                              np.zeros((1, 28, 28, 1), np.uint8), "cpu")
    hosts = [0, 1, 2]
    for h in hosts:
        piece = dataclasses.replace(base, params={"x": full[2 * h:2 * h + 2]},
                                    opt_state=(), model_state={})
        # write hand-made spans: host 0 rows 0..2, host 1 rows 2..4
        rep = PeerReplicator(tmp_path, h, hosts)
        monkey = rep._serialize

        def serialize(step, st, placement, h=h, monkey=monkey):
            data = monkey(step, st, placement)
            n = int.from_bytes(data[:8], "little")
            header = json.loads(data[8:8 + n])
            span = [[0, 2], [0, 3]] if h == 0 else [[2, 4], [0, 3]]
            header["leaves"][0]["shape"] = [4, 3]
            header["leaves"][0]["pieces"][0]["start"] = [a for a, _ in span]
            header["leaves"][0]["pieces"][0]["stop"] = [b for _, b in span]
            raw = json.dumps(header).encode()
            return len(raw).to_bytes(8, "little") + raw + data[8 + n:]

        if h < 2:
            rep._serialize = serialize
            rep.write(0, piece)
    target = dataclasses.replace(base, params={"x": torch.zeros(4, 3)},
                                 opt_state=(), model_state={})
    got = restore_from_peers(tmp_path, target, alive={0, 1, 2})
    assert got is not None and torch.equal(got[0].params["x"], full)
    assert got[2] == {0: "h0", 1: "h1"}
    assert restore_from_peers(tmp_path, target, alive={0, 2})[2] == {
        0: "h0", 1: "h2"}  # host 1 dead: its half off its ring peer
    assert restore_from_peers(tmp_path, target, alive={0}) is None


def test_peer_files_round_trip_bf16_and_every_dtype(tmp_path, state):
    mixed = dataclasses.replace(
        _at_step(state, 5),
        params={"w16": torch.randn(3, 5, generator=torch.Generator()
                                   .manual_seed(1)).to(torch.bfloat16),
                "w32": torch.randn(7), "i": torch.arange(4),
                "h": torch.ones(2, dtype=torch.float16)},
        opt_state=(), model_state={"n": torch.tensor(3, dtype=torch.int32)})
    PeerReplicator(tmp_path, 0, [0]).write(5, mixed)
    target = dataclasses.replace(
        mixed, params={k: torch.zeros_like(v) for k, v in
                       mixed.params.items()},
        model_state={"n": torch.tensor(0, dtype=torch.int32)},
        step=torch.tensor(0, dtype=torch.int32))
    restored, step, _ = restore_from_peers(tmp_path, target, alive={0})
    assert step == 5 and restored.step_int == 5
    for k, v in mixed.params.items():
        assert restored.params[k].dtype == v.dtype
        assert torch.equal(restored.params[k], v)
    assert _leaf_bytes(restored) == _leaf_bytes(mixed)


def test_snapshotter_peer_first_restore_falls_back_to_store(tmp_path, state,
                                                            journal):
    inner = CheckpointManager(tmp_path / "ckpt", async_save=False)
    snap = AsyncSnapshotter(inner,
                            peer=PeerReplicator(tmp_path / "peer", 0, [0]))
    snap.save(state)
    snap.wait()
    restored = snap.restore(_at_step(fork_state(state), 9))
    assert _leaf_bytes(restored) == _leaf_bytes(state)
    names = [r["event"] for r in events_mod.read_journal(journal)]
    assert "peer_restore" in names
    assert "checkpoint_restore" not in names  # the store was never read
    import shutil

    shutil.rmtree(tmp_path / "peer")
    restored2 = snap.restore(_at_step(fork_state(state), 9))
    assert _leaf_bytes(restored2) == _leaf_bytes(state)
    names = [r["event"] for r in events_mod.read_journal(journal)]
    assert "checkpoint_restore" in names
    snap.close()


# -- two gloo ranks: DP and FSDP through the ring -------------------------

@pytest.fixture(scope="module")
def two_rank_saves(tmp_path_factory):
    """One 2-rank group per placement: save at step 7 through the
    snapshotter and its ring, restore at 2 ranks from each."""
    out = {}
    for rules in ("dp", "fsdp"):
        root = tmp_path_factory.mktemp(f"ring_{rules}")
        out[rules] = (root, torch_ranks.run_ranks(
            cases.snapshot_and_restore, 2, root / "ranks", str(root), rules,
            timeout=120.0))
    return out


def _same(a: dict, b: dict) -> bool:
    fa = flatten_with_path({k: a[k] for k in ("params", "opt_state", "rng")})
    fb = flatten_with_path({k: b[k] for k in ("params", "opt_state", "rng")})
    return [p for p, _ in fa] == [p for p, _ in fb] and all(
        np.asarray(x).tobytes() == np.asarray(y).tobytes()
        for (_, x), (_, y) in zip(fa, fb)) and a["step"] == b["step"]


@pytest.mark.parametrize("rules", ["dp", "fsdp"])
def test_two_rank_state_restores_at_two_ranks_from_ring_and_store(
        two_rank_saves, rules):
    root, ranks = two_rank_saves[rules]
    assert [r["rank"] for r in ranks] == [0, 1]
    assert all(r["sharded"] == (rules == "fsdp") for r in ranks)
    for r in ranks:
        assert "peer_restore" in r["events"]
        assert "checkpoint_restore" not in r["events"]
        assert _same(r["ring"], r["saved"]) and _same(r["store"], r["saved"])
        assert r["ring_placed_like_target"]
    assert sorted(str(p.relative_to(root / "peer"))
                  for p in (root / "peer").rglob("*.peer")) == [
        "h0/s0/step_7.peer", "h0/s1/step_7.peer",
        "h1/s0/step_7.peer", "h1/s1/step_7.peer"]


@pytest.mark.parametrize("rules", ["dp", "fsdp"])
def test_ring_restore_at_one_rank_equals_the_store_bit_for_bit(
        two_rank_saves, rules):
    """The shrink 2 -> 1: host 1 lost, its shards off its ring peer h0;
    the ring's restore equals the store's, bit for bit, and both equal
    what was saved."""
    root, ranks = two_rank_saves[rules]
    mesh = make_mesh(MeshSpec(data=-1), device="cpu")
    target = cases.mlp_state(rules, mesh, seed=9, step=0, trained=False)
    got = restore_from_peers(root / "peer", target, alive={0})
    assert got is not None
    ring, step, sources = got
    assert step == 7
    if rules == "fsdp":
        assert sources == {0: "h0", 1: "h0"}
    store = CheckpointManager(root / "store", async_save=False)
    from_store = store.restore(target)
    store.close()
    assert _leaf_bytes(ring) == _leaf_bytes(from_store)
    assert _same(cases.full_numpy(ring), ranks[0]["saved"])
    # host 0's own disk alone, host 1's files gone: no coverage under FSDP
    if rules == "fsdp":
        assert restore_from_peers(root / "peer", target, alive={1}) is not None
        import shutil

        lost = root / "peer_lost"
        shutil.copytree(root / "peer", lost)
        shutil.rmtree(lost / "h0" / "s1")
        assert restore_from_peers(lost, target, alive={0}) is None


# -- the bench ------------------------------------------------------------

def test_bench_ckpt_prints_its_line_and_holds_its_gates(tmp_path, capsys):
    data = tmp_path / "mnist-data"
    datasets._write_synth_cache(data, "mnist",
                                datasets._synth("mnist", 2048, 256, 0))
    record = bench.main(["--ckpt", "--device=cpu", f"--data_dir={data}"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == json.loads(json.dumps(record))
    assert record["metric"] == "save_stall_ms_per_step"
    extra = record["extra"]
    assert extra["trajectory_identical"] is True
    assert extra["async_save_ms_per_step"] < extra["sync_save_ms_per_step"]
    assert extra["saves_per_run"] == 7
    el = extra["elastic"]
    assert el["peer"]["final_step"] == el["store_baseline"]["final_step"] \
        == 60
    assert el["peer_restore_ms"] < el["store_restore_ms"]
    # the reference's --ckpt record: no observability field of its own
    assert "observability" not in extra and el["peer_restore_sources"]
