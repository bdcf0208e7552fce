"""The port's host input path: `data/pipeline.ShardedBatcher` (one device)
yields the reference's rows byte for byte, from step 0 and from a
mid-epoch step, and `data/prefetch.DevicePrefetcher` gives the same
stream as the synchronous feed, re-seeks, re-raises and joins its
workers; the loop's recovery replays through it and its runahead bound
holds."""

from __future__ import annotations

import collections
import itertools
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

from dist_mnist_tpu.data.datasets import Dataset as JDataset
from dist_mnist_tpu.data.pipeline import ShardedBatcher as JShardedBatcher
from dist_mnist_tpu.data.pipeline import epoch_batches as jepoch_batches
from dist_mnist_tpu_torch.data.datasets import Dataset
from dist_mnist_tpu_torch.data.pipeline import ShardedBatcher, epoch_batches
from dist_mnist_tpu_torch.data.prefetch import (
    THREAD_NAME_PREFIX,
    DevicePrefetcher,
    PrefetchStats,
)
from dist_mnist_tpu_torch.hooks import InputPipelineHook, StopAtStepHook
from dist_mnist_tpu_torch.train.loop import PreemptionError, TrainLoop
from dist_mnist_tpu_torch.train.state import TrainState

N, BATCH = 1000, 96  # 10 steps an epoch, 40 rows dropped


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


def _arrays():
    rng = np.random.default_rng(3)
    return (rng.integers(0, 256, (N, 28, 28, 1), dtype=np.uint8),
            rng.integers(0, 10, N).astype(np.int32),
            np.zeros((10, 28, 28, 1), np.uint8), np.zeros(10, np.int32))


@pytest.fixture(scope="module")
def data():
    return Dataset("mnist", *_arrays())


def _live_workers():
    return [t for t in threading.enumerate()
            if t.name.startswith(THREAD_NAME_PREFIX) and t.is_alive()]


def _wait_drained(timeout=2.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if not _live_workers():
            return True
        time.sleep(0.01)
    return False


def _take(iterable, n):
    """First n items, closing the iterator (a prefetch worker must not be
    left behind a suspended generator)."""
    it = iter(iterable)
    try:
        return [next(it) for _ in range(n)]
    finally:
        if hasattr(it, "close"):
            it.close()


def test_epoch_batches_equal_the_references():
    for epoch in (0, 1, 5):
        got = list(epoch_batches(N, BATCH, seed=7, epoch=epoch))
        want = list(jepoch_batches(N, BATCH, seed=7, epoch=epoch))
        assert len(got) == 10
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("start_step", [0, 13])
def test_host_batches_equal_the_references_byte_for_byte(mesh1, data,
                                                         start_step):
    """Two epochs (from step 0, and from step 13: mid-way into the second
    epoch, through into the third)."""
    jdata = JDataset("mnist", *_arrays())
    got = _take(ShardedBatcher(data, BATCH, "cpu", seed=5,
                               start_step=start_step).host_batches(), 20)
    want = _take(JShardedBatcher(jdata, BATCH, mesh1, seed=5,
                                 start_step=start_step).host_batches(), 20)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
            assert g[k].tobytes() == w[k].tobytes()


def test_iter_moves_batches_to_the_device_and_at_step_seeks(data):
    b = ShardedBatcher(data, BATCH, "cpu", seed=1)
    first = _take(b, 4)
    assert first[0]["image"].dtype == torch.uint8
    assert first[0]["label"].dtype == torch.int32
    assert first[0]["image"].shape == (BATCH, 28, 28, 1)
    resumed = _take(b.at_step(2), 2)
    for x, y in zip(first[2:], resumed):
        assert torch.equal(x["image"], y["image"])


def test_batcher_refuses_what_the_port_lacks(data):
    with pytest.raises(ValueError, match="exceeds dataset size"):
        _take(ShardedBatcher(data, N + 1, "cpu").host_batches(), 1)
    with pytest.raises(ValueError, match=">= 1"):
        _take(ShardedBatcher(data, 0, "cpu").host_batches(), 1)
    with pytest.raises(NotImplementedError, match="ROADMAP §1 item 12"):
        ShardedBatcher(data, BATCH, ["cuda:0", "cuda:1"])


def test_prefetched_stream_identical_to_sync(data):
    sync = _take(ShardedBatcher(data, BATCH, "cpu", seed=0), 25)
    pre = _take(DevicePrefetcher(ShardedBatcher(data, BATCH, "cpu", seed=0),
                                 depth=3), 25)
    for a, b in zip(sync, pre):
        for k in a:
            assert torch.equal(a[k], b[k])
    assert _wait_drained()


def test_at_step_reseek_matches_inner(data):
    inner = ShardedBatcher(data, BATCH, "cpu", seed=0)
    want = _take(inner.at_step(7), 3)
    got = _take(DevicePrefetcher(inner, depth=2).at_step(7), 3)
    for a, b in zip(want, got):
        assert torch.equal(a["label"], b["label"])


def test_prefetcher_requires_a_host_batcher():
    with pytest.raises(TypeError, match="host_batches"):
        DevicePrefetcher(itertools.repeat({"x": np.zeros(1)}))


def test_depth_must_be_positive(data):
    with pytest.raises(ValueError, match="depth"):
        DevicePrefetcher(ShardedBatcher(data, BATCH, "cpu"), depth=0)


class _FiniteBatcher(ShardedBatcher):
    """The first 5 batches of the stream, then its end."""

    def host_batches(self):
        return itertools.islice(super().host_batches(), 5)


class _CorruptBatcher(ShardedBatcher):
    """One batch, then an error in the host stream."""

    def host_batches(self):
        yield next(super().host_batches())
        raise ValueError("corrupt shard")


def test_worker_drains_on_exhaustion(data):
    got = list(DevicePrefetcher(_FiniteBatcher(data, BATCH, "cpu"), depth=2))
    assert len(got) == 5
    assert _wait_drained()


def test_inner_exception_propagates_and_drains(data):
    with pytest.raises(ValueError, match="corrupt shard"):
        list(DevicePrefetcher(_CorruptBatcher(data, BATCH, "cpu"), depth=2))
    assert _wait_drained()


def test_early_close_drains_worker(data):
    it = iter(DevicePrefetcher(ShardedBatcher(data, BATCH, "cpu"), depth=2))
    next(it)
    assert _live_workers()
    it.close()
    assert _wait_drained()


def test_prefetcher_close_reaps_all_streams(data):
    pf = DevicePrefetcher(ShardedBatcher(data, BATCH, "cpu"), depth=2)
    it = iter(pf)
    next(it)
    pf.close()
    assert _wait_drained()
    it.close()


def test_stats_count_batches_and_bytes(data):
    pf = DevicePrefetcher(ShardedBatcher(data, BATCH, "cpu"), depth=2)
    _take(pf, 6)
    s = pf.stats()
    assert s["batches"] == 6
    # image rows and int32 labels of every batch the worker pushed (up to
    # `depth` + 1 ahead of the 6 taken)
    per_batch = BATCH * 28 * 28 + BATCH * 4
    assert s["h2d_bytes"] % per_batch == 0 and s["h2d_bytes"] >= 6 * per_batch


def test_shared_stats_object_survives_reseek(data):
    stats = PrefetchStats(depth=2)
    pf = DevicePrefetcher(ShardedBatcher(data, BATCH, "cpu"), depth=2,
                          stats=stats)
    _take(pf, 3)
    _take(pf.at_step(4), 2)
    assert pf.stats()["batches"] == 5


# -- through the loop ----------------------------------------------------------

def _loop_state():
    return TrainState(step=torch.tensor(0, dtype=torch.int32), params={},
                      model_state={}, opt_state={},
                      rng=torch.Generator().manual_seed(0))


class _RecordingFlakyStep:
    """Records each batch's label sum; raises PreemptionError on chosen
    calls (1-based)."""

    def __init__(self, fail_at=()):
        self.calls, self.fail_at, self.seen = 0, set(fail_at), []

    def __call__(self, state, batch):
        self.calls += 1
        if self.calls in self.fail_at:
            raise PreemptionError("fake preemption")
        self.seen.append(int(batch["label"].sum()))
        return (TrainState(step=state.step + 1, params={}, model_state={},
                           opt_state={}, rng=state.rng),
                {"loss": torch.tensor(1.0)})


class _MemoryCkpt:
    def __init__(self):
        self.saved = None

    def save(self, state):
        self.saved = state

    def restore(self, target):
        return self.saved


def test_recovery_replays_through_prefetcher(data):
    expected = [int(b["label"].sum()) for b in
                _take(ShardedBatcher(data, BATCH, "cpu", seed=0), 6)]
    step = _RecordingFlakyStep(fail_at={4})
    mgr = _MemoryCkpt()
    state = _loop_state()
    mgr.save(state)
    loop = TrainLoop(step, state,
                     DevicePrefetcher(ShardedBatcher(data, BATCH, "cpu",
                                                     seed=0), depth=2),
                     [StopAtStepHook(last_step=6)], checkpoint_manager=mgr,
                     max_recoveries=1)
    assert loop.run().step_int == 6
    assert step.seen == expected[:3] + expected[:6]
    assert _wait_drained()
    assert loop.batches.stats()["batches"] >= 9


def test_runahead_bounds_inflight_steps():
    observed = []
    loop = TrainLoop(lambda s, b: (TrainState(
        step=s.step + 1, params={}, model_state={}, opt_state={},
        rng=s.rng), {"loss": torch.tensor(1.0)}),
        _loop_state(), itertools.repeat(1.0),
        [StopAtStepHook(last_step=12)], runahead=2)

    class _WatchedDeque(collections.deque):
        def append(self, x):
            super().append(x)
            observed.append(len(self))

    loop._inflight = _WatchedDeque()
    assert loop.run().step_int == 12
    assert observed and max(observed) <= 2
    assert loop.runahead_wait_s >= 0.0
    assert not loop._inflight


def test_input_pipeline_hook_reports(data):
    class _BatchRecWriter:
        def __init__(self):
            self.rows = []

        def scalar(self, tag, value, step):
            self.rows.append((step, {tag: value}))

        def scalars(self, values, step):
            self.rows.append((step, dict(values)))

    writer = _BatchRecWriter()
    loop = TrainLoop(_RecordingFlakyStep(), _loop_state(),
                     DevicePrefetcher(ShardedBatcher(data, BATCH, "cpu",
                                                     seed=0), depth=2),
                     [InputPipelineHook(writer, every_steps=4),
                      StopAtStepHook(last_step=8)], runahead=1)
    loop.run()
    assert [s for s, _ in writer.rows] == [4, 8]
    for _, vals in writer.rows:
        assert set(vals) == {"input/feed_stall_ms_per_step",
                             "input/runahead_wait_ms_per_step",
                             "input/prefetch_occupancy",
                             "input/h2d_mbytes_per_step"}
        assert vals["input/h2d_mbytes_per_step"] > 0
    assert _wait_drained()
