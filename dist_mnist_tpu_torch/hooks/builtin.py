"""Built-in hooks, each mapped to its reference counterpart
(basic_session_run_hooks.py — SURVEY.md §2.4 row 18); port of the
reference package's `hooks/builtin.py`.

What the reference does with JAX, these do with torch:

- a cadence's device values come to the host in ONE transfer (`fetch`:
  every tensor flattened into one float64 vector per device, one
  `.cpu()`), never one `.item()` per key;
- `ProfilerHook` traces with `torch.profiler` and writes its chrome
  trace into `logdir`;
- `MemoryProfileHook` records the CUDA allocator's history
  (`torch.cuda.memory._record_memory_history`) and dumps a snapshot
  (`_dump_snapshot`);
- `MemoryHook`'s live stats are `torch.cuda.memory_stats()`'s
  ``allocated_bytes.all.current`` and ``.peak``.

On the CPU the memory hooks report what the reference reports for a
device without allocator stats: no live stats, and a snapshot with no
segments. `OverlapHook` refuses: the fsdp overlap plan joins with
ROADMAP §1 item 13.
"""

from __future__ import annotations

import inspect
import logging
import math
import pickle
import time

import numpy as np
import torch

from dist_mnist_tpu_torch.cluster import coordination
from dist_mnist_tpu_torch.hooks.base import Hook, EverySteps
from dist_mnist_tpu_torch.obs import events as obs_events

log = logging.getLogger(__name__)


def fetch(values: dict) -> dict:
    """`values` (tensors, Python or numpy numbers) as numpy arrays, in one
    host transfer per device: every tensor on a device is flattened into
    one float64 vector (exact for the float32, bfloat16 and int32 values a
    step returns), fetched with a single `.cpu()`, and split back."""
    out, by_device = {}, {}
    for k, v in values.items():
        if isinstance(v, torch.Tensor):
            by_device.setdefault(v.device, []).append(k)
        else:
            out[k] = np.asarray(v)
    for keys in by_device.values():
        flat = torch.cat([values[k].detach().reshape(-1).to(torch.float64)
                          for k in keys]).cpu().numpy()
        at = 0
        for k in keys:
            n = values[k].numel()
            out[k] = flat[at:at + n].reshape(tuple(values[k].shape))
            at += n
    return {k: out[k] for k in values}


def _numel(v) -> int:
    return v.numel() if isinstance(v, torch.Tensor) else int(np.size(v))


def _state_device(state) -> torch.device:
    step = getattr(state, "step", None)
    return (step.device if isinstance(step, torch.Tensor)
            else torch.device("cpu"))


class NanLossError(RuntimeError):
    """≙ NanLossDuringTrainingError raised by NanTensorHook (:761)."""


class StopAtStepHook(Hook):
    """≙ StopAtStepHook (:393-453): stop at last_step or after num_steps."""

    def __init__(self, num_steps: int | None = None, last_step: int | None = None):
        if (num_steps is None) == (last_step is None):
            raise ValueError("exactly one of num_steps / last_step")
        self._num_steps = num_steps
        self._last_step = last_step

    def begin(self, loop):
        self._loop = loop
        if self._last_step is None:
            self._last_step = loop.initial_step + self._num_steps
        if loop.initial_step >= self._last_step:
            # restored at/past the limit: exit without training an extra step
            loop.request_stop("already at last step")

    def after_step(self, step, state, outputs):
        if step >= self._last_step:
            self._loop.request_stop("reached last step")


class StepCounterHook(Hook):
    """≙ StepCounterHook (:673-750): periodic steps/sec (+ examples/sec when
    batch size is known) — the BASELINE.md metric."""

    def __init__(self, every_steps: int = 100, batch_size: int | None = None,
                 writer=None):
        self._timer = EverySteps(every_steps=every_steps)
        self._batch = batch_size
        self._writer = writer
        self._last_step = None
        self._last_time = None
        self.last_rate = None  # exposed for bench harnesses

    def begin(self, loop):
        self._last_step = loop.initial_step
        self._last_time = time.monotonic()
        self._timer.prime(loop.initial_step)

    def after_step(self, step, state, outputs):
        if not self._timer.should_trigger(step):
            return
        now = time.monotonic()
        rate = (step - self._last_step) / max(now - self._last_time, 1e-9)
        self.last_rate = rate
        self._last_step, self._last_time = step, now
        self._timer.mark()
        msg = f"step {step}: {rate:.1f} steps/sec"
        if self._batch:
            msg += f", {rate * self._batch:.0f} examples/sec"
        log.info(msg)
        if self._writer:
            self._writer.scalar("steps_per_sec", rate, step)


class InputPipelineHook(Hook):
    """Input-stall attribution for the overlapped feed path (no reference
    counterpart — queue runners hid the cost instead of measuring it).

    Reads the loop's cumulative feed/runahead wait clocks (train/loop.py)
    and, when the batch source is a `DevicePrefetcher` (anything exposing
    `stats()`), the prefetch ring counters, and writes per-interval rates
    through the obs writers at its cadence:

      input/feed_stall_ms_per_step     host blocked pulling the next batch
      input/runahead_wait_ms_per_step  host blocked on the dispatch bound
      input/prefetch_occupancy         mean ring fill at consume time
      input/h2d_mbytes_per_step        bytes the worker pushed to devices

    A healthy overlapped pipeline shows near-zero feed stall and a ring
    occupancy near its depth; occupancy ~0 with high stall means the host
    batcher (not the device) is the bottleneck. `last` keeps the most
    recent values for bench harnesses (bench.py --input)."""

    def __init__(self, writer=None, every_steps: int = 100):
        self._writer = writer
        self._timer = EverySteps(every_steps=every_steps)
        self.last: dict[str, float] = {}
        self._base = None

    def begin(self, loop):
        self._loop = loop
        self._timer.prime(loop.initial_step)
        self._base = self._snapshot(loop.initial_step)

    def _snapshot(self, step):
        snap = {
            "step": step,
            "feed_wait_s": getattr(self._loop, "feed_wait_s", 0.0),
            "runahead_wait_s": getattr(self._loop, "runahead_wait_s", 0.0),
        }
        # re-read loop.batches each time: recovery re-seek replaces it (the
        # replacement prefetcher shares its stats object, so deltas hold)
        stats_fn = getattr(self._loop.batches, "stats", None)
        snap["prefetch"] = dict(stats_fn()) if callable(stats_fn) else None
        return snap

    def after_step(self, step, state, outputs):
        if not self._timer.should_trigger(step):
            return
        self._timer.mark()
        cur = self._snapshot(step)
        base, self._base = self._base, cur
        dsteps = max(1, step - base["step"])
        vals = {
            "input/feed_stall_ms_per_step":
                1e3 * (cur["feed_wait_s"] - base["feed_wait_s"]) / dsteps,
            "input/runahead_wait_ms_per_step":
                1e3 * (cur["runahead_wait_s"] - base["runahead_wait_s"])
                / dsteps,
        }
        if cur["prefetch"] is not None:
            p0 = base["prefetch"] or {}
            p = cur["prefetch"]
            vals["input/prefetch_occupancy"] = p["mean_occupancy"]
            vals["input/h2d_mbytes_per_step"] = (
                (p["h2d_bytes"] - p0.get("h2d_bytes", 0)) / dsteps / 2**20
            )
        self.last = vals
        if self._writer is not None:
            batch_write = getattr(self._writer, "scalars", None)
            if callable(batch_write):
                batch_write(vals, step)
            else:
                for k, v in vals.items():
                    self._writer.scalar(k, v, step)


class StepTimeHook(Hook):
    """Per-step wall-time percentiles from the loop's streaming histogram
    (train/loop.py `step_time_hist`, obs/hist.py). Publishes at a cadence
    so p50/p95/p99 land in the same sinks (and live registry) as every
    other scalar:

      step_time/p50_ms  step_time/p95_ms  step_time/p99_ms
      step_time/mean_ms

    The histogram itself can also be attached to a MetricRegistry for
    full-distribution /metrics exposition; this hook is the scalar-sink
    (CSV/TB) view of the same ladder."""

    def __init__(self, writer=None, every_steps: int = 100):
        self._writer = writer
        self._timer = EverySteps(every_steps=every_steps)
        self.last: dict[str, float] = {}

    def begin(self, loop):
        self._loop = loop
        self._timer.prime(loop.initial_step)

    def _emit(self, step):
        snap = self._loop.step_time_hist.snapshot()
        if not snap["count"]:
            return
        vals = {
            "step_time/p50_ms": snap["p50"],
            "step_time/p95_ms": snap["p95"],
            "step_time/p99_ms": snap["p99"],
            "step_time/mean_ms": snap["mean"],
        }
        self.last = vals
        if self._writer is not None:
            batch_write = getattr(self._writer, "scalars", None)
            if callable(batch_write):
                batch_write(vals, step)
            else:
                for k, v in vals.items():
                    self._writer.scalar(k, v, step)

    def after_step(self, step, state, outputs):
        if not self._timer.should_trigger(step):
            return
        self._timer.mark()
        self._emit(step)

    def end(self, state):
        # final-distribution summary even for runs shorter than the cadence
        self._emit(getattr(self._loop, "_host_step", 0))


class LoggingHook(Hook):
    """≙ LoggingTensorHook (:169): periodic metric prints. Syncs device
    scalars only at its cadence."""

    def __init__(self, every_steps: int = 100, keys: tuple[str, ...] | None = None):
        self._timer = EverySteps(every_steps=every_steps)
        self._keys = keys

    def begin(self, loop):
        self._timer.prime(loop.initial_step)

    def after_step(self, step, state, outputs):
        if not self._timer.should_trigger(step):
            return
        self._timer.mark()
        keys = self._keys or outputs.keys()
        # ONE device_get for every logged key: per-key float() was one
        # blocking sync per metric per cadence, serializing dispatch
        wanted = {k: outputs[k] for k in keys
                  if k in outputs and _numel(outputs[k]) == 1}
        vals = fetch(wanted)  # one batched fetch per cadence
        parts = [f"{k}={float(v):.4f}" for k, v in vals.items()]
        log.info("step %d: %s", step, ", ".join(parts))


class NaNGuardHook(Hook):
    """≙ NanTensorHook (:761): abort (or just warn) on non-finite loss.

    The reference fetched the loss every step; syncing every step would
    serialize dispatch, so the default cadence is 25 — set 1 for parity.
    """

    def __init__(self, key: str = "loss", every_steps: int = 25,
                 fail_on_nan: bool = True):
        self._key = key
        self._timer = EverySteps(every_steps=every_steps)
        self._fail = fail_on_nan

    def begin(self, loop):
        self._loop = loop
        self._timer.prime(loop.initial_step)

    def after_step(self, step, state, outputs):
        if self._key not in outputs or not self._timer.should_trigger(step):
            return
        self._timer.mark()
        # explicit single fetch (float() on a device scalar is an implicit
        # blocking sync; keep the sync surface to one call per cadence)
        val = float(fetch({self._key: outputs[self._key]})[self._key])
        if math.isfinite(val):
            return
        if self._fail:
            raise NanLossError(f"{self._key} is {val} at step {step}")
        log.warning("%s is %s at step %d; stopping", self._key, val, step)
        self._loop.request_stop("non-finite loss")


class CheckpointHook(Hook):
    """≙ CheckpointSaverHook (:524-670): save at begin (save-on-create,
    :585-602), on a step/secs cadence (:607-616), and at end (:618-623)."""

    def __init__(self, manager, every_steps: int | None = None,
                 every_secs: float | None = 600.0):
        self._mgr = manager
        self._timer = EverySteps(every_steps=every_steps, every_secs=every_secs)
        self._save_s = 0.0

    def begin(self, loop):
        self._loop = loop
        # save-on-create (:585-602): guarantees a restore point exists before
        # the first cadence trigger. Skipped when one ALREADY exists for the
        # loop's initial step (the restore that produced this state): the
        # save would dedupe anyway, but probing latest_step here avoids even
        # forking a snapshot on the async path. Blocks the first step only
        # as long as the manager's save() does — milliseconds under
        # AsyncSnapshotter, where the write rides the background path.
        self._timer.prime(loop.initial_step)
        latest = self._mgr.latest_step()
        if latest is None or latest < loop.initial_step:
            self._mgr.save(loop.state)

    def after_step(self, step, state, outputs):
        # a seconds cadence fires on each rank's own clock; every rank
        # must save at the same step (a host all-reduce a step, with
        # several ranks; a steps cadence needs none)
        due = self._timer.should_trigger(step)
        if self._timer.every_secs is not None:
            due = coordination.any_rank(due)
        if due:
            self._timer.mark()
            # journal the save as a `checkpoint` span — HOST-SIDE DISPATCH
            # only (async managers return at the fork/handoff; the paired
            # `checkpoint_commit` event lands when the background write is
            # durable, so dispatch→durable shows as a real span in
            # scripts/fleet_trace.py). The save cadence IS the span's
            # cadence gate, and emit() is a no-op without a journal, so
            # the clock costs nothing extra.
            t0 = time.monotonic()
            self._mgr.save(state)
            dt = time.monotonic() - t0
            self._save_s += dt  # drained by the loop into goodput save_s
            obs_events.emit(
                "span", name="checkpoint", step=int(step),
                dur_ms=round(dt * 1e3, 3))
        # commit markers for async saves land the moment the write is
        # durable, not at the next cadence save — a kill inside the
        # cadence window must not quarantine a durable step
        flush = getattr(self._mgr, "flush_commits", None)
        if flush is not None:
            flush()

    def consume_save_s(self) -> float:
        """Hook-side save time since last drain (TrainLoop charges it to
        the goodput `save_s` bucket and keeps it out of productive)."""
        s, self._save_s = self._save_s, 0.0
        return s

    def end(self, state):
        self._mgr.save(state)
        self._mgr.wait()


class SummaryHook(Hook):
    """≙ SummarySaverHook (:793) + SummaryWriterCache: periodic summaries to
    a metric writer (obs/writers.py). Scalar outputs become scalar
    summaries; array outputs (e.g. the per-leaf `grad_norms` vector from
    `make_train_step(with_grad_norm=True)`) become histograms — the
    arbitrary-summary-proto parity the reference hook had beyond scalars.

    `param_histograms_every` additionally writes one histogram per PARAM
    LEAF on its own (slower) cadence — it pulls every param to the host, so
    it defaults off and should stay a few orders sparser than scalars.
    """

    def __init__(self, writer, every_steps: int = 100,
                 param_histograms_every: int | None = None):
        self._writer = writer
        self._timer = EverySteps(every_steps=every_steps)
        self._param_timer = (
            EverySteps(every_steps=param_histograms_every)
            if param_histograms_every else None
        )

    def begin(self, loop):
        self._timer.prime(loop.initial_step)
        if self._param_timer:
            self._param_timer.prime(loop.initial_step)

    def after_step(self, step, state, outputs):
        if self._param_timer and self._param_timer.should_trigger(step):
            self._param_timer.mark()
            self._write_param_histograms(step, state)
        if not self._timer.should_trigger(step):
            return
        self._timer.mark()
        # ONE device_get for the whole cadence — histograms AND scalars.
        # The per-key `float(v)` here was one blocking sync per metric per
        # cadence (the same serialized-dispatch bug LoggingHook fixed).
        fetched = fetch(dict(outputs))  # one batched fetch per cadence
        vals = {}
        for k, v in fetched.items():
            if np.size(v) > 1:
                self._write_histogram(k, v, step)
                continue
            try:
                vals[k] = float(v)
            except (TypeError, ValueError):
                pass
        batch_write = getattr(self._writer, "scalars", None)
        if callable(batch_write):
            batch_write(vals, step)
        else:
            for k, v in vals.items():
                self._writer.scalar(k, v, step)

    def _write_histogram(self, tag, values, step):
        if hasattr(self._writer, "histogram"):
            self._writer.histogram(tag, values, step)
            return
        # pre-histogram custom writers (scalar/flush-only MetricWriter
        # protocol): degrade to summary-stat scalars instead of crashing
        from dist_mnist_tpu_torch.obs.writers import _summary_stats

        for k, v in _summary_stats(values).items():
            self._writer.scalar(f"{tag}/{k}", v, step)

    def _write_param_histograms(self, step, state):
        from dist_mnist_tpu_torch.utils.tree import flatten_with_path

        wanted = {"/".join(str(k) for k in path): leaf
                  for path, leaf in flatten_with_path(state.params)
                  if _numel(leaf)}
        fetched = fetch(wanted)  # one batched pull per param cadence
        for path, vals in fetched.items():
            self._write_histogram(f"params/{path}", vals, step)

    def end(self, state):
        self._writer.flush()


class ProfilerHook(Hook):
    """≙ ProfilerHook (:1013-1095): Chrome-trace a window of steps. Uses
    `torch.profiler` (host ops, and the device's kernels on a CUDA state)
    instead of RunMetadata/Timeline, and writes
    ``<logdir>/trace-steps<start>-<stop>.json``. `start_step`/`num_steps`
    are relative to THIS run's first step (resume-aware)."""

    def __init__(self, logdir: str, start_step: int = 10, num_steps: int = 3):
        self._logdir = logdir
        self._start_offset = start_step  # relative to THIS run's first step
        self._num = num_steps
        self._start = self._stop = None
        self._active = False
        self._done = False
        self._prof = None
        self._device = torch.device("cpu")
        self.trace_path = None

    def begin(self, loop):
        self._device = _state_device(loop.state)
        # anchor to the restored step — a run resumed at step 100 traces
        # steps 110..112, not never. Under a chunked loop (steps_per_call
        # > 1) before_step only ever sees chunk boundaries, so align the
        # window start DOWN to the boundary whose chunk contains it — the
        # trace then covers that whole chunk (incl. a single-chunk run
        # where before_step(0) is the only pre-window call).
        stride = getattr(loop, "steps_per_call", 1)
        offset = (self._start_offset // stride) * stride if stride > 1 \
            else self._start_offset
        self._start = loop.initial_step + offset
        self._stop = self._start + self._num

    def before_step(self, step):
        # >= not ==: a chunked loop (scan_chunk) strides past the exact
        # start step; the trace then covers whole chunks (the finest
        # granularity a compiled multi-step program can offer). _done
        # guards against restarting once the window has been captured.
        if not self._done and not self._active and step >= self._start:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self._device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.__enter__()
            self._active = True

    def _stop_and_export(self):
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        self._active = False
        self._done = True
        try:
            # a chrome://tracing-loadable timeline in logdir (the
            # reference writes its timeline-*.json next to the profile)
            from pathlib import Path

            out = Path(self._logdir) / (
                f"trace-steps{self._start}-{self._stop}.json")
            out.parent.mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(out))
            self.trace_path = str(out)
            log.info("profile (window [%d, %d)) -> chrome trace %s",
                     self._start, self._stop, out)
        except Exception:  # noqa: BLE001 — triage aid must not kill training
            log.exception("chrome trace export failed")

    def after_step(self, step, state, outputs):
        # after_step sees the post-increment step: steps _start.._stop-1
        # (num_steps of them) run inside the trace window
        if self._active and step >= self._stop:
            if self._device.type == "cuda":
                torch.cuda.synchronize(self._device)
            self._stop_and_export()

    def end(self, state):
        # a run shorter than the trace window still gets its timeline —
        # same export path as the cadence stop (ADVICE r1 item 1)
        if self._active:
            self._stop_and_export()


class MemoryProfileHook(Hook):
    """Dump a device-memory snapshot at a chosen step — the memory triage
    companion to ProfilerHook's timeline. No counterpart in the PS-era
    reference; the JAX package writes a pprof device-memory profile.
    Here the CUDA allocator records its history from `begin` and the hook
    dumps `torch.cuda.memory._dump_snapshot` (the pickle that
    pytorch.org/memory_viz reads) to ``memory-step<N>.prof``. On the CPU,
    where no CUDA allocator runs, the dump holds empty ``segments`` and
    ``device_traces``."""

    def __init__(self, logdir: str, after_steps: int = 20):
        # default 20 stays clear of ProfilerHook's default trace window
        # (steps 10..12 of the run) — the blocking dump would otherwise
        # land mid-trace and distort the timeline it accompanies
        self._logdir = logdir
        self._after = after_steps  # relative: fires this many steps into
        self._at = None            # THIS run (restored runs included)
        self._device = torch.device("cpu")
        self._recording = False

    def begin(self, loop):
        # anchor to the restored step, and never past the run's end — a
        # short run still gets its profile on the final step
        self._at = loop.initial_step + self._after
        self._device = _state_device(loop.state)
        if self._device.type == "cuda":
            torch.cuda.memory._record_memory_history(max_entries=100_000)
            self._recording = True

    def _dump(self, path):
        try:
            from pathlib import Path

            Path(path).parent.mkdir(parents=True, exist_ok=True)
            if self._device.type == "cuda":
                torch.cuda.synchronize(self._device)
                torch.cuda.memory._dump_snapshot(path)
            else:
                with open(path, "wb") as fh:
                    pickle.dump({"segments": [], "device_traces": []}, fh)
            log.info("device memory snapshot -> %s", path)
        except Exception:  # noqa: BLE001 — triage aid must not kill training
            log.exception("device memory snapshot failed")
        finally:
            if self._recording:
                torch.cuda.memory._record_memory_history(enabled=None)
                self._recording = False

    def after_step(self, step, state, outputs):
        if self._at is None or step < self._at:
            return
        self._at = None  # fire once
        self._dump(f"{self._logdir}/memory-step{step}.prof")

    def end(self, state):
        # run shorter than after_steps: still capture (post-final-step)
        if self._at is not None:
            self._at = None
            self._dump(f"{self._logdir}/memory-final.prof")


class MemoryHook(Hook):
    """Per-device HBM attribution through the obs writers — the hook face
    of `bench.py --memory`. No reference counterpart: the PS design spread
    state across hosts' RAM; under SPMD the scarce resource is device HBM
    and WHERE the bytes live (replicated vs 1/data-th under `fsdp`) is a
    placement decision this hook makes observable.

    At `begin` it writes the resident-state attribution computed from
    shard shapes (train/state.state_memory_bytes — pure metadata, no
    transfer):

      memory/param_bytes_per_device        master weights
      memory/opt_state_bytes_per_device    Adam m/v + counters
      memory/model_state_bytes_per_device  BN stats etc.
      memory/total_bytes_per_device

    and at its cadence, live allocator stats on a CUDA state
    (`torch.cuda.memory_stats()`: ``allocated_bytes.all.current`` and
    ``.peak``; none on the CPU):

      memory/bytes_in_use
      memory/peak_bytes_in_use

    `last` keeps the newest values for bench harnesses."""

    def __init__(self, writer=None, every_steps: int = 100):
        self._writer = writer
        self._timer = EverySteps(every_steps=every_steps)
        self.last: dict[str, float] = {}
        self._device = torch.device("cpu")

    def begin(self, loop):
        from dist_mnist_tpu_torch.train.state import state_memory_bytes

        self._timer.prime(loop.initial_step)
        self._device = _state_device(loop.state)
        vals = {f"memory/{k}_per_device": v
                for k, v in state_memory_bytes(loop.state).items()}
        log.info(
            "resident state per device: params %.2f MiB, opt state %.2f "
            "MiB, model state %.2f MiB",
            vals["memory/param_bytes_per_device"] / 2**20,
            vals["memory/opt_state_bytes_per_device"] / 2**20,
            vals["memory/model_state_bytes_per_device"] / 2**20,
        )
        self._emit(vals, loop.initial_step)

    def _live_stats(self) -> dict:
        if self._device.type != "cuda":
            return {}  # the CPU has no allocator stats
        stats = torch.cuda.memory_stats(self._device)
        names = {"bytes_in_use": "allocated_bytes.all.current",
                 "peak_bytes_in_use": "allocated_bytes.all.peak"}
        return {f"memory/{k}": stats[v] for k, v in names.items()
                if v in stats}

    def _emit(self, vals, step):
        self.last.update(vals)
        if self._writer is None:
            return
        batch_write = getattr(self._writer, "scalars", None)
        if callable(batch_write):
            batch_write(vals, step)
        else:
            for k, v in vals.items():
                self._writer.scalar(k, v, step)

    def after_step(self, step, state, outputs):
        if not self._timer.should_trigger(step):
            return
        self._timer.mark()
        vals = self._live_stats()
        if vals:
            self._emit(vals, step)


class OverlapHook(Hook):
    """The fsdp comm/compute-overlap plan's ``overlap/*`` scalars. The
    overlap schedule (`parallel/overlap.py`) joins the port with ROADMAP
    §1 item 13, so this hook refuses to be built."""

    def __init__(self, writer=None, stats: dict | None = None):
        raise NotImplementedError(
            "OverlapHook: the fsdp overlap plan (parallel/overlap.py) joins "
            "the port with ROADMAP §1 item 13 (resilience, async I/O, "
            "overlap)")


class GlobalStepWaiterHook(Hook):
    """≙ GlobalStepWaiterHook (basic_session_run_hooks.py:902): delay this
    process's training until the job's global step reaches `wait_until_step`.

    The reference polled the PS-resident global_step variable (the only
    cross-worker channel); under SPMD the cross-JOB channel is the
    checkpoint directory, so this polls `checkpoint_manager.latest_step()`.
    A state already restored at/past the threshold passes immediately.
    Typical use: stagger a follower job (eval/export/continuation) until a
    trainer job's checkpoints reach step N.
    """

    def __init__(self, wait_until_step: int, checkpoint_manager=None,
                 poll_secs: float = 0.5, timeout_secs: float | None = None,
                 log_every_secs: float = 10.0):
        self._wait_until = wait_until_step
        self._mgr = checkpoint_manager
        self._poll = poll_secs
        self._timeout = timeout_secs
        self._log_every = log_every_secs

    def begin(self, loop):
        if self._wait_until <= 0 or loop.initial_step >= self._wait_until:
            return
        if self._mgr is None:
            raise ValueError(
                "GlobalStepWaiterHook needs a checkpoint_manager to observe "
                "another job's progress (no shared global_step exists)"
            )
        log.info("waiting for global step %d...", self._wait_until)
        t0 = last_log = time.monotonic()
        # a FOREIGN job is writing the checkpoints, so each poll must rescan
        # the directory — cached step lists (orbax caches at init) would spin
        # forever. Our CheckpointManager: latest_step(refresh=True); bare
        # orbax managers: reload() first; fakes: plain latest_step().
        try:
            has_refresh = "refresh" in inspect.signature(
                self._mgr.latest_step
            ).parameters
        except (TypeError, ValueError):
            has_refresh = False
        reload_fn = getattr(self._mgr, "reload", None)

        def poll():
            if has_refresh:
                return self._mgr.latest_step(refresh=True)
            if callable(reload_fn):
                reload_fn()
            return self._mgr.latest_step()

        while True:
            latest = poll()
            if latest is not None and latest >= self._wait_until:
                log.info("global step %d reached (%.1fs)", latest,
                         time.monotonic() - t0)
                return
            now = time.monotonic()
            if self._timeout is not None and now - t0 > self._timeout:
                raise TimeoutError(
                    f"global step {self._wait_until} not reached in "
                    f"{self._timeout}s (latest={latest})"
                )
            if now - last_log >= self._log_every:
                # reference cadence: a progress line every 10 s (:986-994)
                log.info("still waiting for step %d (latest=%s)",
                         self._wait_until, latest)
                last_log = now
            time.sleep(self._poll)


class FinalOpsHook(Hook):
    """≙ FinalOpsHook (basic_session_run_hooks.py:1098): evaluate one last
    thing on the final state; result kept on `.final_result`."""

    def __init__(self, final_fn):
        self._fn = final_fn
        self.final_result = None

    def end(self, state):
        self.final_result = self._fn(state)


class EvalHook(Hook):
    """Periodic full-test-set eval (the reference did this ad hoc at the end
    of the train loop — §0.1 step 9; as a hook it also serves the 'validation
    while training' role MonitoredTrainingSession left to summaries)."""

    def __init__(self, eval_fn, every_steps: int = 1000, writer=None,
                 name: str = "test"):
        self._eval = eval_fn
        self._timer = EverySteps(every_steps=every_steps)
        self._writer = writer
        self._name = name
        self.last_result: dict | None = None
        self._last_eval_step: int | None = None

    def begin(self, loop):
        self._timer.prime(loop.initial_step)

    def _run(self, step, state):
        res = self._eval(state)
        self.last_result = res
        self._last_eval_step = step
        log.info("%s eval @ step %d: loss=%.4f acc=%.4f",
                 self._name, step, res["loss"], res["accuracy"])
        if self._writer:
            self._writer.scalar(f"{self._name}/loss", res["loss"], step)
            self._writer.scalar(f"{self._name}/accuracy", res["accuracy"], step)

    def after_step(self, step, state, outputs):
        if self._timer.should_trigger(step):
            self._timer.mark()
            self._run(step, state)

    def end(self, state):
        step = -1 if state is None else int(state.step)
        if step == self._last_eval_step:
            return  # final step landed on the cadence; don't eval twice
        self._run(step, state)
