"""Training driver — the `dist_mnist.py` replacement (port of the reference
`cli/train.py`).

    python -m dist_mnist_tpu_torch.cli.train --config=lenet5_mnist \\
        --checkpoint_dir=/tmp/ckpt --logdir=/tmp/logs
    python -m dist_mnist_tpu_torch.cli.launch --num_processes=2 -- \\
        --config=lenet5_fashion --mesh=data=2      # two ranks (cli/launch.py)
    python -m dist_mnist_tpu_torch.cli.launch --num_processes=4 -- \
        --config=vit_tiny_cifar_moe --mesh=model=4  # expert parallelism

Runs on the CUDA device by default and exits with an error when there is
none; `--device=cpu` (or `--platform=cpu`, the reference's flag) runs the
plain CPU path. With `--num_processes=N --process_id=K
--coordinator_address=host:port` (what `cli.launch` passes) the process
is rank K of a group of N (`cluster/coordination.py`), one device per
process, and trains its slice of every global batch on the config's mesh
(`--mesh=data=D,model=M,seq=S,pipe=P` overrides it: D x M x S x P
ranks, ``pipe`` varying fastest, then ``seq``, then ``model``; a model
axis splits the TP leaves, or an MoE config's experts and their tokens;
a seq axis shards every sequence's tokens for the ring and Ulysses
configs; a pipe axis the block stack's stages for the pipeline config)
under `--sharding=dp|fsdp|tp|fsdp_tp`; the startup line names the rank,
the devices and the backend. Flags keep
the reference's names and absl's spellings (``--flag=value``, ``--flag
value``, ``--noflag`` for a boolean), parsed with argparse. The
parameter-server-era flags (--job_name/--task_index/--num_gpus/
--existing_servers/--ps_hosts/--worker_hosts, --nosync_replicas) are
accepted and warned about, as the reference does. Every flag of a
subsystem the port does not have yet (a seq axis beside a model axis,
a pipe axis beside either, overlap, a
PRNG implementation, fault plans, the compile cache,
elastic resizing, async snapshots and peers, the metrics exporter,
anomaly detection, the tuned store) exits with an error that names the
ROADMAP §1 item it waits for; `--host_device_count` refuses as a stated
departure (one device per process).

A run: the dataset (or its synthetic twin), a seeded init or the latest
checkpoint, the config's step on the host batcher (`--input_pipeline=
python`) or the C++ one (`native`, `data/native`: its rows assembled on a
producer thread; g++ builds it, and a missing g++ fails the run), either
prefetched `--prefetch_depth` batches ahead on a side CUDA stream, or on
the device-resident dataset (`device`, or `device_sharded`
with 1/N of the rows on each rank, optionally in chunks of
`--scan_chunk` steps), the reference's hooks in its order (the ones that
write files on the chief, the logging ones on every rank), and
a SIGTERM/SIGINT handshake that checkpoints at the next step boundary,
logs ``preempted@step=N`` and exits 0. It ends with ``done: step=...
test_acc=... test_loss=... wall=...s``.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import logging
import os
import time
from pathlib import Path

from dist_mnist_tpu_torch.optim import build_optimizer

log = logging.getLogger(__name__)

__all__ = ["build_optimizer", "run_config", "main"]

#: the reference's default PRNG implementation: the only one the port
#: has (it draws from one torch.Generator)
DEFAULT_PRNG_IMPL = "threefry2x32"

#: ROADMAP §1 items the refused flags and options wait for
_RESILIENCE = "ROADMAP §1 item 13 (resilience, async I/O, overlap)"
_TELEMETRY = "ROADMAP §1 item 14 (telemetry)"
_TUNING = "ROADMAP §1 item 16 (tuning and lint)"


def _refuse(what: str, item: str):
    return NotImplementedError(f"{what} joins the port with {item}")


def check_config(cfg) -> None:
    """Refuse what a config asks beyond the port: a seq axis beside a
    model axis and a pipe axis beside either, the fsdp overlap, and a PRNG
    implementation (the port draws every random number from one
    `torch.Generator`; ROADMAP §1's closing line: `utils/prng.py` has no
    counterpart)."""
    from dist_mnist_tpu_torch.cluster.mesh import check_axes
    from dist_mnist_tpu_torch.parallel.sharding import resolve_rules

    if cfg.prng_impl != DEFAULT_PRNG_IMPL:
        raise NotImplementedError(
            f"prng_impl={cfg.prng_impl!r}: the port draws from one "
            "torch.Generator and has no PRNG implementations to choose "
            "from (ROADMAP §1, closing line: utils/prng.py)")
    check_axes(cfg.mesh)
    resolve_rules(cfg.sharding_rules)
    if cfg.overlap:
        raise _refuse("overlap (the fsdp comm/compute overlap)", _RESILIENCE)


@contextlib.contextmanager
def _journal_scope(cfg, journal, logdir, generation):
    """The run journal around one run, with the reference's ``run_start``
    and ``run_stop`` records. `journal` is a path or an obs.RunJournal;
    without one the chief's journal is <logdir>/events.jsonl, and without
    a logdir (or on another rank) events go wherever the process's journal
    already is. Yields a dict the run fills with its ``loop``;
    ``journal`` holds the journal's path."""
    from dist_mnist_tpu_torch.cluster import coordination
    from dist_mnist_tpu_torch.obs import events as events_mod

    journal_obj, journal_owned = None, False
    if isinstance(journal, events_mod.RunJournal):
        journal_obj = journal
    elif journal:
        journal_obj, journal_owned = (
            events_mod.RunJournal(journal, generation=generation), True)
    elif logdir and coordination.is_chief():
        journal_obj, journal_owned = (
            events_mod.RunJournal(Path(logdir) / "events.jsonl",
                                  generation=generation), True)
    prev_journal = (events_mod.set_journal(journal_obj)
                    if journal_obj is not None else None)
    ctx = coordination.context()
    run = {"journal": journal_obj.path if journal_obj else None,
           "rank": 0 if ctx is None else ctx.rank,
           "world": 1 if ctx is None else ctx.world}
    events_mod.emit("run_start", config=cfg.name,
                    train_steps=cfg.train_steps)
    try:
        yield run
        loop = run["loop"]
        events_mod.emit("run_stop", ok=True, step=loop.state.step_int,
                        preempted_at=loop.preempted_at,
                        reason=loop.stop.reason,
                        process=run["rank"], world=run["world"],
                        devices=run["world"],
                        goodput={
                            k: (round(v, 6) if isinstance(v, float) else v)
                            for k, v in loop.goodput.snapshot().items()
                        })
    except BaseException as exc:
        events_mod.emit("run_stop", ok=False, error=type(exc).__name__)
        raise
    finally:
        if journal_obj is not None:
            events_mod.set_journal(prev_journal)
            if journal_owned:
                journal_obj.close()


def run_config(
    cfg,
    *,
    device=None,
    data_dir: str | None = None,
    checkpoint_dir: str | None = None,
    logdir: str | None = None,
    profile: bool = False,
    max_recoveries: int = 0,
    extra_hooks=(),
    input_pipeline: str = "python",
    scan_chunk: int = 0,
    prefetch_depth: int = 0,
    runahead: int = 0,
    preemption=None,
    max_restore_fallbacks: int = 1,
    journal=None,
    generation: int = 0,
    checkpoint_every_steps: int = 0,
    span_steps: int = 0,
    mesh=None,
):
    """Train `cfg` (tests and chip_smoke.py call this; main() parses
    flags) on `mesh`, by default the config's mesh over the ranks of the
    process group (one rank without one). Refuses a config `check_config`
    refuses. The run is journaled (see `_journal_scope`).

    Returns (final_state, final_eval_dict, context)."""
    check_config(cfg)
    from dist_mnist_tpu_torch import hooks as hooks_lib
    from dist_mnist_tpu_torch.cluster import coordination
    from dist_mnist_tpu_torch.cluster.mesh import MODEL_AXIS, make_mesh
    from dist_mnist_tpu_torch.checkpoint import CheckpointManager
    from dist_mnist_tpu_torch.data.datasets import load_dataset
    from dist_mnist_tpu_torch.data.pipeline import (
        DeviceDataset,
        ShardedBatcher,
    )
    from dist_mnist_tpu_torch.data.prefetch import DevicePrefetcher
    from dist_mnist_tpu_torch.faults.goodput import GoodputHook
    from dist_mnist_tpu_torch.models.registry import get_model
    from dist_mnist_tpu_torch.obs.writers import make_default_writer
    from dist_mnist_tpu_torch.ops import losses
    from dist_mnist_tpu_torch.parallel.collectives import collective_stats
    from dist_mnist_tpu_torch.ops.kernels import (
        launch_counts,
        reset_launch_counts,
    )
    from dist_mnist_tpu_torch.parallel.sharding import (
        replicated_leaves,
        resolve_rules,
        shard_train_state,
        unshard_state,
    )
    from dist_mnist_tpu_torch.train import (
        create_train_state,
        evaluate,
        make_eval_step,
        make_fused_train_step,
        make_scanned_train_fn,
        make_train_step,
    )
    from dist_mnist_tpu_torch.train.loop import TrainLoop
    from dist_mnist_tpu_torch.train.state import (
        params_digest,
        state_memory_bytes,
    )
    from dist_mnist_tpu_torch.utils.device import resolve_device

    with _journal_scope(cfg, journal, logdir, generation) as journaled:
        t0 = time.monotonic()
        # flag-combination errors fail BEFORE any expensive work (dataset
        # load, init, restore) — decidable from the arguments alone
        if input_pipeline not in ("python", "native", "device",
                                  "device_sharded"):
            raise ValueError(f"unknown input_pipeline {input_pipeline!r}; use "
                             "python | native | device | device_sharded")
        if scan_chunk and not input_pipeline.startswith("device"):
            raise ValueError(
                "--scan_chunk needs the in-step input path "
                "(--input_pipeline=device): a host batcher cannot feed a "
                "multi-step chunk")
        if scan_chunk and cfg.train_steps % scan_chunk:
            stop_at = -(-cfg.train_steps // scan_chunk) * scan_chunk
            log.warning(
                "train_steps=%d is not a multiple of scan_chunk=%d: the "
                "loop stops at the chunk boundary, step %d (%d extra steps, "
                "past the LR schedule horizon)", cfg.train_steps, scan_chunk,
                stop_at, stop_at - cfg.train_steps)
        device = resolve_device(device)
        rules = resolve_rules(cfg.sharding_rules)
        if mesh is None:
            mesh = make_mesh(cfg.mesh, device=device)
        dataset = load_dataset(cfg.dataset, data_dir, seed=cfg.seed)
        model = get_model(cfg.model, **cfg.model_kwargs)
        optimizer = build_optimizer(cfg)
        loss_fn = (losses.clipped_softmax_cross_entropy
                   if cfg.loss == "clipped" else losses.softmax_cross_entropy)
        state = create_train_state(model, optimizer, cfg.seed,
                                   dataset.train_images[:1], device)

        manager = None
        restored = False
        if checkpoint_dir:
            manager = CheckpointManager(
                checkpoint_dir, async_save=True,
                max_restore_fallbacks=max_restore_fallbacks)
            # every rank reads the full file, then shards it below
            state, restored = manager.restore_or_init(state)
        state = shard_train_state(state, mesh, rules)
        initial_step = state.step_int
        log.info("config %s: model=%s on %s, mesh %s, sharding %s, "
                 "restored=%s; %s", cfg.name, cfg.model, device,
                 {k: v for k, v in mesh.shape.items() if v > 1} or "1",
                 cfg.sharding_rules, restored,
                 coordination.startup_line(coordination.context()))

        step_kw = dict(loss_fn=loss_fn, remat=cfg.remat,
                       remat_policy=cfg.remat_policy, augment=cfg.augment,
                       mesh=mesh, rules=rules)
        if input_pipeline.startswith("device"):
            # the dataset lives on the device and each step samples there from
            # state.rng: no feed at all, and resume-exact because the draws
            # continue from the restored generator. Semantics: with-replacement
            # draws (vs the host path's shuffled epochs), as in the reference
            dd = DeviceDataset(dataset, device, mesh=mesh,
                               shard=input_pipeline == "device_sharded",
                               seed=cfg.seed)
            if scan_chunk:
                run = make_scanned_train_fn(model, optimizer, dd,
                                            cfg.batch_size, scan_chunk,
                                            **step_kw)
            else:
                run = make_fused_train_step(model, optimizer, dd,
                                            cfg.batch_size, **step_kw)

            def step_fn(state, _batch):
                return run(state)
        else:
            step_fn = make_train_step(model, optimizer, **step_kw)
        stats = collective_stats(mesh)
        one_call: dict = {}

        def counted_step(state, batch):
            # what the collectives of one call moved (the last call's)
            before = dict(stats)
            out = step_fn(state, batch)
            one_call.clear()
            one_call.update({k: v - before.get(k, 0)
                             for k, v in stats.items()})
            return out

        eval_step = make_eval_step(model)

        def eval_fn(s):
            return evaluate(eval_step, s, dataset.test_images,
                            dataset.test_labels, mesh=mesh)

        chief = coordination.is_chief()
        writer = make_default_writer(logdir, chief=chief)
        hooks = [
            hooks_lib.StopAtStepHook(last_step=cfg.train_steps),
            hooks_lib.StepCounterHook(every_steps=cfg.log_every,
                                      batch_size=cfg.batch_size,
                                      writer=writer),
            hooks_lib.InputPipelineHook(writer, every_steps=cfg.log_every),
            hooks_lib.StepTimeHook(writer, every_steps=cfg.log_every),
            hooks_lib.LoggingHook(every_steps=cfg.log_every),
            hooks_lib.SummaryHook(writer, every_steps=cfg.log_every),
            hooks_lib.MemoryHook(writer, every_steps=cfg.log_every),
            hooks_lib.NaNGuardHook(),
        ]
        goodput_hook = GoodputHook(writer, every_steps=cfg.log_every)
        hooks.append(goodput_hook)
        eval_hook = None
        if cfg.eval_every:
            eval_hook = hooks_lib.EvalHook(eval_fn, every_steps=cfg.eval_every,
                                           writer=writer)
            hooks.append(eval_hook)
        if manager:
            hooks.append(
                hooks_lib.CheckpointHook(manager,
                                         every_steps=checkpoint_every_steps)
                if checkpoint_every_steps
                else hooks_lib.CheckpointHook(
                    manager, every_secs=cfg.checkpoint_every_secs))
        if profile and logdir and chief:
            hooks.append(hooks_lib.ProfilerHook(logdir))
            hooks.append(hooks_lib.MemoryProfileHook(logdir))
        hooks.extend(extra_hooks)

        # resume-aware: start the stream at the restored step so the
        # post-restore trajectory equals the uninterrupted one
        if input_pipeline.startswith("device"):
            batches = itertools.repeat(None)  # sampling lives in the step
        else:
            if input_pipeline == "native":
                from dist_mnist_tpu_torch.data.native import NativeBatcher

                batches = NativeBatcher(dataset, cfg.batch_size, mesh,
                                        seed=cfg.seed,
                                        start_step=initial_step)
            else:
                batches = ShardedBatcher(dataset, cfg.batch_size, device,
                                         seed=cfg.seed,
                                         start_step=initial_step, mesh=mesh)
            if prefetch_depth:
                # overlap the host-to-device copy with the running step
                batches = DevicePrefetcher(batches, depth=prefetch_depth)
        loop = TrainLoop(
            counted_step, state, batches, hooks,
            checkpoint_manager=manager,
            max_recoveries=max_recoveries,
            steps_per_call=max(1, scan_chunk),
            runahead=runahead,
            preemption=preemption,
            span_steps=span_steps,
        )
        journaled["loop"] = loop
        log.info("resident state per rank: %s",
                 json.dumps(state_memory_bytes(state), sort_keys=True))
        # the loop's kernel launches alone (evaluation inside it included)
        reset_launch_counts()
        try:
            state = loop.run()
            launches = launch_counts()
            # EvalHook.end already evaluated the final state; don't pay for a
            # second full test-set pass
            final = eval_hook.last_result if eval_hook else eval_fn(state)
        finally:
            if manager:
                manager.close()
            writer.close()
            if input_pipeline == "native":
                # the C++ producer of the stream the loop ended on
                getattr(loop.batches, "inner", loop.batches).close()
        elapsed = time.monotonic() - t0
        per_step = {k: v / max(1, scan_chunk) for k, v in one_call.items()}
        log.info("kernel launches: %s", json.dumps(launches, sort_keys=True))
        if device.type == "cuda":
            import torch

            # this process's high-water mark of allocated device bytes
            log.info("peak allocated bytes: %d",
                     torch.cuda.max_memory_allocated(device))
        if mesh.ranks > 1:
            log.info("collectives per step: %s",
                     json.dumps(per_step, sort_keys=True))
            if state.placement is not None:
                # this rank's own copies of the leaves no tensor-parallel
                # rule splits: the same bits on every rank of its model
                # group (on every rank without FSDP), or an operator is
                # wrong
                log.info("model-replicated leaves digest: %s",
                         params_digest(replicated_leaves(
                             state.params, state.placement.specs.params,
                             axes=(MODEL_AXIS,))))
            # a collective: every rank gathers its FSDP and TP slices
            log.info("final params digest: %s",
                     params_digest(unshard_state(state).params))
        log.info("done: step=%d test_acc=%.4f test_loss=%.4f wall=%.1fs",
                 state.step_int, final["accuracy"], final["loss"], elapsed)
        feed_stats = getattr(loop.batches, "stats", None)
        return state, final, {
            "model": model, "elapsed": elapsed, "dataset": dataset,
            "loop": loop, "device": device, "restored": restored,
            "initial_step": initial_step, "goodput": goodput_hook.last,
            "prefetch": feed_stats() if callable(feed_stats) else None,
            "preempted_at": loop.preempted_at, "journal": journaled["journal"],
            "mesh": mesh, "collectives_per_step": per_step,
            "launches": launches,
        }


# -- flags --------------------------------------------------------------------

def _parse_bool(text: str) -> bool:
    low = text.lower()
    if low in ("1", "true", "t", "yes", "y"):
        return True
    if low in ("0", "false", "f", "no", "n"):
        return False
    raise argparse.ArgumentTypeError(f"not a boolean: {text!r}")


def _bool_flag(p: argparse.ArgumentParser, name: str, default, help: str):
    """absl's boolean spellings: --name, --name=true|false, --noname."""
    p.add_argument(f"--{name}", dest=name, nargs="?", const=True,
                   default=default, type=_parse_bool, help=help)
    p.add_argument(f"--no{name}", dest=name, action="store_false",
                   help=argparse.SUPPRESS)


def build_parser() -> argparse.ArgumentParser:
    from dist_mnist_tpu_torch.data.datasets import default_data_dir

    p = argparse.ArgumentParser(
        prog="python -m dist_mnist_tpu_torch.cli.train",
        description="Train a config on a GPU (or the CPU with "
                    "--device=cpu); one rank of a group with "
                    "--num_processes (see cli.launch).")
    a = p.add_argument
    # -- reference-parity flags (SURVEY.md §0.1 flag table)
    a("--data_dir", default=str(default_data_dir()),
      help="dataset directory (IDX files; the synthetic twin is cached "
           "there)")
    _bool_flag(p, "download_only", False,
               "materialize the dataset (synthetic twin) then exit")
    a("--job_name", default="", help="IGNORED: no ps/worker jobs")
    a("--task_index", type=int, default=0, help="IGNORED")
    a("--num_gpus", type=int, default=0, help="IGNORED: one device")
    a("--train_steps", type=int, default=None,
      help="global steps (None = config value)")
    a("--batch_size", type=int, default=None,
      help="GLOBAL batch size (None = config)")
    a("--learning_rate", type=float, default=None,
      help="LR (None = config value)")
    a("--hidden_units", type=int, default=None,
      help="MLP hidden width (mlp model only)")
    _bool_flag(p, "sync_replicas", True,
               "always True; False warns (async PS is out of model)")
    a("--replicas_to_aggregate", type=int, default=None,
      help="k > 1: accumulate k steps' gradients per update "
           "(optim/sync.py; None = config)")
    _bool_flag(p, "existing_servers", False, "IGNORED: no servers to reuse")
    a("--ps_hosts", default="", help="IGNORED: no parameter servers")
    a("--worker_hosts", default="", help="IGNORED: workers = mesh ranks")
    # -- framework flags
    a("--config", default="mlp_mnist", help="config name (see configs.py)")
    a("--device", default="cuda",
      help="cuda (default; fails without a GPU) or cpu; a rank of a group "
           "takes cuda:(rank %% cards)")
    a("--platform", default=None, choices=["cpu", "gpu"],
      help="cpu: every rank on the CPU, gloo collectives (the reference's "
           "flag; --device=cpu for one process); gpu = the default")
    a("--checkpoint_dir", default=None,
      help="checkpoint directory (None = off)")
    a("--logdir", default=None, help="metrics/profile output directory")
    _bool_flag(p, "profile", False,
               "trace a window of steps (torch.profiler) to logdir")
    a("--remat_policy", default=None,
      help="remat policy override when the config sets remat: "
           "dots_no_batch | save_attn | dots | nothing (train/step.py "
           "REMAT_POLICIES)")
    a("--eval_every", type=int, default=None,
      help="eval cadence in steps; 0 disables (None = config value)")
    a("--log_every", type=int, default=None,
      help="log/summary cadence in steps")
    a("--input_pipeline", default="python",
      choices=["python", "native", "device", "device_sharded"],
      help="python (host batcher) | native (the C++ batcher, "
           "data/native) | device (dataset resident on the device, sampled "
           "in the step) | device_sharded (1/N of the rows on each rank)")
    a("--prefetch_depth", type=int, default=2,
      help="batches the host paths copy ahead on a side CUDA stream "
           "(data/prefetch.py); 0 = synchronous feed")
    a("--runahead", type=int, default=0,
      help="wait on the k-th oldest in-flight step before dispatching the "
           "next; 0 = unbounded")
    a("--max_recoveries", type=int, default=3,
      help="preemption restore attempts (needs checkpoint_dir)")
    a("--max_restore_fallbacks", type=int, default=1,
      help="older steps restore may fall back to when the latest is "
           "unreadable (each bad step quarantined); 0 = strict")
    a("--scan_chunk", type=int, default=0,
      help="N steps per loop call (needs --input_pipeline=device); hooks "
           "fire per chunk; 0 = one step per call")
    a("--journal", default=None,
      help="append-only JSONL run-journal path; defaults to "
           "$DIST_MNIST_TPU_JOURNAL, else <logdir>/events.jsonl")
    a("--checkpoint_every_steps", type=int, default=0,
      help="checkpoint cadence in STEPS; 0 = the config's "
           "checkpoint_every_secs")
    a("--span_steps", type=int, default=0,
      help="every N steps, journal one `span` event per phase; 0 = off")
    # -- the process group and the mesh (cluster/)
    a("--mesh", default=None,
      help='mesh override, e.g. "data=2", "data=2,model=2" or '
           '"data=1,seq=2", "pipe=4" (data x model x seq x pipe ranks)')
    a("--coordinator_address", default=None, help="host:port of process 0")
    a("--num_processes", type=int, default=1, help="total processes")
    a("--process_id", type=int, default=0, help="this process's rank")
    a("--sharding", default=None,
      help="dp | fsdp | tp | fsdp_tp (None = config)")
    # -- refused: their subsystems are not in the port yet
    a("--host_device_count", type=int, default=None,
      help="refused: one device per process")
    _bool_flag(p, "overlap", None, _RESILIENCE)
    a("--overlap_bucket_mb", type=float, default=None, help=_RESILIENCE)
    a("--overlap_chunk", default=None, help=_RESILIENCE)
    a("--prng_impl", default=None,
      help=f"only {DEFAULT_PRNG_IMPL} (one torch.Generator)")
    a("--fault_plan", default=None, help=_RESILIENCE)
    a("--compile_cache_dir", default=None, help=_RESILIENCE)
    a("--elastic_batch_policy", default=None, help=_RESILIENCE)
    a("--elastic_baseline_devices", type=int, default=0, help=_RESILIENCE)
    _bool_flag(p, "async_snapshot", False, _RESILIENCE)
    a("--snapshot_window", type=int, default=None, help=_RESILIENCE)
    a("--snapshot_policy", default=None, help=_RESILIENCE)
    a("--peer_dir", default=None, help=_RESILIENCE)
    a("--metrics_port", type=int, default=0, help=_TELEMETRY)
    _bool_flag(p, "anomaly", False, _TELEMETRY)
    a("--anomaly_every", type=int, default=None, help=_TELEMETRY)
    a("--tuned", default="auto", choices=["auto", "off", "require"],
      help=f"auto/off: no store to consult; require: {_TUNING}")
    a("--tuned_dir", default=None, help=_TUNING)
    return p


def _refused_flags(args) -> list[str]:
    """One message per flag whose subsystem the port does not have."""
    out = []

    def no(cond: bool, flag: str, item: str):
        if cond:
            out.append(f"{flag} joins the port with {item}")

    if args.host_device_count is not None:
        out.append("--host_device_count: the port runs one device per "
                   "process (a stated departure of ROADMAP §1 item 12's "
                   "data-parallel half); start more processes with "
                   "cli.launch")
    no(args.overlap_bucket_mb is not None, "--overlap_bucket_mb",
       _RESILIENCE)
    no(args.overlap_chunk is not None, "--overlap_chunk", _RESILIENCE)
    no(args.fault_plan is not None, "--fault_plan", _RESILIENCE)
    no(args.compile_cache_dir is not None, "--compile_cache_dir",
       _RESILIENCE)
    no(args.elastic_batch_policy is not None, "--elastic_batch_policy",
       _RESILIENCE)
    no(args.elastic_baseline_devices != 0, "--elastic_baseline_devices",
       _RESILIENCE)
    no(bool(args.async_snapshot), "--async_snapshot", _RESILIENCE)
    no(args.snapshot_window is not None, "--snapshot_window", _RESILIENCE)
    no(args.snapshot_policy is not None, "--snapshot_policy", _RESILIENCE)
    no(args.peer_dir is not None, "--peer_dir", _RESILIENCE)
    no(args.metrics_port != 0, "--metrics_port", _TELEMETRY)
    no(bool(args.anomaly), "--anomaly", _TELEMETRY)
    no(args.anomaly_every is not None, "--anomaly_every", _TELEMETRY)
    no(args.tuned == "require", "--tuned=require (the tuned store)",
       _TUNING)
    no(args.tuned_dir is not None, "--tuned_dir", _TUNING)
    return out


def _apply_flag_overrides(cfg, args):
    """The config with the flags' overrides; `check_config` then refuses
    what the port lacks."""
    import dataclasses

    from dist_mnist_tpu_torch.cluster.mesh import MeshSpec

    over = {}
    for name, field in (("train_steps", "train_steps"),
                        ("batch_size", "batch_size"),
                        ("learning_rate", "learning_rate"),
                        ("eval_every", "eval_every"),
                        ("log_every", "log_every"),
                        ("replicas_to_aggregate", "replicas_to_aggregate"),
                        ("prng_impl", "prng_impl"),
                        ("sharding", "sharding_rules"),
                        ("overlap", "overlap")):
        if getattr(args, name) is not None:
            over[field] = getattr(args, name)
    if args.mesh:
        kv = dict(part.split("=") for part in args.mesh.split(","))
        over["mesh"] = MeshSpec(**{k: int(v) for k, v in kv.items()})
    if args.hidden_units is not None:
        over["model_kwargs"] = {**cfg.model_kwargs,
                                "hidden_units": args.hidden_units}
    if args.sharding:
        # validate EAGERLY: an unknown name exits before any work
        from dist_mnist_tpu_torch.parallel.sharding import resolve_rules

        resolve_rules(args.sharding)
    if args.remat_policy:
        # validate EAGERLY: resolve_remat_policy otherwise only runs when
        # remat=True, so a typo'd policy on a non-remat config would pass
        # silently and the user would believe it was applied
        from dist_mnist_tpu_torch.train.step import resolve_remat_policy

        resolve_remat_policy(args.remat_policy)
        over["remat_policy"] = args.remat_policy
    return dataclasses.replace(cfg, **over) if over else cfg


def main(argv=None):
    """Parse flags and train; returns ``(state, final_eval, ctx)`` (None
    after --download_only). Refused flags, a missing card and bad flag
    combinations exit with ``error: ...``."""
    from dist_mnist_tpu_torch.cluster import coordination
    from dist_mnist_tpu_torch.configs import get_config
    from dist_mnist_tpu_torch.data.datasets import load_dataset
    from dist_mnist_tpu_torch.faults.preemption import (
        PreemptionNotice,
        install_preemption_handlers,
    )
    from dist_mnist_tpu_torch.obs import events as events_mod
    from dist_mnist_tpu_torch.utils.device import resolve_device

    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s",
    )
    refused = _refused_flags(args)
    if refused:
        raise SystemExit("error: " + "; ".join(refused))
    for name in ("job_name", "ps_hosts", "worker_hosts"):
        if getattr(args, name):
            log.warning(
                "--%s is a parameter-server-era flag; this framework runs "
                "one program on every rank of a mesh (no ps/worker jobs); "
                "it is ignored.", name)
    for name in ("task_index", "num_gpus"):
        if getattr(args, name):
            log.warning("--%s is a parameter-server-era flag; it is "
                        "ignored.", name)
    if args.existing_servers:
        log.warning("--existing_servers is a parameter-server-era flag; "
                    "there are no servers to reuse; it is ignored.")
    if not args.sync_replicas:
        log.warning(
            "--nosync_replicas requested: async parameter-server training "
            "is out of model (SURVEY.md §2.6); training proceeds "
            "synchronously.")
    if args.scan_chunk and not args.input_pipeline.startswith("device"):
        raise SystemExit("error: --scan_chunk needs --input_pipeline=device "
                         "(a host batcher cannot feed a multi-step chunk)")
    cpu = args.platform == "cpu" or args.device == "cpu"
    try:
        cfg = _apply_flag_overrides(get_config(args.config), args)
        check_config(cfg)
        if args.download_only:
            device = None
        elif args.num_processes > 1:
            device = None  # the rank's, once it has joined the group
        else:
            device = resolve_device("cpu" if cpu else args.device)
    except (RuntimeError, KeyError, ValueError, NotImplementedError,
            TypeError) as err:
        raise SystemExit(f"error: {err}") from None
    if args.download_only:
        ds = load_dataset(cfg.dataset, args.data_dir, seed=cfg.seed)
        log.info("dataset %s ready (%d train / %d test, synthetic=%s)",
                 ds.name, len(ds.train_labels), len(ds.test_labels),
                 ds.synthetic)
        return None
    try:
        ctx = coordination.initialize_distributed(
            args.coordinator_address, args.num_processes, args.process_id,
            platform="cpu" if cpu else None)
    except (RuntimeError, ValueError) as err:
        raise SystemExit(f"error: {err}") from None
    if ctx is not None:
        device = ctx.device
    # journal precedence: explicit flag > supervisor-injected env >
    # <logdir>/events.jsonl
    journal = args.journal or os.environ.get(events_mod.ENV_JOURNAL)
    generation = int(os.environ.get(events_mod.ENV_GENERATION, "0"))
    # the handshake is installed before the expensive work: a SIGTERM
    # that lands during setup is honored at the first step boundary
    notice = PreemptionNotice()
    uninstall = install_preemption_handlers(notice)
    try:
        state, final, ctx = run_config(
            cfg,
            device=device,
            data_dir=args.data_dir,
            checkpoint_dir=args.checkpoint_dir,
            logdir=args.logdir,
            profile=args.profile,
            max_recoveries=args.max_recoveries if args.checkpoint_dir else 0,
            input_pipeline=args.input_pipeline,
            scan_chunk=args.scan_chunk,
            prefetch_depth=args.prefetch_depth,
            runahead=args.runahead,
            preemption=notice,
            max_restore_fallbacks=args.max_restore_fallbacks,
            journal=journal,
            generation=generation,
            checkpoint_every_steps=args.checkpoint_every_steps,
            span_steps=args.span_steps,
        )
    except (NotImplementedError, ValueError) as err:
        raise SystemExit(f"error: {err}") from None
    finally:
        uninstall()
        coordination.shutdown()
    if ctx.get("preempted_at") is not None:
        # the marker line supervisors and tests key on; the exit code stays
        # 0 — a preempted-but-checkpointed run is a success
        log.warning("preempted@step=%d — checkpoint saved, clean shutdown",
                    ctx["preempted_at"])
    return state, final, ctx


if __name__ == "__main__":
    main()
