"""Serving entry point: build a servable model, start the inference server,
drive it with the deterministic load generator, print a latency/batching
summary as JSON (port of the reference `cli/serve.py`: its default mode
and `--decode`).

    python -m dist_mnist_tpu_torch.cli.serve --config=lenet5_mnist \\
        --quant=int8 --max_batch 64 --requests 512 --concurrency 64
    python -m dist_mnist_tpu_torch.cli.serve --config=vit_tiny_cifar \\
        --seq_buckets=auto --max_batch 32
    python -m dist_mnist_tpu_torch.cli.serve --decode --requests 64 \\
        --concurrency 16

The classifier engine comes from `serve/zoo.build_zoo_engine`:
`--seq_buckets` adds the height axis of its grid for a model that can
mask tokens (the ViT; other models keep the native-only grid, with a
warning), and the summary then carries `seq_buckets` and
`seq_bucket_counts`. `--moe_capacity_factor` serves an MoE checkpoint
(`vit_tiny_cifar_moe`) at another expert capacity than it trained with,
all experts local on the one device; the summary then carries the
routed drop fraction's mean and maximum over the served batches.

`--decode` serves a registry causal LM (`--decode_model`, default
`causal_tiny` at its registry defaults: dense cache) through the
prefill/decode split with continuous batching (`--decode_mode`), drives
it with the seeded decode loadgen and prints the TTFT/throughput
summary; `--config` and `--quant` do not apply there.

`--decode --mesh=model=M` serves it tensor-parallel, the KV cache's
heads split over M ranks. The reference drives M devices from one
process; the port runs a process per device (a stated departure), so
this command spawns M ranks of itself through `cli/launch.py` (the same
spawn, ``[pK]`` log prefix and tear-down): rank 0 runs the scheduler
and the loadgen and prints the summary, the others follow its engine
calls (`serve/decode.DecodeEngine.follow`). With `--device=cpu` the
ranks run on the CPU over gloo.

Without `--decode`, `--mesh=data=D,model=M` serves the classifier
resident-sharded over D x M ranks, spawned the same way:
`--serve_rules=dp|fsdp|tp|fsdp_tp` places the weights (default the
config's training strategy; a checkpoint trained under one re-lands in
another's layout), a bucket's rows split over ``data``, and rank 0 runs
the server, the batcher and the loadgen while the others follow its
cells (`serve/engine.InferenceEngine.follow`). Each rank logs its kernel
launches and the cells it ran, and its resident bytes. `--quant` over
more than one rank refuses (ROADMAP §1 item 12's rest).

Telemetry (`obs/`): `--metrics_port=P` serves the live serve ladders
(latency, batch size and occupancy; decode's TTFT, tokens/s and active
slots) on ``http://127.0.0.1:P/metrics``, the process's `HealthState` on
``/healthz`` (``serving`` while the server runs, then ``draining`` and
503 ``stopped``) and the journal's tail on ``/events``; a port already
taken logs a warning and serving goes on. `--journal` (default
``$DIST_MNIST_TPU_JOURNAL``, else ``<logdir>/events.jsonl``) records
``serve_start``/``serve_stop``, the engine's first runs
(``compile_cache``) and decode's ``decode_*`` and ``kv_page_*`` events;
`--logdir` gets the final serve metrics (CSV, TensorBoard). Over
`--mesh`, the chief serves the endpoint.

`--compile_cache_dir=DIR` sends the serving kernels' libraries
(`quant_matmul`, the flash forwards, `paged_attention`) through the store
under DIR (`compilecache/store.py`; every spawned rank too), and the
summary gains the store's `compile_cache` stats.

Runs on the CUDA device by default and exits with an error when there is
none; `--device=cpu` runs the plain CPU path. Weights are those of a
committed step under `--checkpoint_dir` (`--step`, default the latest;
the summary's `checkpoint_step` and `restored` say which), or a fresh
init seeded from the config.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os

import torch

from dist_mnist_tpu_torch.configs import get_config
from dist_mnist_tpu_torch.serve import (
    DecodeScheduler,
    InferenceServer,
    ServeConfig,
    build_decode_engine,
    build_zoo_engine,
    load_for_serving,
    run_decode_loadgen,
    run_loadgen,
)
from dist_mnist_tpu_torch.utils.device import resolve_device

log = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m dist_mnist_tpu_torch.cli.serve",
        description="Serve a classifier config and drive it with the "
                    "closed-loop load generator.")
    p.add_argument("--config", default="mlp_mnist",
                   help="config name (see configs.py)")
    p.add_argument("--quant", default=None, choices=["int8"],
                   help="weight-only int8 serving: dense/conv kernels become "
                        "(int8, f32 per-channel scale) at load time and "
                        "every quantized dense layer runs the quant_matmul "
                        "CUDA kernel; unset = full-width float serving")
    p.add_argument("--checkpoint_dir", default=None,
                   help="checkpoint directory to serve from (None = a "
                        "fresh init seeded from the config)")
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step (None = latest)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a GPU) or cpu")
    p.add_argument("--max_batch", type=int, default=64,
                   help="coalesce ceiling (requests per batch)")
    p.add_argument("--max_wait_ms", type=float, default=2.0,
                   help="coalesce window after the first request")
    p.add_argument("--queue_depth", type=int, default=256,
                   help="admission queue bound")
    p.add_argument("--deadline_ms", type=float, default=0,
                   help="per-request deadline; 0 = none")
    p.add_argument("--prewarm", action=argparse.BooleanOptionalAction,
                   default=True, help="run every (batch, height) cell once "
                                      "before serving")
    p.add_argument("--seq_buckets", default=None,
                   help='variable-length serving: "auto" for the '
                        "power-of-two height ladder, \"h1,h2,...\" for "
                        "explicit bucket ceilings (native appended), unset "
                        "for the native-only engine. Shorter requests are "
                        "right-padded and masked; the native bucket keeps "
                        "the maskless program (serve/zoo.py)")
    p.add_argument("--moe_capacity_factor", type=float, default=0,
                   help="inference-time MoE expert capacity factor; 0 = "
                   "the checkpoint's train-time factor. Overflow drops "
                   "surface as the summary's moe drop fraction, never "
                   "silently")
    p.add_argument("--decode", action="store_true",
                   help="autoregressive decode mode: serve a registry "
                        "causal LM through the prefill/decode split with "
                        "continuous batching, drive it with the seeded "
                        "decode loadgen, print the TTFT/throughput summary")
    p.add_argument("--decode_mode", default="continuous",
                   choices=["continuous", "static"],
                   help="decode scheduling: admit between steps, or the "
                        "drain-the-whole-batch baseline")
    p.add_argument("--max_slots", type=int, default=8,
                   help="in-flight sequence capacity in --decode mode")
    p.add_argument("--decode_model", default="causal_tiny",
                   help="models/registry.py name of the causal LM to serve "
                        "in --decode mode")
    p.add_argument("--requests", type=int, default=512,
                   help="loadgen request count")
    p.add_argument("--concurrency", type=int, default=64,
                   help="loadgen in-flight window")
    p.add_argument("--seed", type=int, default=0, help="loadgen input seed")
    p.add_argument("--mesh", default=None,
                   help='"data=D,model=M": serve over D x M ranks, spawned '
                        "by this command (--decode: model=M only, "
                        "head-sharded)")
    p.add_argument("--serve_rules", default=None,
                   help="serve-time placement over --mesh: dp | fsdp | tp | "
                        "fsdp_tp (None = the config's training strategy)")
    # set by the spawning command on each rank (cli/launch.py)
    p.add_argument("--coordinator_address", default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--num_processes", type=int, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--process_id", type=int, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--platform", default=None, help=argparse.SUPPRESS)
    p.add_argument("--compile_cache_dir", default=None,
                   help="store for the built kernel libraries "
                        "(compilecache/): a warm process loads what a cold "
                        "one built")
    # -- telemetry (obs/)
    p.add_argument("--logdir", default=None,
                   help="serve-metrics output directory")
    p.add_argument("--metrics_port", type=int, default=0,
                   help="serve /metrics (Prometheus text, incl. the live "
                        "latency/batch histograms), /healthz (serving -> "
                        "draining -> stopped) and /events on this port "
                        "(obs/exporter.py); 0 = off")
    p.add_argument("--journal", default=None,
                   help="append-only JSONL run-journal path (obs/events.py); "
                        "defaults to $DIST_MNIST_TPU_JOURNAL, else "
                        "<logdir>/events.jsonl when --logdir is set")
    return p


@contextlib.contextmanager
def telemetry(args):
    """The serving run's telemetry: yields ``(registry, health)``, a
    `MetricRegistry` and a `HealthState`, with the run journal installed
    (`--journal`, ``$DIST_MNIST_TPU_JOURNAL`` or ``<logdir>/events.jsonl``)
    and, on the chief with `--metrics_port`, the exporter serving both
    (a taken port warns and serving goes on). Both close on exit."""
    from dist_mnist_tpu_torch.obs import (
        HealthState,
        MetricRegistry,
        MetricsExporter,
        RunJournal,
    )
    from dist_mnist_tpu_torch.obs import events as events_mod

    registry = MetricRegistry()
    health = HealthState(
        generation=int(os.environ.get(events_mod.ENV_GENERATION, "0")))
    journal_path = (args.journal or os.environ.get(events_mod.ENV_JOURNAL)
                    or (args.logdir and f"{args.logdir}/events.jsonl"))
    journal = (RunJournal(journal_path, generation=health.generation)
               if journal_path else None)
    prev = events_mod.set_journal(journal) if journal is not None else None
    exporter = None
    if args.metrics_port and not args.process_id:
        try:
            exporter = MetricsExporter(
                registry, health=health, journal_path=journal_path,
                port=args.metrics_port,
                info={"host_id": os.environ.get(events_mod.ENV_HOST_ID, "0"),
                      "generation": str(health.generation),
                      "role": "serve"},
            ).start()
        except OSError as e:
            log.warning("metrics exporter: could not bind port %d (%s); "
                        "continuing without exposition", args.metrics_port,
                        e)
    try:
        yield registry, health
    finally:
        if exporter is not None:
            exporter.close()
        if journal is not None:
            events_mod.set_journal(prev)
            journal.close()


def _mesh_axes(args) -> dict:
    """``{axis: ranks}`` of `--mesh` ({} without it)."""
    if not args.mesh:
        return {}
    return {k: int(v) for k, v in (part.split("=")
                                   for part in args.mesh.split(","))}


def _mesh_ranks(args) -> int:
    """The ranks `--mesh` asks for (1 without it); refuses what the
    engine cannot shard."""
    axes = _mesh_axes(args)
    if not axes:
        return 1
    if not args.decode:
        spec = _zoo_spec(axes)
        if args.quant and spec.data * spec.model > 1:
            raise SystemExit(
                "error: --quant over more than one rank joins the port with "
                "ROADMAP §1 item 12's rest (a row-parallel slice's "
                "per-channel scales are not the whole leaf's)")
        return spec.data * spec.model
    extra = {k: v for k, v in axes.items()
             if k != "model" and v not in (1, -1)}
    if extra:
        raise SystemExit(
            f"error: --mesh {args.mesh}: decode serving splits heads over "
            "the model axis only (replicas behind a router join with "
            "ROADMAP §1 item 15)")
    return axes.get("model", 1)


def _zoo_spec(axes: dict):
    """The classifier mesh of `--mesh`'s axes: data and model only."""
    from dist_mnist_tpu_torch.cluster.mesh import MeshSpec

    extra = {k: v for k, v in axes.items()
             if k not in ("data", "model") and v not in (1, -1)}
    if extra:
        raise SystemExit(
            f"error: --mesh {axes}: the zoo serves over the data and model "
            "axes (a seq or pipe axis shards a training step)")
    data = axes.get("data", 1)
    return MeshSpec(data=1 if data == -1 else data,
                    model=axes.get("model", 1))


def _run_decode(args, device, mesh=None, *, registry=None,
                health=None) -> dict | None:
    """Decode mode: the LM engine and its continuous-batching scheduler,
    every grid cell run once before traffic (`--prewarm`), the seeded
    decode loadgen, the TTFT/throughput summary. On a tensor-parallel
    `mesh` the chief does that and the other ranks follow its engine
    calls (None there). The scheduler's ladders go on `registry`, its
    final metrics to `--logdir`; `health` reads ``serving`` from the
    end of the prewarm to the scheduler's close."""
    from dist_mnist_tpu_torch.obs.writers import make_default_writer

    engine = build_decode_engine(device, model_name=args.decode_model,
                                 seed=args.seed, max_slots=args.max_slots,
                                 mesh=mesh)
    if engine.is_follower:
        calls = engine.follow()
        log.info("follower rank %d ran %d engine calls, %d decode steps",
                 mesh.model_index, calls, engine.decode_steps)
        return None
    try:
        if args.prewarm:
            engine.prewarm()
        writer = make_default_writer(args.logdir, registry=registry)
        scheduler = DecodeScheduler(engine, mode=args.decode_mode,
                                    max_queue=args.queue_depth,
                                    writer=writer)
        if registry is not None:
            # live TTFT/throughput/occupancy ladders on /metrics
            scheduler.metrics.attach_to(registry)
        if health is not None:
            health.set("serving")
        try:
            summary = run_decode_loadgen(scheduler,
                                         n_requests=args.requests,
                                         concurrency=args.concurrency,
                                         seed=args.seed)
        finally:
            if health is not None:
                health.set("draining")
            scheduler.close()
            writer.close()
            if health is not None:
                health.set("stopped")
    finally:
        engine.close()
    summary.pop("token_times", None)
    summary["max_slots"] = args.max_slots
    summary["model"] = args.decode_model
    summary["decode_steps"] = engine.decode_steps
    summary["kv"] = engine.kv_stats()
    if mesh is not None:
        summary["mesh"] = {"model": mesh.model}
        summary["rank_kv_bytes"] = engine.rank_kv_bytes
    return summary


def _spawn_ranks(argv: list[str], args, ranks: int) -> int:
    """Run this command on `ranks` processes (`cli/launch.py`'s spawn);
    their exit status."""
    from dist_mnist_tpu_torch.cli.launch import launch

    return launch(ranks, list(argv), module="dist_mnist_tpu_torch.cli.serve",
                  platform="cpu" if args.device == "cpu" else None)


def _run_rank(args, registry, health) -> dict | None:
    """One rank of a sharded server: the decode engine's heads, or the
    classifier zoo's shards; the summary on the chief, None elsewhere."""
    from dist_mnist_tpu_torch.cluster import coordination
    from dist_mnist_tpu_torch.cluster.mesh import MeshSpec, make_mesh

    ctx = coordination.initialize_distributed(
        args.coordinator_address, args.num_processes, args.process_id,
        platform=args.platform)
    try:
        spec = (MeshSpec(data=1, model=args.num_processes) if args.decode
                else _zoo_spec(_mesh_axes(args)))
        mesh = make_mesh(spec, device=ctx.device if ctx is not None
                         else None)
        log.info("%s", coordination.startup_line(ctx))
        if args.decode:
            return _run_decode(args, mesh.device, mesh, registry=registry,
                               health=health)
        return serve_classifier(args, mesh.device, mesh, registry=registry,
                                health=health)
    finally:
        coordination.shutdown()


def serve_classifier(args, device, mesh=None, *, loadgen=None,
                     registry=None, health=None) -> dict | None:
    """The classifier mode: the bundle (sharded by `--serve_rules` on a
    `mesh` of several ranks), the zoo engine, the server and the seeded
    loadgen (`loadgen(server, n_requests=, concurrency=, seed=)`, default
    `run_loadgen` at the native image shape); the summary JSON's dict on
    the chief, None on a follower rank, which runs the chief's cells
    until it closes the engine. Every rank logs the kernel launches and
    the cells it ran. The server's ladders go on `registry` (None = a
    registry of its own), its `health` and final metrics (`--logdir`)
    through the server."""
    from dist_mnist_tpu_torch.obs.writers import make_default_writer
    from dist_mnist_tpu_torch.ops.kernels import launch_counts

    cfg = get_config(args.config)
    bundle = load_for_serving(cfg, device, quant=args.quant,
                              checkpoint_dir=args.checkpoint_dir,
                              step=args.step, mesh=mesh,
                              sharding_rules=args.serve_rules)
    engine = build_zoo_engine(
        bundle, device, model_name=cfg.model,
        max_bucket=max(args.max_batch, 1),
        seq_buckets=args.seq_buckets or None,
        moe_capacity_factor=args.moe_capacity_factor or None)
    state_bytes = engine.state_bytes_per_device()
    log.info("resident serve state per rank: %s",
             json.dumps(state_bytes, sort_keys=True))

    def log_rank():
        log.info("kernel launches: %s",
                 json.dumps(launch_counts(), sort_keys=True))
        log.info("served cells: %s",
                 json.dumps(engine.runs_per_cell(), sort_keys=True))

    if engine.is_follower:
        log.info("follower ran %d cells", engine.follow())
        log_rank()
        return None
    if loadgen is None:
        def loadgen(server, **kw):
            return run_loadgen(server, image_shape=bundle.image_shape, **kw)
    writer = make_default_writer(args.logdir, registry=registry)
    server = InferenceServer(engine, ServeConfig(
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        queue_depth=args.queue_depth,
        default_deadline_ms=args.deadline_ms or None,
        prewarm=args.prewarm,
    ), writer=writer, health=health)
    if registry is not None:
        # live full-distribution exposition of the serve ladders (/metrics)
        server.metrics.attach_to(registry)
    try:
        with server:
            summary = loadgen(server, n_requests=args.requests,
                              concurrency=args.concurrency, seed=args.seed)
            stats = server.stats()
    finally:
        engine.close()
        writer.close()
    log_rank()
    for key in ("mean_moe_drop_fraction", "max_moe_drop_fraction"):
        if key in stats:
            summary[key] = stats[key]
    if args.moe_capacity_factor:
        summary["moe_capacity_factor"] = args.moe_capacity_factor
    summary["checkpoint_step"] = bundle.step
    summary["restored"] = bundle.restored
    summary["serve_state_bytes_per_device"] = state_bytes
    summary["cells"] = engine.runs_per_cell()
    if mesh is not None and mesh.ranks > 1:
        from dist_mnist_tpu_torch.parallel.sharding import rules_name

        summary["mesh"] = {k: v for k, v in mesh.shape.items() if v > 1}
        summary["serve_rules"] = rules_name(bundle.rules)
    if bundle.quant:
        summary["quant"] = bundle.quant
        summary["quant_error_max"] = bundle.quant_report["max_abs_err"]
        summary["quant_rel_err_max"] = bundle.quant_report["max_rel_err"]
        summary["quant_leaves"] = bundle.quant_report["n_quantized"]
    if engine.seq_grid is not None:
        summary["seq_buckets"] = list(engine.seq_grid.heights)
        summary["seq_bucket_counts"] = {
            str(k): v for k, v in sorted(engine.seq_bucket_counts.items())}
    return summary


def main(argv=None) -> dict | None:
    import sys

    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s",
    )
    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        raise SystemExit(f"error: {err}") from None
    device_name = (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu")
    ranks = _mesh_ranks(args)
    if ranks > 1 and args.num_processes is None:
        rc = _spawn_ranks(argv, args, ranks)
        if rc:
            raise SystemExit(rc)
        return None
    from dist_mnist_tpu_torch.compilecache.store import persistent_cache

    with persistent_cache(args.compile_cache_dir) as cache, \
            telemetry(args) as (registry, health):
        if args.num_processes and args.num_processes > 1:
            summary = _run_rank(args, registry, health)
        elif args.decode:
            summary = _run_decode(args, device, registry=registry,
                                  health=health)
        else:
            summary = serve_classifier(args, device, registry=registry,
                                       health=health)
    if summary is None:
        return None
    if cache is not None:
        summary["compile_cache"] = cache.stats()
    summary["device"] = device_name
    print(json.dumps(summary, indent=2, sort_keys=True))
    return summary


if __name__ == "__main__":
    main()
