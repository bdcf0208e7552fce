"""Fleet-router entry point: N serving replicas behind one
`serve/router.py` Router, driven with two-class traffic (port of the
reference `cli/router.py`).

    python -m dist_mnist_tpu_torch.cli.router --config=mlp_mnist \\
        --replicas=3 --checkpoint_dir=/tmp/ckpt --watch

Two fleet shapes:

- ``--inprocess`` (default): replicas are `InProcessReplica`s in this
  process on the one device, sharing one `CompiledModelCache` (the
  warmed cells take the weights as arguments, so the fleet runs each
  cell's first run once). Fast to stand up; what tests and the bench use.
- ``--noinprocess``: each replica is a spawned `cli/serve.py
  --serve_forever` child on its own port (on the same device: every
  child takes the card, or the CPU with `--device=cpu`), reached through
  `HttpReplica` (POST /predict, /swap; probed over /healthz). A
  `FleetScraper` (obs/fleet.py) scrapes every replica's /metrics and
  merges them onto THIS process's exporter, so one scrape shows the
  whole serving fleet.

Either way the router gives SLO-tiered admission, health-probe routing,
retry/hedge/failover, and — with ``--watch`` — the zero-downtime weight
roll driven by the training run's commit markers. ``--quant=int8`` goes
to every replica (a roll re-quantizes the new step). ``--autoscale``
runs the `serve/autoscale.py` control loop over an in-process fleet;
``--trace`` replays an open-loop arrival schedule instead of the
closed-loop loadgen. The summary JSON is printed at the end.

Runs on the CUDA device by default and exits with an error when there is
none; `--device=cpu` runs the plain CPU path.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import subprocess
import sys
import time
import urllib.request
from contextlib import nullcontext
from pathlib import Path

log = logging.getLogger(__name__)

#: the repo's root: the children run `python -m dist_mnist_tpu_torch...`
#: from there
ROOT = Path(__file__).resolve().parents[2]

# leak registry for the tests: spawned replica children still alive after
# a run are leaks (cli/launch.py keeps the same list of its children)
_LIVE_REPLICA_PROCS: list = []

#: seconds a spawned child has to reach ``serving`` (import, CUDA
#: bring-up, the kernels' build or load and the prewarm)
SPAWN_BUDGET_S = 300.0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m dist_mnist_tpu_torch.cli.router",
        description="N classifier serving replicas behind one fleet router, "
                    "driven with two-class traffic.")
    p.add_argument("--config", default="mlp_mnist",
                   help="config name (see configs.py)")
    p.add_argument("--checkpoint_dir", default=None,
                   help="checkpoint directory to serve from (and to watch "
                        "for commit markers with --watch); None = fresh "
                        "init")
    p.add_argument("--step", type=int, default=None,
                   help="initial checkpoint step (None = latest)")
    p.add_argument("--replicas", type=int, default=3, help="fleet size")
    p.add_argument("--inprocess", dest="inprocess", action="store_true",
                   default=True,
                   help="in-process replicas sharing one cell cache "
                        "(default)")
    p.add_argument("--noinprocess", dest="inprocess", action="store_false",
                   help="spawn cli/serve.py --serve_forever children "
                        "reached over HTTP")
    p.add_argument("--mesh", default=None,
                   help='a sharded replica, e.g. "data=2": forwarded to '
                        "each --noinprocess child (its own ranks); "
                        "in-process replicas share the one device")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a GPU) or cpu, for "
                        "this process and every replica")
    # -- per-replica serving policy
    p.add_argument("--max_batch", type=int, default=64,
                   help="coalesce ceiling (requests per batch)")
    p.add_argument("--max_wait_ms", type=float, default=2.0,
                   help="coalesce window after the first request")
    p.add_argument("--queue_depth", type=int, default=256,
                   help="per-replica admission bound")
    p.add_argument("--compile_cache_dir", default=None,
                   help="compilecache/ directory of the built kernel "
                        "libraries, shared by the fleet (and every child)")
    # -- model-zoo serving (serve/zoo.py; forwarded to every replica)
    p.add_argument("--seq_buckets", default=None,
                   help='variable-length serving: "auto", "h1,h2,...", or '
                        "unset for the native-only engine (cli/serve.py)")
    p.add_argument("--moe_capacity_factor", type=float, default=0,
                   help="inference-time MoE expert capacity factor; 0 = "
                        "the checkpoint's train-time factor")
    p.add_argument("--serve_memory_budget_mb", type=float, default=0,
                   help="per-device weights + warmed cells budget (MiB) "
                        "per replica engine; 0 = unbounded")
    p.add_argument("--serve_rules", default=None,
                   help="serve-time placement (cli/serve.py --serve_rules)")
    p.add_argument("--quant", default=None, choices=["int8"],
                   help="weight-only int8 serving, forwarded to every "
                        "replica (~4x smaller resident weights a replica); "
                        "a roll re-quantizes the new step")
    p.add_argument("--fault_plan", default=None,
                   help="faults/plan.py FaultPlan JSON (inline or path); "
                        "serve_replica_kill / serve_replica_stall target "
                        "replica ids, exercising failover and hedging")
    # -- router policy
    p.add_argument("--hedge_after_ms", type=float, default=0,
                   help="fixed hedge timeout for latency_sensitive "
                        "requests; 0 = derive from the live p99")
    p.add_argument("--health_interval_s", type=float, default=0.1,
                   help="replica probe cadence")
    p.add_argument("--watch", dest="watch", action="store_true",
                   default=False,
                   help="poll <checkpoint_dir>/commits and hot-swap the "
                        "fleet to each newly committed step")
    p.add_argument("--nowatch", dest="watch", action="store_false",
                   help=argparse.SUPPRESS)
    p.add_argument("--watch_interval_s", type=float, default=2.0,
                   help="commit-marker poll cadence")
    # -- autoscaling (serve/autoscale.py; in-process fleets)
    p.add_argument("--autoscale", dest="autoscale", action="store_true",
                   default=False,
                   help="run an Autoscaler over the fleet: replicas added "
                        "and removed between --min_replicas and "
                        "--max_replicas (in-process only; new replicas find "
                        "their cells warm in the shared cache)")
    p.add_argument("--noautoscale", dest="autoscale", action="store_false",
                   help=argparse.SUPPRESS)
    p.add_argument("--min_replicas", type=int, default=1,
                   help="autoscaler floor")
    p.add_argument("--max_replicas", type=int, default=8,
                   help="autoscaler ceiling")
    p.add_argument("--slo_p99_ms", type=float, default=500.0,
                   help="latency_sensitive p99 SLO the autoscaler defends")
    p.add_argument("--autoscale_interval_s", type=float, default=0.25,
                   help="control-loop tick cadence")
    # -- load generation
    p.add_argument("--trace", default=None,
                   choices=["diurnal", "burst", "flash_crowd"],
                   help="trace-driven open-loop arrivals instead of the "
                        "closed-loop loadgen")
    p.add_argument("--trace_duration_s", type=float, default=20.0,
                   help="trace length (trace seconds)")
    p.add_argument("--trace_base_rps", type=float, default=10.0,
                   help="trace baseline request rate")
    p.add_argument("--trace_peak_mult", type=float, default=10.0,
                   help="peak rate as a multiple of --trace_base_rps")
    p.add_argument("--requests", type=int, default=512,
                   help="loadgen request count")
    p.add_argument("--concurrency", type=int, default=64,
                   help="loadgen in-flight window")
    p.add_argument("--seed", type=int, default=0,
                   help="loadgen input and class seed")
    p.add_argument("--ls_fraction", type=float, default=0.8,
                   help="latency_sensitive traffic fraction")
    p.add_argument("--ls_deadline_ms", type=float, default=0,
                   help="latency_sensitive per-request deadline; 0 = none")
    p.add_argument("--be_deadline_ms", type=float, default=0,
                   help="best_effort per-request deadline; 0 = none")
    # -- observability
    p.add_argument("--metrics_port", type=int, default=0,
                   help="router-process /metrics (the fleet/ gauges and, "
                        "with --noinprocess, the scraper's merged replica "
                        "series), /healthz, /events and /fleet; 0 = off")
    p.add_argument("--journal", default=None,
                   help="append-only JSONL run-journal path "
                        "(obs/events.py): replica_up/down, shed, "
                        "weights_swap etc.")
    return p


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_one_replica(args, i: int):
    """Spawn ONE `cli/serve.py --serve_forever` child (listed in
    `_LIVE_REPLICA_PROCS` at once, so a crash between spawn and admission
    still leaves it visible to the leak check). Returns (proc, url)
    without waiting for /healthz."""
    from dist_mnist_tpu_torch.obs import events as events_mod

    port = _free_port()
    cmd = [
        sys.executable, "-m", "dist_mnist_tpu_torch.cli.serve",
        "--serve_forever", f"--config={args.config}",
        f"--metrics_port={port}", f"--replica_id={i}",
        f"--max_batch={args.max_batch}",
        f"--max_wait_ms={args.max_wait_ms}",
        f"--queue_depth={args.queue_depth}",
        f"--device={args.device}",
    ]
    for flag in ("checkpoint_dir", "step", "compile_cache_dir",
                 "seq_buckets", "moe_capacity_factor",
                 "serve_memory_budget_mb", "serve_rules", "quant",
                 "fault_plan", "mesh"):
        value = getattr(args, flag)
        if value:
            cmd.append(f"--{flag}={value}")
    env = dict(os.environ)
    env[events_mod.ENV_HOST_ID] = str(i)
    if args.journal:
        env[events_mod.ENV_JOURNAL] = args.journal
    if args.device == "cpu":
        # one intra-op thread a CPU child (cli/launch.py's rule for CPU
        # ranks): N children on one host's cores
        env.setdefault("OMP_NUM_THREADS", "1")
    proc = subprocess.Popen(cmd, env=env, cwd=str(ROOT))
    _LIVE_REPLICA_PROCS.append(proc)
    url = f"http://127.0.0.1:{port}"
    log.info("spawned replica %d (pid %d) on %s", i, proc.pid, url)
    return proc, url


def _reap_replica_proc(proc) -> None:
    """Terminate a spawned replica child and delist it from the leak
    registry: the one tear-down path, at shutdown or mid-run."""
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=5)
    if proc in _LIVE_REPLICA_PROCS:
        _LIVE_REPLICA_PROCS.remove(proc)


def _spawn_replicas(args, n: int):
    """Spawn n `cli/serve.py --serve_forever` children and wait until each
    /healthz reports serving. Returns (procs, urls, HttpReplicas); a child
    that exits or misses the budget raises (the spawned ones stay listed
    for the caller's tear-down)."""
    from dist_mnist_tpu_torch.serve import HttpReplica

    procs, urls = [], {}
    for i in range(n):
        proc, url = _spawn_one_replica(args, i)
        procs.append(proc)
        urls[i] = url
    deadline = time.monotonic() + SPAWN_BUDGET_S
    for i, proc in enumerate(procs):
        while True:
            if proc.poll() is not None:
                raise RuntimeError(
                    f"replica {i} exited rc={proc.returncode} before "
                    "serving")
            try:
                with urllib.request.urlopen(urls[i] + "/healthz",
                                            timeout=2.0) as r:
                    if json.loads(r.read()).get("state") == "serving":
                        break
            except OSError:
                pass
            if time.monotonic() > deadline:
                raise TimeoutError(f"replica {i} not serving within "
                                   f"{SPAWN_BUDGET_S:.0f} s")
            time.sleep(0.25)
    replicas = [HttpReplica(i, urls[i], capacity_hint=args.queue_depth)
                for i in sorted(urls)]
    return procs, urls, replicas


def _build_inprocess_replicas(args, n: int, device, store=None):
    """N `InProcessReplica`s on `device` over one bundle and one shared
    cell cache; returns (bundle, replicas, make_replica, shared_cache)."""
    from dist_mnist_tpu_torch.configs import get_config
    from dist_mnist_tpu_torch.obs import HealthState
    from dist_mnist_tpu_torch.serve import (
        CompiledModelCache,
        InferenceServer,
        InProcessReplica,
        ServeConfig,
        build_zoo_engine,
        load_for_serving,
    )

    cfg = get_config(args.config)
    bundle = load_for_serving(cfg, device, quant=args.quant,
                              checkpoint_dir=args.checkpoint_dir,
                              step=args.step)
    shared_cache = CompiledModelCache(store=store)
    plan = None
    if args.fault_plan:
        from dist_mnist_tpu_torch.faults import FaultPlan

        plan = FaultPlan.from_spec(args.fault_plan)

    def make_server_factory(replica_id: int, startup=None):
        # `startup` (a StartupClock, from the autoscaler): the engine and
        # weights build lands in "restore", the prewarm (memory hits of
        # the shared cache when warm) in "compile"
        def make_server():
            with (startup.phase("restore") if startup else nullcontext()):
                engine = build_zoo_engine(
                    bundle, device, model_name=cfg.model,
                    max_bucket=max(args.max_batch, 1),
                    seq_buckets=args.seq_buckets or None,
                    moe_capacity_factor=args.moe_capacity_factor or None,
                    memory_budget_mb=args.serve_memory_budget_mb or None,
                    cache=shared_cache)
                if plan is not None:
                    engine = plan.wrap_engine(engine, replica_id=replica_id)
                server = InferenceServer(
                    engine,
                    ServeConfig(max_batch=args.max_batch,
                                max_wait_ms=args.max_wait_ms,
                                queue_depth=args.queue_depth),
                    health=HealthState())
            with (startup.phase("compile") if startup else nullcontext()):
                return server.start()

        return make_server

    def load_weights(step: int):
        # quant rides the reload: the roll hands each replica an int8 tree
        # (the engine would re-quantize a float one anyway; this pays the
        # conversion once a roll, not once a replica)
        new = load_for_serving(cfg, device, quant=args.quant,
                               checkpoint_dir=args.checkpoint_dir, step=step)
        if not new.restored:
            raise FileNotFoundError(f"no committed checkpoint at step {step}")
        return new.params, new.model_state

    def make_replica(replica_id: int, startup=None):
        """Build and start one replica over the SAME bundle and shared
        cache: the autoscaler's spawn seam."""
        return InProcessReplica(
            replica_id, make_server_factory(replica_id, startup),
            load_weights=load_weights if args.checkpoint_dir else None,
        ).start()

    replicas = [make_replica(i) for i in range(n)]
    return bundle, replicas, make_replica, shared_cache


def _arrivals(args):
    from dist_mnist_tpu_torch.serve import (
        burst_trace,
        diurnal_trace,
        flash_crowd_trace,
    )

    dur, base = args.trace_duration_s, args.trace_base_rps
    peak = base * args.trace_peak_mult
    if args.trace == "diurnal":
        return diurnal_trace(duration_s=dur, base_rps=base, peak_rps=peak,
                             seed=args.seed)
    if args.trace == "burst":
        return burst_trace(duration_s=dur, base_rps=base, burst_rps=peak,
                           burst_every_s=dur / 4, burst_len_s=dur / 16,
                           seed=args.seed)
    return flash_crowd_trace(duration_s=dur, base_rps=base,
                             spike_at_s=dur * 0.3, spike_len_s=dur * 0.2,
                             spike_mult=args.trace_peak_mult,
                             seed=args.seed)


def run(args, device=None, *, on_router=None, on_done=None) -> dict:
    """The fleet run of `args`: build the fleet, start the router (and the
    autoscaler and the watcher), drive the loadgen, tear everything down;
    returns the summary. `on_router(router, replicas)` is called once the
    router serves, before the traffic, and `on_done(router, replicas,
    summary)` after it, before the tear-down (both in this thread)."""
    from dist_mnist_tpu_torch.compilecache.store import persistent_cache
    from dist_mnist_tpu_torch.configs import get_config
    from dist_mnist_tpu_torch.data.datasets import DATASETS
    from dist_mnist_tpu_torch.obs import (
        FleetScraper,
        HealthState,
        MetricRegistry,
        MetricsExporter,
        RunJournal,
    )
    from dist_mnist_tpu_torch.obs import events as events_mod
    from dist_mnist_tpu_torch.serve import (
        CheckpointWatcher,
        Router,
        RouterConfig,
        run_fleet_loadgen,
        run_trace_loadgen,
    )
    from dist_mnist_tpu_torch.utils.device import resolve_device

    if args.autoscale and not args.inprocess:
        raise SystemExit("error: --autoscale requires --inprocess (the "
                         "spawn seam shares one cell cache and device)")
    if args.watch and not args.checkpoint_dir:
        raise SystemExit("error: --watch requires --checkpoint_dir")
    if args.inprocess and args.mesh and any(
            int(part.split("=")[1]) not in (1, -1)
            for part in args.mesh.split(",")):
        raise SystemExit("error: in-process replicas share the one device; "
                         "a sharded replica is a group of processes: use "
                         "--noinprocess with --mesh")
    device = resolve_device(device if device is not None else args.device)
    registry = MetricRegistry()
    health = HealthState(
        generation=int(os.environ.get(events_mod.ENV_GENERATION, "0")))
    journal_path = args.journal or os.environ.get(events_mod.ENV_JOURNAL)
    journal = (RunJournal(journal_path, generation=health.generation)
               if journal_path else None)
    prev_journal = (events_mod.set_journal(journal)
                    if journal is not None else None)
    procs: list = []
    replicas: list = []
    scraper = exporter = watcher = router = autoscaler = None
    shared_cache = None
    try:
        with persistent_cache(args.compile_cache_dir) as cache:
            if args.inprocess:
                n0 = args.min_replicas if args.autoscale else args.replicas
                bundle, replicas, make_replica, shared_cache = (
                    _build_inprocess_replicas(
                        args, n0, device,
                        store=cache.kernels if cache is not None else None))
                image_shape = bundle.image_shape
                initial_step = bundle.step
            else:
                procs, urls, replicas = _spawn_replicas(args, args.replicas)
                cfg = get_config(args.config)
                image_shape = tuple(DATASETS[cfg.dataset]["image_shape"])
                initial_step = args.step
                # the cross-host poller, pointed at the serving fleet: the
                # replicas' /metrics merged on this process's exporter
                scraper = FleetScraper(journal=journal, interval_s=0.5)
                scraper.set_targets(urls)
                scraper.start()
            if args.metrics_port:
                try:
                    exporter = MetricsExporter(
                        registry, health=health, journal_path=journal_path,
                        port=args.metrics_port,
                        info={"host_id": os.environ.get(
                                  events_mod.ENV_HOST_ID, "0"),
                              "generation": str(health.generation),
                              "role": "router"},
                        fleet=scraper,
                    ).start()
                except OSError as e:
                    log.warning("metrics exporter: could not bind port %d "
                                "(%s)", args.metrics_port, e)
            router = Router(
                replicas,
                RouterConfig(hedge_after_ms=args.hedge_after_ms or None,
                             health_interval_s=args.health_interval_s),
                registry=registry,
            ).start()
            health.set("serving")
            if args.autoscale:
                from dist_mnist_tpu_torch.serve import (
                    Autoscaler,
                    FleetSignalSource,
                    ScalePolicy,
                )

                def _spawn(replica_id, startup):
                    # scaled-up replicas join `replicas`, so the tear-down
                    # below owns them like the seed fleet
                    replica = make_replica(replica_id, startup)
                    replicas.append(replica)
                    return replica

                def _reap(replica):
                    replica.close()
                    if replica in replicas:
                        replicas.remove(replica)

                autoscaler = Autoscaler(
                    router, FleetSignalSource(router, scraper=scraper),
                    _spawn, reap=_reap,
                    policy=ScalePolicy(min_replicas=args.min_replicas,
                                       max_replicas=args.max_replicas,
                                       slo_p99_ms=args.slo_p99_ms),
                    interval_s=args.autoscale_interval_s,
                    registry=registry, cache=shared_cache,
                ).start()
            if args.watch:
                watcher = CheckpointWatcher(
                    args.checkpoint_dir, router.roll_weights,
                    poll_interval_s=args.watch_interval_s,
                    initial_step=initial_step,
                ).start()
            if on_router is not None:
                on_router(router, replicas)
            common = dict(image_shape=image_shape, seed=args.seed,
                          ls_fraction=args.ls_fraction,
                          ls_deadline_ms=args.ls_deadline_ms or None,
                          be_deadline_ms=args.be_deadline_ms or None)
            if args.trace:
                summary = run_trace_loadgen(router, arrivals=_arrivals(args),
                                            **common)
                summary["trace"]["kind"] = args.trace
            else:
                summary = run_fleet_loadgen(router,
                                            n_requests=args.requests,
                                            concurrency=args.concurrency,
                                            **common)
            summary["replicas"] = args.replicas
            summary["inprocess"] = args.inprocess
            if args.quant:
                summary["quant"] = args.quant
            summary["serving_step"] = router.serving_step
            if watcher is not None:
                summary["watcher"] = {"polls": watcher.polls,
                                      "rolls": watcher.rolls}
            if autoscaler is not None:
                summary["autoscale"] = autoscaler.snapshot()
            if shared_cache is not None:
                stats = shared_cache.stats()
                summary["cache"] = {k: stats[k] for k in (
                    "hits", "misses", "entries", "evictions",
                    "compile_secs")}
            if cache is not None:
                summary["compile_cache"] = cache.stats()
            if on_done is not None:
                on_done(router, replicas, summary)
    finally:
        if autoscaler is not None:
            autoscaler.close()
        if watcher is not None:
            watcher.close()
        if router is not None:
            router.close()
        for r in list(replicas):
            try:
                r.close()
            except Exception:  # noqa: BLE001 - best-effort tear-down
                log.warning("replica close failed", exc_info=True)
        for proc in list(procs):
            _reap_replica_proc(proc)
        if scraper is not None:
            scraper.close()
        if exporter is not None:
            exporter.close()
        if journal is not None:
            events_mod.set_journal(prev_journal)
            journal.close()
    summary["device"] = str(device)
    return summary


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s",
    )
    from dist_mnist_tpu_torch.utils.device import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        raise SystemExit(f"error: {err}") from None
    summary = run(args, device)
    print(json.dumps(summary, indent=2, sort_keys=True))
    return summary


if __name__ == "__main__":
    main()
