"""The port's benchmarks: the headline training run (the reference
`bench.py` with no flags), one ladder config's training throughput
(`bench.py --config NAME`), classifier serving (`bench.py --serve`,
`--serve --quant`, `--serve --longctx`), decode serving (`bench.py
--serve --decode`), resilience (`bench.py --faults [--async-save]`,
`--ckpt`, `--faults --elastic`) and the attribution modes (`--input`,
`--coldstart`, `--memory`, `--overlap`).

    python -m dist_mnist_tpu_torch.bench                # on the GPU
    python -m dist_mnist_tpu_torch.bench --device=cpu --race_rounds=1 \\
        --steps=100                                     # plain CPU path
    python -m dist_mnist_tpu_torch.bench --config vit_tiny_cifar_flash \\
        --steps 300                                     # a ladder config
    python -m dist_mnist_tpu_torch.bench --serve        # mlp_mnist p99
    python -m dist_mnist_tpu_torch.bench --serve --quant  # int8 vs float
    python -m dist_mnist_tpu_torch.bench --serve --longctx  # ViT zoo grid
    python -m dist_mnist_tpu_torch.bench --serve --decode \\
        --requests 64 --concurrency 16                  # decode serving
    python -m dist_mnist_tpu_torch.bench --faults [--async-save]
    python -m dist_mnist_tpu_torch.bench --ckpt
    python -m dist_mnist_tpu_torch.bench --faults --elastic
    python -m dist_mnist_tpu_torch.bench --input [--prefetch-depth 2]
    python -m dist_mnist_tpu_torch.bench --coldstart [--coldstart-steps 20]
    python -m dist_mnist_tpu_torch.bench --memory [--config lenet5_mnist]
    python -m dist_mnist_tpu_torch.bench --overlap [--bucket-mb 1.0]

Headline: LeNet-5 on MNIST, global batch 200, Adam 1e-3, the training
split resident on the device, steps in chunks of 100.
Two phases, as the reference's: an accuracy race (rounds of two chunks,
each round followed by a whole-test-set evaluation, until test accuracy
reaches 99% or the rounds run out; wall clock from the start), then
`--steps` steady-state steps timed after one warm-up chunk. Prints one
JSON line with the reference headline's schema: steps/sec/chip, examples
per second, MFU against the card's bf16 peak (`utils/flops.py`), and the
race result, labelled synthetic when the data is the procedural twin.

Ladder configs (`run_config`): the config's real training step (its
optimizer via `optim.build_optimizer`, its loss, remat and augmentation,
its sharding) on the config's mesh when the ranks exist, else on every
rank there is (DP when the config's strategy needs more, and the
record's `mesh_note` says so, as the reference's `bench_config`), at the
reference's per-chip batch (`ladder_batch`), timed over chunks of 100
steps after one warm-up chunk; one JSON line with steps/sec/chip and MFU
from the model's analytic FLOPs.

Classifier serving (`run_serve`, `run_serve_quant`, `run_serve_longctx`)
and decode serving (`run_serve_decode`) print their JSON lines; see
their docstrings. So do the resilience modes (`run_faults`, `run_ckpt`,
`run_faults_elastic`): the reference's geometry (the MLP, Adam 1e-3,
60 steps, checkpoints every 10; two ranks of `mlp_mnist` at batch 64
under the supervisors), its headline metric and its gates, with the
telemetry the reference's run beside them: `--faults` trains its fault
run under the journal, the anomaly hook and a live fleet of one (its
record's ``fleet``), and `--faults --elastic` gives the elastic side's
children `/metrics` and span records, the supervisor its fleet scraper,
and merges the journal into a fleet trace (its record's
``fleet_trace``). A failed hard gate prints an `error` line and exits 1.
Without a CUDA device and without ``--device=cpu`` every mode exits 1.

The attribution modes keep the reference's metric names, geometry and
gates. `--input` (`run_input`): the MLP at batch 1,024 fed by the
synchronous host batcher and by `DevicePrefetcher`, the residual
`input_stall_ms_per_step`, the two trajectories bit for bit.
`--coldstart` (`run_coldstart`): two fresh processes share a fresh store
directory (`compilecache/`), the cold one building the kernels and the
warm one loading them; `time_to_first_step_ms` (warm) with both
`StartupClock` snapshots. Its child trains LeNet-5 at batch 16 with
``optim.adam(1e-3, fused=True)`` so that on the card the step builds and
loads the `fused_adam` kernel (the reference's child compiles its
unfused Adam's XLA step; a stated departure); on the CPU nothing is
built, the record says ``builds: 0`` and the store gates read "not
applicable". `--memory` (`run_memory`) and `--overlap` (`run_overlap`)
run on the ranks of the world they run in: alone one rank, and under
`cli.launch.launch(module="dist_mnist_tpu_torch.bench")` N, the chief
printing the record. `--memory` gives per-rank `state_memory_bytes` under
dp and fsdp and their ratio, and one step's peak allocated bytes
(`step_peak`: `torch.cuda.max_memory_allocated` after
`reset_peak_memory_stats`, where the reference reads XLA's compiled
memory analysis; a stated departure). `--overlap` times the serial twin
against the overlapped FSDP schedule (`parallel/overlap.py`):
`comm_exposed_ms_per_step`, the two trajectories bit for bit, and each
variant's collective calls a step from `collective_stats` in place of
the reference's HLO counts; on one rank it reports the reference's
honest zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

#: process-start anchor for the --coldstart-child startup attribution
#: (`compilecache.StartupClock`): the imports below, torch's among them,
#: land in its ``import`` bucket
_T0 = time.monotonic()

import numpy as np  # noqa: E402
import torch  # noqa: E402

from dist_mnist_tpu_torch import optim
from dist_mnist_tpu_torch.configs import CONFIGS, Config
from dist_mnist_tpu_torch.data.datasets import Dataset, load_dataset
from dist_mnist_tpu_torch.data.pipeline import DeviceDataset
from dist_mnist_tpu_torch.models.registry import get_model
from dist_mnist_tpu_torch.ops import losses
from dist_mnist_tpu_torch.train import (
    TrainState,
    create_train_state,
    evaluate,
    make_eval_step,
    make_scanned_train_fn,
    state_memory_bytes,
)
from dist_mnist_tpu_torch.utils import flops
from dist_mnist_tpu_torch.utils.device import resolve_device
from dist_mnist_tpu_torch.utils.timing import timed_chunks

HEADLINE_METRIC = "lenet5_mnist_steps_per_sec_per_chip"
BATCH = 200  # global batch of the reference's headline
CHUNK = 100  # steps per chunk: one metrics fetch each
SEED = 0  # params, sampling and dropout (the reference's PRNGKey(0))


@dataclasses.dataclass
class HeadlineRun:
    record: dict  # the JSON line
    steps: int  # training steps taken, warm-up included
    first_loss: float  # mean loss of the first chunk
    final_loss: float  # mean loss of the last timed chunk
    state: TrainState


def run_headline(device: torch.device, optimizer: optim.Optimizer | None = None,
                 *, dataset: Dataset | None = None, race_rounds: int = 40,
                 timed_steps: int = 2000) -> HeadlineRun:
    """Train LeNet-5 on `device` (the accuracy race, then the timed
    steps) with `optimizer`, by default ``optim.adam(1e-3)`` as the
    reference's headline. Returns the JSON record and what the run did."""
    if race_rounds < 1:
        raise ValueError("race_rounds must be >= 1")
    chunk = CHUNK
    t_start = time.monotonic()
    dataset = dataset if dataset is not None else load_dataset("mnist",
                                                               seed=SEED)
    model = get_model("lenet5")
    optimizer = optimizer if optimizer is not None else optim.adam(1e-3)
    state = create_train_state(model, optimizer, SEED,
                               dataset.train_images[:1], device)
    dd = DeviceDataset(dataset, device)
    run = make_scanned_train_fn(model, optimizer, dd, BATCH, chunk)
    eval_step = make_eval_step(model)

    # accuracy race: train to 99% test accuracy, wall clock from the start
    wall_to_99, steps, first_loss = None, 0, None
    for _ in range(race_rounds):
        for _ in range(2):
            state, out = run(state)
            steps += chunk
            if first_loss is None:
                first_loss = float(out["loss"].item())
        res = evaluate(eval_step, state, dataset.test_images,
                       dataset.test_labels, batch_size=10_000)
        if res["accuracy"] >= 0.99:
            wall_to_99 = time.monotonic() - t_start
            break

    # steady-state throughput, after one warm-up chunk
    n_chunks = max(1, timed_steps // chunk)
    dt, state, final_loss = timed_chunks(run, state, n_chunks)
    steps += (n_chunks + 1) * chunk
    n_timed = n_chunks * chunk
    dt_per_step = dt / n_timed
    flops_step = flops.analytic_step_flops(
        model, dataset.train_images[:1].shape, BATCH)
    util = flops.mfu(flops_step, dt_per_step, device)
    peak = flops.device_peak_flops(device)
    steps_per_sec = n_timed / dt
    synthetic = bool(dataset.synthetic)
    record = {
        "metric": HEADLINE_METRIC,
        "value": steps_per_sec,
        "unit": "steps/sec/chip",
        # the >=99%-in-<60s north star is a real-MNIST target
        "vs_baseline": (60.0 / wall_to_99
                        if wall_to_99 and not synthetic else 0.0),
        "synthetic_data": synthetic,
        "extra": {
            "chips": 1,
            "global_batch": BATCH,
            "examples_per_sec": steps_per_sec * BATCH,
            "mfu": util,
            "flops_per_step": flops_step,
            "flops_basis": "analytic",
            "model_tflops_per_sec": flops_step / dt_per_step / 1e12,
            "device_kind": flops.device_kind(device),
            "peak_bf16_tflops": peak / 1e12 if peak else None,
            "timed_steps": n_timed,
            "accuracy_race": {
                "target": ">=99% test acc in <60s (north star; REAL MNIST)",
                "provenance": (
                    "synthetic procedural twin — easier than real MNIST; "
                    "NOT a north-star result" if synthetic else "real MNIST"
                ),
                "wall_to_99pct_acc_secs": wall_to_99,
                "final_test_acc": res["accuracy"],
            },
        },
    }
    return HeadlineRun(record, steps, first_loss, final_loss, state)


def ladder_batch(cfg: Config, n_chips: int) -> tuple[int, str]:
    """Global batch for a ladder config on `n_chips` (the reference's
    `bench.py ladder_batch`): a config's batch is sized for
    `cfg.ladder_devices` chips, so on another count the PER-CHIP batch is
    kept. Returns (batch, provenance note)."""
    if n_chips != cfg.ladder_devices:
        per_chip = max(1, cfg.batch_size // cfg.ladder_devices)
        return per_chip * n_chips, (
            f"per-chip geometry of the {cfg.ladder_devices}-chip ladder "
            f"config: {per_chip}/chip x {n_chips} chips")
    return cfg.batch_size, "config global batch"


def _bench_mesh(cfg: Config, device: torch.device):
    """(mesh, rules, note): the config's mesh when this group has its
    ranks; else every rank there is, under DP when the config's strategy
    is another (a one-rank mesh cannot measure it), and the note says so
    (the reference's fallback)."""
    from dist_mnist_tpu_torch.cluster.mesh import (
        MeshSpec,
        device_count,
        make_mesh,
    )
    from dist_mnist_tpu_torch.parallel.sharding import DP_RULES, resolve_rules

    rules = resolve_rules(cfg.sharding_rules)
    try:
        return make_mesh(cfg.mesh, device=device), rules, "config"
    except ValueError:
        mesh = make_mesh(MeshSpec(data=-1), device=device)
        note = f"fallback (config wants {cfg.mesh}, have {device_count()})"
        if cfg.sharding_rules != "dp" and mesh.size == 1:
            rules = DP_RULES
            note += (f"; one rank: benched as DP, not "
                     f"{cfg.sharding_rules!r}")
        return mesh, rules, note


def run_config(cfg: Config, device: torch.device, timed_steps: int, *,
               dataset: Dataset | None = None, data_dir=None,
               chunk: int = CHUNK) -> dict:
    """Train `cfg` on `device` and time it (the reference's
    `bench_config`): the config's model, optimizer, loss, remat,
    augmentation and sharding on its mesh (`_bench_mesh`), at the
    per-chip batch of `ladder_batch`; one warm-up chunk, then
    ``timed_steps // chunk`` timed chunks. Returns the JSON record, which
    also carries every chunk's mean loss. The config is run as given, so
    a test can pass one cut to a small width."""
    from dist_mnist_tpu_torch.parallel.sharding import (
        rules_name,
        shard_train_state,
    )

    mesh, rules, mesh_note = _bench_mesh(cfg, device)
    n_chips = mesh.ranks
    batch, batch_note = ladder_batch(cfg, n_chips)
    dataset = dataset if dataset is not None else load_dataset(
        cfg.dataset, data_dir, seed=cfg.seed)
    model = get_model(cfg.model, **cfg.model_kwargs)
    optimizer = optim.build_optimizer(cfg)
    loss_fn = (losses.clipped_softmax_cross_entropy if cfg.loss == "clipped"
               else losses.softmax_cross_entropy)
    state = shard_train_state(
        create_train_state(model, optimizer, SEED, dataset.train_images[:1],
                           device), mesh, rules)
    inner = make_scanned_train_fn(
        model, optimizer, DeviceDataset(dataset, device, mesh=mesh), batch,
        chunk, loss_fn=loss_fn, remat=cfg.remat,
        remat_policy=cfg.remat_policy, augment=cfg.augment, mesh=mesh,
        rules=rules)
    chunk_means = []

    def run(st):
        st, out = inner(st)
        chunk_means.append(out["loss"])
        return st, out

    n_chunks = max(1, timed_steps // chunk)
    dt, state, _ = timed_chunks(run, state, n_chunks)
    n_timed = n_chunks * chunk
    dt_per_step = dt / n_timed
    # per-chip basis: this rank's batch against one chip's peak
    flops_step = flops.analytic_step_flops(
        model, dataset.train_images[:1].shape, batch // n_chips)
    peak = flops.device_peak_flops(device)
    chunk_losses = [float(x) for x in torch.stack(chunk_means).cpu()]
    rate = n_timed / dt / n_chips  # the reference's per-chip basis
    record = {
        "metric": f"{cfg.name}_steps_per_sec_per_chip",
        "value": rate,
        "unit": "steps/sec/chip",
        "vs_baseline": 0.0,  # no published reference numbers
        "synthetic_data": bool(dataset.synthetic),
        "extra": {
            "chips": n_chips,
            "mesh": {k: v for k, v in mesh.shape.items() if v > 1} or
                    {"data": 1},
            "mesh_note": mesh_note,
            "sharding": rules_name(rules),
            "global_batch": batch,
            "batch_note": batch_note,
            "examples_per_sec": n_timed / dt * batch,
            "state_memory_bytes": state_memory_bytes(state),
            "mfu": flops.mfu(flops_step, dt_per_step, device),
            "flops_per_step": flops_step,
            "flops_basis": "analytic",
            "model_tflops_per_sec": flops_step / dt_per_step / 1e12,
            "device_kind": flops.device_kind(device),
            "peak_bf16_tflops": peak / 1e12 if peak else None,
            "timed_steps": n_timed,
            "steps_run": (n_chunks + 1) * chunk,
            "chunk_losses": chunk_losses,
        },
    }
    return record


class ServeGateError(RuntimeError):
    """A correctness gate of a classifier serving bench (`run_serve`,
    `run_serve_quant`, `run_serve_longctx`) failed."""


#: the classifier serving benches' engine and server geometry (the
#: reference's): max batch 64 for the MLP, 32 for the ViT grid
SERVE_MAX_BATCH, LONGCTX_MAX_BATCH = 64, 32


def _serve_config(max_batch: int, concurrency: int):
    from dist_mnist_tpu_torch.serve import ServeConfig

    return ServeConfig(max_batch=max_batch, max_wait_ms=2.0,
                       queue_depth=4 * concurrency)


def _gate_traffic(tag: str, summaries, misses: int) -> None:
    """The hard gates every serving bench shares: each loadgen run's
    requests all ok, and no cell run for the first time after prewarm."""
    for summary, n in summaries:
        if summary["ok"] != n or summary["errors"]:
            raise ServeGateError(
                f"{tag}: {summary['ok']}/{n} requests ok, "
                f"{summary['errors']} errors")
    if misses:
        raise ServeGateError(
            f"{tag}: {misses} cell(s) ran for the first time during "
            "traffic after a full prewarm")


def run_serve(device: torch.device, n_requests: int,
              concurrency: int) -> dict:
    """Classifier serving latency (the reference `bench.py --serve`):
    `mlp_mnist` (fresh seeded init) behind the server at max batch 64, a
    warm-up pass of `concurrency` requests, then the seeded closed-loop
    loadgen; `serve_p99_latency_ms`. Hard gates: every request ok, no
    cell run for the first time after prewarm."""
    from dist_mnist_tpu_torch.serve import (
        InferenceServer,
        build_zoo_engine,
        load_for_serving,
        run_loadgen,
    )
    from dist_mnist_tpu_torch.utils.flops import device_kind

    bundle = load_for_serving("mlp_mnist", device)
    engine = build_zoo_engine(bundle, device, model_name="mlp",
                              max_bucket=SERVE_MAX_BATCH)
    server = InferenceServer(engine, _serve_config(SERVE_MAX_BATCH,
                                                   concurrency))
    with server:
        misses0 = engine.misses
        warm = run_loadgen(server, n_requests=concurrency,
                           concurrency=concurrency,
                           image_shape=bundle.image_shape, seed=1)
        summary = run_loadgen(server, n_requests=n_requests,
                              concurrency=concurrency,
                              image_shape=bundle.image_shape, seed=0)
    _gate_traffic("serve", ((warm, concurrency), (summary, n_requests)),
                  engine.misses - misses0)
    return {
        "metric": "serve_p99_latency_ms",
        "value": summary["p99_ms"],
        "unit": "ms",
        "vs_baseline": 0.0,
        "extra": {
            "device_kind": device_kind(device),
            "p50_ms": summary["p50_ms"],
            "p95_ms": summary["p95_ms"],
            "mean_ms": summary["mean_ms"],
            # the streaming histograms' view of the same run, beside the
            # loadgen's exact percentiles
            "hist_latency_ms": server.metrics.latency_percentiles(),
            "n_requests": n_requests,
            "concurrency": concurrency,
            "ok": summary["ok"],
            "rejected_queue_full": summary["rejected_queue_full"],
            "mean_batch_size": summary["mean_batch_size"],
            "mean_occupancy": summary["mean_occupancy"],
            "recompiles_during_traffic": 0,
            "cache": engine.cache_stats(),
        },
    }


def top1_flips(float_engine, int8_engine, pool: np.ndarray) -> int:
    """Rows of `pool` whose top-1 class differs between the two engines,
    run in batches of `SERVE_MAX_BATCH` (cells the benches prewarm)."""
    flips = 0
    for i in range(0, len(pool), SERVE_MAX_BATCH):
        lf = float_engine.predict(pool[i:i + SERVE_MAX_BATCH])
        lq = int8_engine.predict(pool[i:i + SERVE_MAX_BATCH])
        flips += int(np.sum(np.argmax(lf, -1) != np.argmax(lq, -1)))
    return flips


def run_serve_quant(device: torch.device, n_requests: int,
                    concurrency: int) -> list[dict]:
    """Int8 serving next to float (the reference `bench.py --serve
    --quant`): one seeded stream through a float and an int8 weight-only
    `mlp_mnist` engine (the same fresh init; the int8 engine's two dense
    layers run `quant_matmul`), each behind its server at max batch 64
    after a warm-up pass. Returns `quant_resident_bytes_ratio` (int8 over
    float resident weight bytes) and `quant_p99_ms` (the int8 p99).

    Hard gates (the reference's correctness contract): every request ok,
    no cell run for the first time after prewarm on either engine, int8
    resident weight bytes <= 0.30x float, top-1 agreement >= 0.99 over
    the stream's 256-image pool. The reference also gates int8 p99 <=
    1.10x float p99; here it is the field `p99_ratio_vs_float` with the
    boolean `p99_within_1_10x`, not a gate, as `run_serve_decode` reports
    its speed orderings: both engines are host-bound on one GPU (a served
    batch's host wall is ten times its device time, PERF.md §5), so the
    ratio is noise around 1 until a cell gives it a limit measured on the
    card (ROADMAP §2 item 8)."""
    from dist_mnist_tpu_torch.serve import (
        InferenceServer,
        build_zoo_engine,
        load_for_serving,
        make_images,
        run_loadgen,
    )
    from dist_mnist_tpu_torch.utils.flops import device_kind

    bundles = {"float": load_for_serving("mlp_mnist", device),
               "int8": load_for_serving("mlp_mnist", device, quant="int8")}
    runs, engines = {}, {}
    for tag, bundle in bundles.items():
        engine = build_zoo_engine(bundle, device, model_name="mlp",
                                  max_bucket=SERVE_MAX_BATCH)
        engines[tag] = engine
        server = InferenceServer(engine, _serve_config(SERVE_MAX_BATCH,
                                                       concurrency))
        with server:
            misses0 = engine.misses
            warm = run_loadgen(server, n_requests=concurrency,
                               concurrency=concurrency,
                               image_shape=bundle.image_shape, seed=1)
            summary = run_loadgen(server, n_requests=n_requests,
                                  concurrency=concurrency,
                                  image_shape=bundle.image_shape, seed=0)
        _gate_traffic(f"serve --quant, {tag} engine",
                      ((warm, concurrency), (summary, n_requests)),
                      engine.misses - misses0)
        runs[tag] = summary
    bytes_f = engines["float"].state_bytes_per_device()
    bytes_q = engines["int8"].state_bytes_per_device()
    ratio = bytes_q["param_bytes"] / max(bytes_f["param_bytes"], 1)
    if ratio > 0.30:
        raise ServeGateError(
            f"serve --quant: int8 resident weight bytes {ratio}x float "
            "(gate: <= 0.30x)")
    # top-1 agreement over the timed stream's image pool (seed 0, the
    # images the loadgen cycled through)
    pool = make_images(bundles["float"].image_shape, seed=0)
    flips = top1_flips(engines["float"], engines["int8"], pool)
    agreement = 1.0 - flips / len(pool)
    if agreement < 0.99:
        raise ServeGateError(
            f"serve --quant: top-1 agreement {agreement} with the float "
            "engine (gate: >= 0.99)")
    report = bundles["int8"].quant_report
    p99_f, p99_q = runs["float"]["p99_ms"], runs["int8"]["p99_ms"]
    p99_ratio = p99_q / max(p99_f, 1e-9)
    return [{
        "metric": "quant_resident_bytes_ratio",
        "value": ratio,
        "unit": "x_float",
        "vs_baseline": 0.0,
        "extra": {
            "float_param_bytes": bytes_f["param_bytes"],
            "int8_param_bytes": bytes_q["param_bytes"],
        },
    }, {
        "metric": "quant_p99_ms",
        "value": p99_q,
        "unit": "ms",
        "vs_baseline": 0.0,
        "extra": {
            "device_kind": device_kind(device),
            "float_p99_ms": p99_f,
            # the reference's speed ordering, a field here (docstring)
            "p99_ratio_vs_float": p99_ratio,
            "p99_within_1_10x": p99_ratio <= 1.10,
            "p50_ms": runs["int8"]["p50_ms"],
            "mean_ms": runs["int8"]["mean_ms"],
            "float_mean_ms": runs["float"]["mean_ms"],
            "resident_bytes_ratio": ratio,
            "top1_agreement": agreement,
            "top1_flips": flips,
            "pool_size": len(pool),
            "quant_error_max": report["max_abs_err"],
            "quant_rel_err_max": report["max_rel_err"],
            "quant_leaves": report["n_quantized"],
            "per_leaf_rel_err": {k: v["rel_err"]
                                 for k, v in report["leaves"].items()},
            "recompiles_during_traffic": 0,
            "n_requests": n_requests,
            "concurrency": concurrency,
            "ok": runs["int8"]["ok"],
            # every batch each engine ran: prewarm, traffic, agreement
            "batches_run": {tag: e.cache_stats()["execute_count"]
                            for tag, e in engines.items()},
            "cache": engines["int8"].cache_stats(),
        },
    }]


def run_serve_longctx(device: torch.device, n_requests: int,
                      concurrency: int,
                      config: str | Config = "vit_tiny_cifar") -> dict:
    """Variable-height serving through the zoo grid (the reference
    `bench.py --serve --longctx`): `config` (ViT-Tiny at full width, fresh
    seeded init) behind the auto power-of-two height ladder (heights 4, 8,
    16, 32 of 32 x 32 images: S = 9, 17, 33, 65 with CLS) at max batch
    32, every (batch, height) cell prewarmed, a warm-up pass, then seeded
    variable-height traffic; `longctx_p99_ms` over every height, with the
    per-bucket routing counts. With ``config="vit_tiny_cifar_flash"`` the
    masked cells run the masked flash forward and the dense native cell
    the flash forward. Hard gates: every request ok, no cell run for the
    first time after prewarm. `config` may also be a `Config`, as
    `run_config` takes one, so a test can pass one cut to a small width."""
    from dist_mnist_tpu_torch.configs import get_config
    from dist_mnist_tpu_torch.serve import (
        InferenceServer,
        build_zoo_engine,
        load_for_serving,
        run_longctx_loadgen,
    )
    from dist_mnist_tpu_torch.utils.flops import device_kind

    cfg = get_config(config) if isinstance(config, str) else config
    bundle = load_for_serving(cfg, device)
    engine = build_zoo_engine(bundle, device, model_name=cfg.model,
                              max_bucket=LONGCTX_MAX_BATCH,
                              seq_buckets="auto")
    if engine.seq_grid.native_only:
        raise ValueError(f"{cfg.name}: the model cannot mask tokens, so the "
                         "zoo grid has no sub-native heights")
    server = InferenceServer(engine, _serve_config(LONGCTX_MAX_BATCH,
                                                   concurrency))
    with server:
        misses0 = engine.misses
        warm = run_longctx_loadgen(server, n_requests=concurrency,
                                   concurrency=concurrency, seed=1)
        summary = run_longctx_loadgen(server, n_requests=n_requests,
                                      concurrency=concurrency, seed=0)
    _gate_traffic(f"serve --longctx ({cfg.name})",
                  ((warm, concurrency), (summary, n_requests)),
                  engine.misses - misses0)
    return {
        "metric": "longctx_p99_ms",
        "value": summary["p99_ms"],
        "unit": "ms",
        "vs_baseline": 0.0,
        "extra": {
            "device_kind": device_kind(device),
            "config": cfg.name,
            "p50_ms": summary["p50_ms"],
            "p95_ms": summary["p95_ms"],
            "mean_ms": summary["mean_ms"],
            "n_requests": n_requests,
            "concurrency": concurrency,
            "ok": summary["ok"],
            "seq_buckets": list(engine.seq_grid.heights),
            "seq_bucket_counts": summary["seq_bucket_counts"],
            "recompiles_during_traffic":
                summary["recompiles_during_traffic"],
            "serve_state_bytes_per_device": engine.state_bytes_per_device(),
            # every cell's runs, prewarm and warm-up included
            "cache": engine.cache_stats(),
            "mean_seq_occupancy": summary["mean_seq_occupancy"],
            "mean_batch_size": summary["mean_batch_size"],
        },
    }


class DecodeGateError(RuntimeError):
    """A correctness gate of `run_serve_decode` failed."""


def decode_forced_agreement(engine, reqs, streams) -> tuple[int, int]:
    """Teacher-forced next-token agreement: replay a reference engine's
    token streams through `engine`, forcing every step's input token to
    the reference token, and count argmax matches. Per-position fidelity
    of the KV quantization, without one flipped near-tie cascading
    through the rest of a free-running stream."""
    rows = engine.grid.rows
    match = total = 0
    for at in range(0, len(reqs), engine.max_slots):
        chunk = list(zip(reqs[at:at + engine.max_slots],
                         streams[at:at + engine.max_slots]))
        slots = list(range(len(chunk)))
        for slot, ((prompt, _), stream) in zip(slots, chunk):
            if not engine.try_reserve(slot, len(prompt) + len(stream)):
                raise RuntimeError("KV page pool too small for replay")
        first = engine.prefill([p for (p, _), _ in chunk], slots)
        tokens = np.zeros(rows, np.int32)
        positions = np.zeros(rows, np.int32)
        live, plen = {}, {}
        for slot, ((prompt, _), stream) in zip(slots, chunk):
            match += int(first[slot] == stream[0])
            total += 1
            plen[slot] = len(prompt)
            if len(stream) > 1:
                live[slot] = 1  # index of the next position to predict
        while live:
            for slot, i in live.items():
                tokens[slot] = streams[at + slot][i - 1]
                positions[slot] = plen[slot] + i - 1
            nxt = engine.decode(tokens, positions)
            for slot, i in list(live.items()):
                match += int(nxt[slot] == streams[at + slot][i])
                total += 1
                if i + 1 < len(streams[at + slot]):
                    live[slot] = i + 1
                else:
                    del live[slot]
        for slot in slots:
            engine.release_slot(slot)
    return match, total


#: the capacity trio's geometry: the widest causal LM the reference runs,
#: provisioned for a long max_seq and driven by short requests
CAPACITY_GEOM = dict(dim=128, heads=8, max_seq=4096, depth=2)
CAPACITY_TRAFFIC = dict(max_prompt=32, max_new=32)
CAPACITY_PROMPT_BUCKETS = (16, 32)
DECODE_SLOTS = 8


def run_serve_decode(device: torch.device, n_requests: int,
                     concurrency: int) -> list[dict]:
    """Decode serving (the reference `bench.py --serve --decode`). Returns
    its three records; raises `DecodeGateError` when a gate fails.

    1. Continuous batching against the static baseline on `causal_tiny`
       at its registry defaults (dense cache), one seeded request stream
       each after a warm-up stream: `decode_ttft_p99_ms` of continuous.
    2. The capacity trio at `CAPACITY_GEOM` (dense; paged float,
       kv_page_tokens 32; paged int8, kv_page_tokens 32) under short
       requests (`CAPACITY_TRAFFIC`): `decode_kv_bytes_ratio`, the int8
       engine's peak resident KV over the dense allocation, and
       `decode_tokens_per_s`, the int8 engine's mean per-request tokens/s.
       The int8 engine's decode step runs the `paged_attention` kernel.

    Hard gates (the reference's correctness contracts): every request ok;
    continuous and static streams identical; paged-float streams identical
    to dense; int8 teacher-forced agreement with the dense streams >=
    0.99; peak int8 KV <= 0.35x dense. The speed orderings the reference
    also gates on (continuous TTFT p99 below static, int8 tokens/s above
    dense, int8 TTFT p99 no worse than dense) are reported as fields."""
    from dist_mnist_tpu_torch.serve import (
        DecodeScheduler,
        build_decode_engine,
        make_prompts,
        run_decode_loadgen,
    )
    from dist_mnist_tpu_torch.utils.flops import device_kind

    def run(engine, mode="continuous", **traffic) -> dict:
        engine.prewarm()
        with DecodeScheduler(engine, mode=mode) as sched:
            run_decode_loadgen(sched, n_requests=2 * DECODE_SLOTS,
                               concurrency=concurrency, seed=1, **traffic)
            summary = run_decode_loadgen(sched, n_requests=n_requests,
                                         concurrency=concurrency, seed=0,
                                         keep_streams=True, **traffic)
        if summary["errors"] or summary["ok"] != n_requests:
            raise DecodeGateError(
                f"{mode} run lost requests: ok={summary['ok']} "
                f"errors={summary['errors']} of {n_requests}")
        return summary

    continuous = run(build_decode_engine(device, max_slots=DECODE_SLOTS),
                     "continuous")
    static = run(build_decode_engine(device, max_slots=DECODE_SLOTS),
                 "static")
    if continuous["streams"] != static["streams"]:
        ndiff = sum(a != b for a, b in zip(continuous["streams"],
                                           static["streams"]))
        raise DecodeGateError(
            f"token streams differ between scheduling modes ({ndiff}/"
            f"{n_requests} requests): continuous batching changed WHAT was "
            "computed, not just when")

    def capacity(**overrides):
        engine = build_decode_engine(
            device, max_slots=DECODE_SLOTS,
            prompt_buckets=CAPACITY_PROMPT_BUCKETS, **CAPACITY_GEOM,
            **overrides)
        return run(engine, **CAPACITY_TRAFFIC), engine

    dense_cap, dense_eng = capacity()
    paged_cap, _ = capacity(cache_layout="paged", kv_page_tokens=32)
    int8_cap, int8_eng = capacity(cache_layout="paged", kv_page_tokens=32,
                                  kv_quant="int8")
    if paged_cap["streams"] != dense_cap["streams"]:
        ndiff = sum(a != b for a, b in zip(paged_cap["streams"],
                                           dense_cap["streams"]))
        raise DecodeGateError(
            f"paged-float streams differ from the dense twin's ({ndiff}/"
            f"{n_requests} requests): paging changed the math")
    n_replay = min(n_requests, 64)
    reqs = make_prompts(n_replay, max_seq=CAPACITY_GEOM["max_seq"], seed=0,
                        vocab_size=int8_eng.model.vocab_size,
                        **CAPACITY_TRAFFIC)
    hits, positions = decode_forced_agreement(
        int8_eng, reqs, dense_cap["streams"][:n_replay])
    agreement = hits / max(1, positions)
    if agreement < 0.99:
        raise DecodeGateError(
            f"int8 KV teacher-forced agreement {agreement} < 0.99 "
            f"({hits}/{positions} positions)")
    kv = int8_eng.kv_stats()
    dense_kv_bytes = dense_eng.kv_stats()["kv_bytes_pinned"]
    ratio = kv["kv_bytes_peak"] / dense_kv_bytes
    if ratio > 0.35:
        raise DecodeGateError(
            f"int8 paged peak resident KV {kv['kv_bytes_peak']} B is "
            f"{ratio}x the dense allocation {dense_kv_bytes} B (> 0.35x)")

    kind = device_kind(device)
    return [{
        "metric": "decode_ttft_p99_ms",
        "value": continuous["ttft_p99_ms"],
        "unit": "ms",
        "extra": {
            "device_kind": kind,
            "decode_tokens_per_s": continuous["tokens_per_s_mean"],
            "ttft_p50_ms": continuous["ttft_p50_ms"],
            "static_ttft_p99_ms": static["ttft_p99_ms"],
            "static_tokens_per_s": static["tokens_per_s_mean"],
            "continuous_ttft_p99_below_static":
                continuous["ttft_p99_ms"] < static["ttft_p99_ms"],
            "n_requests": n_requests,
            "concurrency": concurrency,
            "max_slots": DECODE_SLOTS,
            "tokens_out": continuous["tokens_out"],
            "streams_identical": True,
            "mean_active_slots": {
                "continuous": continuous["scheduler"]["mean_active_slots"],
                "static": static["scheduler"]["mean_active_slots"],
            },
        },
    }, {
        "metric": "decode_kv_bytes_ratio",
        "value": ratio,
        "unit": "ratio",
        "extra": {
            "kv_bytes_peak": kv["kv_bytes_peak"],
            "dense_kv_bytes": dense_kv_bytes,
            "kv_pages_total": kv["kv_pages_total"],
            "page_tokens": kv["page_tokens"],
            "kv_quant": kv["kv_quant"],
            "int8_forced_agreement": agreement,
            "int8_forced_positions": positions,
            "paged_float_streams_bitwise": True,
        },
    }, {
        "metric": "decode_tokens_per_s",
        "value": int8_cap["tokens_per_s_mean"],
        "unit": "tokens/s/request",
        "extra": {
            "device_kind": kind,
            "dense_tokens_per_s": dense_cap["tokens_per_s_mean"],
            "paged_float_tokens_per_s": paged_cap["tokens_per_s_mean"],
            "speedup_vs_dense": int8_cap["tokens_per_s_mean"]
            / dense_cap["tokens_per_s_mean"],
            "int8_tokens_per_s_above_dense":
                int8_cap["tokens_per_s_mean"]
                > dense_cap["tokens_per_s_mean"],
            "int8_ttft_p99_ms": int8_cap["ttft_p99_ms"],
            "dense_ttft_p99_ms": dense_cap["ttft_p99_ms"],
            "int8_ttft_p99_no_worse":
                int8_cap["ttft_p99_ms"] <= dense_cap["ttft_p99_ms"],
            "max_seq": CAPACITY_GEOM["max_seq"],
            "depth": CAPACITY_GEOM["depth"],
            # every decode step of the int8 engine (prewarm, warm-up and
            # timed traffic, the replay) runs one paged_attention launch
            # per layer
            "int8_decode_steps": int8_eng.decode_steps,
        },
    }]


# -- resilience: --faults, --ckpt, --faults --elastic -------------------------

#: the reference's resilience geometry (`bench.py --faults` / `--ckpt` /
#: `--faults --elastic`): mlp_mnist's model, Adam 1e-3, seed 0
FAULTS_STEPS = 60
FAULTS_PREEMPT_AT = 40
FAULTS_CKPT_EVERY = 10
FAULTS_BATCH = 256
ELASTIC_STEPS = 60
ELASTIC_KILL_STEP = 35
ELASTIC_BATCH = 64
ELASTIC_PROCS = 2


class ResilienceGateError(RuntimeError):
    """A resilience bench's hard gate failed (the reference's assert)."""


def _gate(ok: bool, message: str, error=ResilienceGateError) -> None:
    if not ok:
        raise error(message)


class LossTrajectory:
    """Per-step loss recorder: the step's device scalar is kept, and all
    of them come to the host once, at `end` (no sync a step)."""

    def __init__(self):
        self.loss = {}

    def begin(self, loop):
        pass

    def before_step(self, step):
        pass

    def after_step(self, step, state, outputs):
        self.loss[step] = outputs["loss"].detach().clone()

    def end(self, state):
        self.loss = {k: v.cpu().numpy() for k, v in self.loss.items()}


def same_trajectory(a: dict, b: dict) -> bool:
    """Bit-equal losses at the same steps."""
    return set(a) == set(b) and all(a[s].tobytes() == b[s].tobytes()
                                    for s in a)


def faults_state(device: torch.device, dataset: Dataset) -> TrainState:
    """The resilience benches' initial state: the MLP under Adam 1e-3,
    seeded with `SEED`."""
    return create_train_state(get_model("mlp"), optim.adam(1e-3), SEED,
                              dataset.train_images[:1], device)


def faults_run(device: torch.device, dataset: Dataset, state0: TrainState, *,
               n_steps: int = FAULTS_STEPS, batch: int = FAULTS_BATCH,
               ckpt_every: int = FAULTS_CKPT_EVERY, plan=None,
               ckpt_dir: str | None = None, async_save: bool = False,
               journal: str | None = None,
               instrumented: bool = False) -> dict:
    """One short MLP training run from a fork of `state0` (so every run
    starts from the same bits) through the loop and its hooks, optionally
    under a fault plan and with cadence checkpoints (blocking, or through
    the `AsyncSnapshotter`), with a run journal at `journal`.
    `instrumented` adds the observability stack: `AnomalyHook(every_steps
    =10)` and a live fleet of one, an exporter serving the loop's
    step-time histogram that a `FleetScraper(interval_s=0.05)` polls while
    the run trains. Returns the trajectory, the loop, the write-behind
    counters and the scrape stats (``obs``, None uninstrumented)."""
    from dist_mnist_tpu_torch import hooks as hooks_lib
    from dist_mnist_tpu_torch.checkpoint import (
        AsyncSnapshotter,
        CheckpointManager,
        fork_state,
    )
    from dist_mnist_tpu_torch.data.pipeline import ShardedBatcher
    from dist_mnist_tpu_torch.obs import events as events_mod
    from dist_mnist_tpu_torch.train import make_train_step
    from dist_mnist_tpu_torch.train.loop import TrainLoop

    model, optimizer = get_model("mlp"), optim.adam(1e-3)
    traj = LossTrajectory()
    hooks = [hooks_lib.StopAtStepHook(last_step=n_steps), traj]
    anomaly = None
    if instrumented:
        from dist_mnist_tpu_torch.obs.anomaly import AnomalyHook

        anomaly = AnomalyHook(every_steps=10)
        hooks.append(anomaly)
    manager = None
    if ckpt_dir:
        manager = CheckpointManager(ckpt_dir, async_save=False,
                                    max_restore_fallbacks=2)
        if plan is not None:
            manager = plan.wrap_checkpoint_manager(manager)
        if async_save:
            # the write-behind layer OUTSIDE the fault wrapper: the injected
            # corruption still hits the durable store
            manager = AsyncSnapshotter(manager)
        hooks.append(hooks_lib.CheckpointHook(manager,
                                              every_steps=ckpt_every))
    batches = ShardedBatcher(dataset, batch, device, seed=SEED)
    if plan is not None:
        hooks.append(plan.hook())
        batches = plan.wrap_batches(batches)
    loop = TrainLoop(make_train_step(model, optimizer), fork_state(state0),
                     batches, hooks, checkpoint_manager=manager,
                     max_recoveries=3)
    exporter = scraper = obs = None
    if instrumented:
        # a fleet of one scraping the live run: the exporter serves the
        # loop's step-time histogram and the scraper polls it while the
        # loop trains — the supervisor's fleet path, pointed at one host
        from dist_mnist_tpu_torch.obs import MetricRegistry, MetricsExporter
        from dist_mnist_tpu_torch.obs.fleet import FleetScraper

        registry = MetricRegistry()
        registry.attach_histogram("train/step_time_ms", loop.step_time_hist)
        exporter = MetricsExporter(
            registry, port=0,
            info={"host_id": "0", "generation": "0", "role": "train"},
        ).start()
        scraper = FleetScraper(interval_s=0.05)
        scraper.set_targets({0: exporter.url("")})
        scraper.start()
    prev = (events_mod.set_journal(events_mod.RunJournal(journal))
            if journal else None)
    try:
        loop.run()
    finally:
        if journal:
            events_mod.set_journal(prev).close()
        if scraper is not None:
            scraper.scrape_once()  # a final deterministic pass
            snap = scraper.snapshot()
            obs = {"scrapes": snap["scrapes"],
                   "scrape_errors": snap["scrape_errors"],
                   "host_reachable": snap["hosts"][0]["reachable"],
                   "anomalies": len(anomaly.anomalies)}
            scraper.close()
        if exporter is not None:
            exporter.close()
    writer = None
    if manager is not None:
        if async_save:
            writer = {"dropped": manager.dropped,
                      "write_behind_stall_s": manager.consume_save_stall_s()}
        manager.close()
    return {"loss": traj.loss, "loop": loop, "writer": writer, "obs": obs}


def run_faults(device: torch.device, *, dataset: Dataset | None = None,
               async_save: bool = False, n_steps: int = FAULTS_STEPS,
               preempt_at: int = FAULTS_PREEMPT_AT,
               ckpt_every: int = FAULTS_CKPT_EVERY,
               batch: int = FAULTS_BATCH) -> dict:
    """`--faults [--async-save]`: the same short MLP run twice — clean,
    then under a preemption at `preempt_at` with that step's checkpoint
    corrupted, so the restore quarantines it and falls back one more
    interval — and the headline `recovery_latency_ms`: failure to the
    first step past the old frontier (restore + replay;
    faults/goodput.py). Gates (the reference's): the recovered loss
    trajectory equals the clean one bit for bit, every fault fired, and
    the journal's restores equal the loop's recoveries. `async_save` runs
    the fault run's checkpoints through the `AsyncSnapshotter`.

    The FAULT run also carries the whole observability stack — the
    journal, `AnomalyHook` and a live fleet of one (`faults_run(
    instrumented=True)`) — while the clean run has none, so the bitwise
    trajectory gate doubles as the proof that observability does not
    perturb the math; a further gate holds that the scraper reached the
    live exporter, and the scrape stats ride along as ``fleet``."""
    import tempfile

    from dist_mnist_tpu_torch.faults.plan import Fault, FaultPlan
    from dist_mnist_tpu_torch.obs import events as events_mod

    metric = "recovery_latency_ms"
    dataset = dataset if dataset is not None else load_dataset("mnist",
                                                               seed=SEED)
    state0 = faults_state(device, dataset)
    geom = dict(n_steps=n_steps, batch=batch, ckpt_every=ckpt_every)
    clean = faults_run(device, dataset, state0, **geom)
    plan = FaultPlan([Fault.preempt(preempt_at),
                      Fault.corrupt_checkpoint(preempt_at)])
    with tempfile.TemporaryDirectory(prefix="bench_faults_") as root:
        journal_path = f"{root}/journal.jsonl"
        fault = faults_run(device, dataset, state0, plan=plan,
                           ckpt_dir=f"{root}/ckpt", async_save=async_save,
                           journal=journal_path, instrumented=True, **geom)
        journal = events_mod.read_journal(journal_path)
    identical = same_trajectory(clean["loss"], fault["loss"])
    _gate(identical, "recovered loss trajectory diverged from the "
                     "fault-free run (the fault run carried the whole obs "
                     "stack — journal, AnomalyHook, live fleet scraper: "
                     "observability must not perturb the math)")
    _gate(all(f.fired for f in plan.faults),
          f"planned faults did not all fire: {plan.to_json()}")
    obs = fault["obs"]
    _gate(obs is not None and obs["host_reachable"] and obs["scrapes"] >= 1,
          f"fleet-of-one scraper never reached the live exporter: {obs}")
    loop = fault["loop"]
    snap = loop.goodput.snapshot()
    journal_events = [r.get("event") for r in journal]
    journal_restores = journal_events.count("restore")
    _gate(journal_restores == snap["recoveries"],
          f"journal restore events ({journal_restores}) != goodput "
          f"recoveries ({snap['recoveries']}); journal saw: "
          f"{journal_events}")
    return {
        "metric": metric,
        "value": snap["recovery_latency_ms"],
        "unit": "ms",
        "vs_baseline": 0.0,  # resilience metric: no published reference
        "synthetic_data": bool(dataset.synthetic),
        "extra": {
            "device": str(device),
            "chips": 1,
            "global_batch": batch,
            "steps": n_steps,
            "preempt_at_step": preempt_at,
            "ckpt_every": ckpt_every,
            "goodput_fraction": snap["goodput_fraction"],
            "recoveries": snap["recoveries"],
            "replayed_steps": snap["replayed_steps"],
            **{k: snap[k] for k in ("productive_s", "restore_s", "replay_s",
                                    "stall_s", "save_s", "total_wall_s")},
            "save_stall_ms_per_step": snap["save_s"] * 1e3 / n_steps,
            "async_save": async_save,
            "fork_ms_mean": _mean([r["fork_ms"] for r in journal
                                   if r.get("event") == "snapshot_fork"]),
            "trajectory_identical": identical,
            "faults_fired": [f.kind for f in plan.fired()],
            "step_time_ms": loop.step_time_hist.percentiles(),
            "journal_events": journal_events,
            "journal_restores": journal_restores,
            # fleet-of-one scrape stats (obs/fleet.py polled the live run)
            "fleet": obs,
        },
    }


def _mean(values) -> float | None:
    return sum(values) / len(values) if values else None


def _events(records, name):
    return [r for r in records if r.get("event") == name]


class Supervised:
    """A supervised run under way (`start_supervised`)."""

    def __init__(self, tag: str, proc, log_path: str, journal: str,
                 t0: float):
        self.tag, self.proc, self.log_path = tag, proc, log_path
        self.journal, self.t0 = journal, t0


def start_supervised(root: str, tag: str, data_dir: str, platform, *,
                     plan, elastic: bool, peer: bool = False,
                     n_steps: int = ELASTIC_STEPS,
                     batch: int = ELASTIC_BATCH,
                     ckpt_every: int = FAULTS_CKPT_EVERY,
                     procs: int = ELASTIC_PROCS, fleet_obs: bool = False
                     ) -> Supervised:
    """Start one supervised `mlp_mnist` run of `procs` ranks through the
    launcher's entry point (``python -m dist_mnist_tpu_torch.cli.launch
    --max_restarts=procs-1 [--elastic] --fault_plan=...``), its output in
    ``<root>/<tag>.log`` and its journal ``<root>/journal_<tag>.jsonl``;
    several may run at once. `finish_supervised` waits for it.
    `fleet_obs` (elastic) runs the fleet observability path: the children
    serve `/metrics` on a probed block of free ports (``--metrics_port``;
    a lost race warns in the child and it trains unexposed) and journal
    span records every `ckpt_every` steps (``--span_steps``), and the
    supervisor scrapes them (``--supervisor_port=0``)."""
    import subprocess
    import sys

    from dist_mnist_tpu_torch.cli.launch import _child_env

    journal = f"{root}/journal_{tag}.jsonl"
    train_args = ["--config=mlp_mnist", f"--data_dir={data_dir}",
                  f"--checkpoint_dir={root}/ckpt_{tag}",
                  f"--train_steps={n_steps}", f"--batch_size={batch}",
                  "--eval_every=0", "--log_every=10",
                  f"--checkpoint_every_steps={ckpt_every}"]
    if peer:
        train_args += ["--async_snapshot", f"--peer_dir={root}/peer_{tag}"]
    supervisor = []
    if fleet_obs:
        base = _free_port_block(procs)
        if base is not None:
            train_args.append(f"--metrics_port={base}")
        train_args.append(f"--span_steps={ckpt_every}")
        supervisor = ["--supervisor_port=0"]
    cmd = [sys.executable, "-m", "dist_mnist_tpu_torch.cli.launch",
           f"--num_processes={procs}", f"--max_restarts={procs - 1}",
           "--restart_backoff_s=1.0", "--min_processes=1",
           f"--journal={journal}", f"--fault_plan={plan.to_json()}",
           *(["--elastic"] if elastic else []), *supervisor,
           *([f"--platform={platform}"] if platform else []),
           "--", *train_args]
    log_path = f"{root}/{tag}.log"
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                env=_child_env())
    return Supervised(tag, proc, log_path, journal, time.monotonic())


def _free_port_block(n: int) -> int | None:
    """A base port with `n` consecutive free ports (the children bind
    ``--metrics_port`` base + rank). Best effort: probed, then released,
    so a race is possible — a child that loses it warns and trains on
    unexposed."""
    import socket

    for _ in range(20):
        with socket.socket() as probe:
            probe.bind(("127.0.0.1", 0))
            base = probe.getsockname()[1]
        if base + n >= 65535:
            continue
        held = []
        try:
            for i in range(n):
                s = socket.socket()
                held.append(s)
                s.bind(("127.0.0.1", base + i))
            return base
        except OSError:
            continue
        finally:
            for s in held:
                s.close()
    return None


def fleet_trace_stats(journal: str) -> dict:
    """Merge a supervised run's host-stamped journal into one chrome trace
    (`scripts/fleet_trace.build_fleet_trace`, the standard library only)
    and count what the gates read: events, host tracks (pid >= 1), the
    generations that hold span records, resize markers."""
    import sys
    from pathlib import Path

    scripts = str(Path(__file__).resolve().parents[1] / "scripts")
    sys.path.insert(0, scripts)
    try:
        from fleet_trace import build_fleet_trace
    finally:
        sys.path.remove(scripts)
    trace = build_fleet_trace(journal)["traceEvents"]
    return {
        "events": len(trace),
        "host_tracks": len({ev["pid"] for ev in trace
                            if ev.get("ph") != "M" and ev.get("pid", 0) >= 1}),
        "span_generations": sorted({ev.get("tid") for ev in trace
                                    if ev.get("cat") == "span"}),
        "resize_markers": sum(ev.get("name") == "generation_resize"
                              for ev in trace),
    }


def finish_supervised(run: Supervised, timeout: float = 900.0) -> dict:
    """Wait for `run` (killed past `timeout`) and summarize its journal
    with `faults.goodput.elastic_summary`; raises `ResilienceGateError`
    when the supervisor exits nonzero."""
    import subprocess
    from pathlib import Path

    from dist_mnist_tpu_torch.faults.goodput import elastic_summary
    from dist_mnist_tpu_torch.obs import events as events_mod

    try:
        rc = run.proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        run.proc.kill()
        rc = run.proc.wait()
    wall = time.monotonic() - run.t0
    if rc != 0:
        tail = Path(run.log_path).read_text()[-3000:]
        raise ResilienceGateError(f"{run.tag} supervised run failed rc={rc}"
                                  f":\n{tail}")
    records = events_mod.read_journal(run.journal)
    summary = elastic_summary(records)
    summary.update(records=records, wall_s=wall,
                   journal_events=[r.get("event") for r in records],
                   journal_path=run.journal)
    return summary


def supervised_mlp(root: str, tag: str, data_dir: str, platform, *,
                   plan, elastic: bool, peer: bool = False, **kw) -> dict:
    """One supervised `mlp_mnist` run (`start_supervised`), waited for
    and summarized (`finish_supervised`)."""
    return finish_supervised(start_supervised(
        root, tag, data_dir, platform, plan=plan, elastic=elastic, peer=peer,
        **kw))


def _supervised_side(s: dict) -> dict:
    return {k: s[k] for k in ("goodput_fraction", "recovery_latency_s",
                              "total_wall_s", "productive_s", "generations",
                              "recoveries", "resizes", "final_step")}


def _data_dir_for_children(data_dir) -> str:
    from dist_mnist_tpu_torch.data.datasets import default_data_dir

    return str(data_dir or default_data_dir())


def run_ckpt(device: torch.device, *, dataset: Dataset | None = None,
             data_dir: str | None = None, n_steps: int = FAULTS_STEPS,
             ckpt_every: int = FAULTS_CKPT_EVERY, batch: int = FAULTS_BATCH,
             elastic_steps: int = ELASTIC_STEPS,
             kill_step: int = ELASTIC_KILL_STEP,
             elastic_batch: int = ELASTIC_BATCH,
             procs: int = ELASTIC_PROCS) -> dict:
    """`--ckpt`, two legs. LEG 1, in process: the same MLP run with
    cadence checkpoints saved synchronously, then through the
    `AsyncSnapshotter`; headline `save_stall_ms_per_step` is the async
    run's goodput `save` bucket per step. Gates: the trajectories equal
    bit for bit, every ``checkpoint_commit`` paired with its
    ``snapshot_fork``, the async stall below the sync one. LEG 2: the
    seeded `kill_host` plan under the elastic supervisor, checkpointing
    through ``--async_snapshot --peer_dir`` and through the plain store.
    Gates: both shrink and finish, the peer side restores from the ring
    (a ``peer_restore`` event, no store restore), both resume at the last
    cadence save before the kill, the peer restore below the store's, and
    whole-run recovery and goodput within the reference's rails of the
    store's."""
    import tempfile

    from dist_mnist_tpu_torch.faults.plan import Fault, FaultPlan
    from dist_mnist_tpu_torch.obs import events as events_mod

    metric = "save_stall_ms_per_step"
    dataset = dataset if dataset is not None else load_dataset(
        "mnist", data_dir, seed=SEED)
    state0 = faults_state(device, dataset)
    runs = {}
    with tempfile.TemporaryDirectory(prefix="bench_ckpt_") as root:
        for mode in ("sync", "async"):
            journal = f"{root}/journal_{mode}.jsonl"
            run = faults_run(device, dataset, state0, n_steps=n_steps,
                             batch=batch, ckpt_every=ckpt_every,
                             ckpt_dir=f"{root}/ckpt_{mode}",
                             async_save=mode == "async", journal=journal)
            run["journal"] = events_mod.read_journal(journal)
            run["snap"] = run["loop"].goodput.snapshot()
            runs[mode] = run
    sync, asyn = runs["sync"], runs["async"]
    identical = same_trajectory(sync["loss"], asyn["loss"])
    _gate(identical, "async-snapshot trajectory diverged from the "
                     "synchronous-save run")
    forks = _events(asyn["journal"], "snapshot_fork")
    commits = _events(asyn["journal"], "checkpoint_commit")
    _gate(bool(forks), "async run forked no snapshots")
    _gate(len(commits) == len(forks),
          f"{len(forks)} snapshot forks but {len(commits)} "
          "checkpoint_commit events: a dispatched save never became "
          "durable")
    _gate(all(isinstance(c.get("dur_ms"), (int, float)) and c["dur_ms"] >= 0
              for c in commits), f"bad commit spans: {commits}")
    sync_save_s, async_save_s = sync["snap"]["save_s"], asyn["snap"]["save_s"]
    _gate(async_save_s < sync_save_s,
          f"async save stall {async_save_s:.4f}s/run is not below the "
          f"synchronous baseline {sync_save_s:.4f}s/run")
    sync_ms = sync_save_s * 1e3 / n_steps
    async_ms = async_save_s * 1e3 / n_steps

    # -- leg 2: elastic peer-vs-store restore under the same kill plan
    plan = FaultPlan([Fault.kill_host(1, step=kill_step)])
    children_data = _data_dir_for_children(data_dir)
    platform = "cpu" if device.type == "cpu" else None
    with tempfile.TemporaryDirectory(prefix="bench_ckpt_elastic_") as root:
        common = dict(plan=plan, elastic=True, n_steps=elastic_steps,
                      batch=elastic_batch, ckpt_every=ckpt_every, procs=procs)
        pr = supervised_mlp(root, "peer", children_data, platform, peer=True,
                            **common)
        st = supervised_mlp(root, "store", children_data, platform, **common)
    for tag, s in (("peer", pr), ("store", st)):
        _gate(any(r["kind"] == "shrink" for r in s["resizes"]),
              f"{tag} run never shrank: {s['resizes']}")
        _gate(s["final_step"] == elastic_steps,
              f"{tag} run ended at step {s['final_step']}")
    peer_restores = _events(pr["records"], "peer_restore")
    _gate(bool(peer_restores), "peer run restored without a peer_restore "
                               "event: the ring never engaged")
    _gate(not _events(pr["records"], "checkpoint_restore"),
          "peer run fell back to the store ladder")
    store_restores = _events(st["records"], "checkpoint_restore")
    _gate(bool(store_restores), "store run journal shows no "
                                "checkpoint_restore")
    # both sides resume at the LAST cadence save before the kill: a
    # commit marker that lands late would roll back a further interval
    expected = (kill_step // ckpt_every) * ckpt_every
    for tag, ev in (("peer", peer_restores[-1]),
                    ("store", store_restores[-1])):
        _gate(ev["step"] == expected,
              f"{tag} run restored step {ev['step']}, expected {expected}")
    peer_ms, store_ms = peer_restores[-1]["dur_ms"], store_restores[-1][
        "dur_ms"]
    _gate(peer_ms < store_ms, f"peer restore ({peer_ms:.1f} ms) is not "
                              f"below the store restore ({store_ms:.1f} ms)")
    # coarse rails (the reference's): respawn and startup dominate both
    _gate(pr["recovery_latency_s"] <= st["recovery_latency_s"] + 1.5,
          f"peer recovery ({pr['recovery_latency_s']:.3f} s) is well above "
          f"the store's ({st['recovery_latency_s']:.3f} s)")
    _gate(pr["goodput_fraction"] >= st["goodput_fraction"] - 0.08,
          f"async+peer elastic goodput {pr['goodput_fraction']:.4f} fell "
          f"well below the store's {st['goodput_fraction']:.4f}")
    return {
        "metric": metric,
        "value": async_ms,
        "unit": "ms/step",
        "vs_baseline": sync_ms / async_ms if async_ms > 0 else 0.0,
        "synthetic_data": bool(dataset.synthetic),
        "extra": {
            "device": str(device),
            "chips": 1,
            "global_batch": batch,
            "steps": n_steps,
            "ckpt_every_steps": ckpt_every,
            "sync_save_ms_per_step": sync_ms,
            "async_save_ms_per_step": async_ms,
            "save_removed_ms_per_step": sync_ms - async_ms,
            "saves_per_run": len(commits),
            "trajectory_identical": identical,
            "fork_ms_mean": _mean([f["fork_ms"] for f in forks]),
            "sync_commit_ms_mean": _mean([
                c["dur_ms"] for c in _events(sync["journal"],
                                             "checkpoint_commit")]),
            "async_commit_ms_mean": _mean([c["dur_ms"] for c in commits]),
            "write_behind": asyn["writer"],
            "elastic": {
                "processes": procs,
                "devices_per_process": 1,
                "global_batch": elastic_batch,
                "steps": elastic_steps,
                "kill_step": kill_step,
                "peer_restore_ms": peer_ms,
                "store_restore_ms": store_ms,
                "restore_speedup": store_ms / peer_ms if peer_ms > 0 else 0.0,
                "peer_restore_sources": peer_restores[-1].get("sources"),
                "peer": _supervised_side(pr),
                "store_baseline": _supervised_side(st),
                "goodput_vs_store": (
                    pr["goodput_fraction"] / st["goodput_fraction"]
                    if st["goodput_fraction"] > 0 else 0.0),
            },
        },
    }


def run_faults_elastic(device: torch.device, *, data_dir: str | None = None,
                       n_steps: int = ELASTIC_STEPS,
                       kill_step: int = ELASTIC_KILL_STEP,
                       ckpt_every: int = FAULTS_CKPT_EVERY,
                       batch: int = ELASTIC_BATCH,
                       procs: int = ELASTIC_PROCS) -> dict:
    """`--faults --elastic`: the seeded permanent loss of a non-chief host
    (`kill_host`: the victim SIGKILLs itself at `kill_step`) under two
    supervisors, and whole-run goodput (`elastic_summary`): ELASTIC
    (exclude the host, re-form at the surviving world, no backoff) against
    the restart-the-world baseline (the kill fires in generation 0 only,
    so the baseline models a host that comes back at once). Headline
    `elastic_goodput_fraction`; vs_baseline is elastic/restart. Gates
    (the reference's): both finish every step, the elastic journal shows
    one shrink and no restart, the baseline a restart and no resize, and
    the elastic fraction is above the restart one.

    The elastic side also runs the fleet observability path
    (`start_supervised(fleet_obs=True)`: the children's `/metrics` and
    span records, the supervisor's fleet scraper), and its journal is
    merged into a chrome trace (`fleet_trace_stats`), gated as the
    reference's: a track per host (>= procs), the shrink's resize marker,
    and span records in two generations or more, i.e. correlated step
    tracing survives the resize. The trace's counts ride along as
    ``fleet_trace``."""
    import tempfile

    from dist_mnist_tpu_torch.faults.plan import Fault, FaultPlan

    metric = "elastic_goodput_fraction"
    plan = FaultPlan([Fault.kill_host(1, step=kill_step)])
    dataset = load_dataset("mnist", data_dir, seed=SEED)  # cache the twin
    children_data = _data_dir_for_children(data_dir)
    platform = "cpu" if device.type == "cpu" else None
    common = dict(plan=plan, n_steps=n_steps, batch=batch,
                  ckpt_every=ckpt_every, procs=procs)
    with tempfile.TemporaryDirectory(prefix="bench_elastic_") as root:
        el = supervised_mlp(root, "elastic", children_data, platform,
                            elastic=True, fleet_obs=True, **common)
        rs = supervised_mlp(root, "restart", children_data, platform,
                            elastic=False, **common)
        trace = fleet_trace_stats(el["journal_path"])
    _gate(any(r["kind"] == "shrink" and r["old_world"] == procs
              and r["new_world"] == procs - 1 for r in el["resizes"]),
          f"elastic run never shrank {procs} -> {procs - 1}: "
          f"{el['resizes']}")
    _gate("supervisor_restart" not in el["journal_events"],
          "elastic run fell back to a full-world restart")
    _gate("supervisor_restart" in rs["journal_events"],
          "baseline never restarted: the fault did not engage")
    _gate(not rs["resizes"], f"baseline resized: {rs['resizes']}")
    for tag, s in (("elastic", el), ("restart", rs)):
        _gate(s["final_step"] == n_steps,
              f"{tag} run ended at step {s['final_step']}")
    el_frac, rs_frac = el["goodput_fraction"], rs["goodput_fraction"]
    _gate(el_frac > rs_frac, f"elastic goodput {el_frac:.4f} did not beat "
                             f"the restart baseline {rs_frac:.4f}")
    # correlated step tracing must survive the resize
    _gate(trace["host_tracks"] >= procs,
          f"fleet trace holds {trace['host_tracks']} host tracks, wanted "
          f">= {procs}")
    _gate(trace["resize_markers"] >= 1,
          "no resize marker in the merged fleet trace")
    _gate(len(trace["span_generations"]) >= 2,
          f"span records did not straddle the resize: generations "
          f"{trace['span_generations']}")
    return {
        "metric": metric,
        "value": el_frac,
        "unit": "fraction",
        "vs_baseline": el_frac / rs_frac if rs_frac > 0 else 0.0,
        "synthetic_data": bool(dataset.synthetic),
        "extra": {
            "device": str(device),
            "chips": 1,
            "processes": procs,
            "devices_per_process": 1,
            "global_batch": batch,
            "steps": n_steps,
            "kill_step": kill_step,
            "ckpt_every_steps": ckpt_every,
            "elastic": _supervised_side(el),
            "restart_baseline": _supervised_side(rs),
            "recovery_speedup": (
                rs["recovery_latency_s"] / el["recovery_latency_s"]
                if el["recovery_latency_s"] > 0 else 0.0),
            # the merged chrome trace of the elastic run
            "fleet_trace": trace,
        },
    }


#: the attribution modes' geometry, the reference's (`bench.py --input`,
#: `--coldstart`, `--memory`, `--overlap`)
INPUT_BATCH, INPUT_WARMUP = 1024, 5
COLDSTART_STEPS, COLDSTART_BATCH = 20, 16
#: the prefix of `--coldstart`'s pair directory (the test suite's stray
#: temp-dir check globs the reference's own ``bench_coldstart_``)
COLDSTART_PREFIX = "dist_mnist_torch_coldstart_"
OVERLAP_BATCH, OVERLAP_WARMUP, OVERLAP_BUCKET_MB = 512, 3, 1.0
#: what a store gate reads where nothing was built (the CPU)
NOT_APPLICABLE = "not applicable: nothing was built (no kernel on the cpu)"


class AttributionGateError(RuntimeError):
    """An attribution bench's hard gate failed (the reference's assert)."""


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _hex(losses) -> list[str]:
    """Device loss scalars as exact float32 hex (one host transfer)."""
    vals = torch.stack([x.detach().to(torch.float32) for x in losses]).cpu()
    return [np.float32(v).tobytes().hex() for v in vals.numpy()]


def _unhex(h: str) -> float:
    """The float32 a `_hex` string holds."""
    return float(np.frombuffer(bytes.fromhex(h), np.float32)[0])


def run_input(device: torch.device, n_timed: int, *, depth: int = 2,
              batch: int = INPUT_BATCH, warmup: int = INPUT_WARMUP,
              dataset: Dataset | None = None) -> dict:
    """`--input`: the same model and stream timed twice, fed by the
    synchronous host batcher (each batch's copy to the device issued in
    the loop) and through `DevicePrefetcher` (`depth` copies ahead on a
    side stream): `input_stall_ms_per_step`, the prefetched feed's
    residual wait, with both feeds' numbers. Both runs start from the
    same state bits over the same stream, so their trajectories are bit
    for bit the same (a gate)."""
    from dist_mnist_tpu_torch.checkpoint.snapshot import fork_state
    from dist_mnist_tpu_torch.data.pipeline import ShardedBatcher
    from dist_mnist_tpu_torch.data.prefetch import DevicePrefetcher
    from dist_mnist_tpu_torch.train import make_train_step

    metric = "input_stall_ms_per_step"
    dataset = dataset if dataset is not None else load_dataset("mnist",
                                                               seed=SEED)
    model, optimizer = get_model("mlp"), optim.adam(1e-3)
    state0 = create_train_state(model, optimizer, SEED,
                                dataset.train_images[:1], device)
    step = make_train_step(model, optimizer)

    def timed_feed(batches) -> dict:
        it = iter(batches)
        state = fork_state(state0)
        try:
            for _ in range(warmup):
                state, out = step(state, next(it))
            out["loss"].item()  # fence: the warm-up off the clock
            feed_s, losses = 0.0, []
            t0 = time.monotonic()
            for _ in range(n_timed):
                f0 = time.monotonic()
                b = next(it)
                feed_s += time.monotonic() - f0
                state, out = step(state, b)
                losses.append(out["loss"])
            traj = _hex(losses)  # the stop-clock fetch
            wall_s = time.monotonic() - t0
        finally:
            if hasattr(it, "close"):
                it.close()
        return {"wall_s": wall_s, "feed_s": feed_s, "losses": traj,
                "loss": _unhex(traj[-1])}

    sync = timed_feed(ShardedBatcher(dataset, batch, device, seed=0))
    pre_src = DevicePrefetcher(ShardedBatcher(dataset, batch, device,
                                              seed=0), depth=depth)
    try:
        pre = timed_feed(pre_src)
        pre_stats = pre_src.stats()
    finally:
        pre_src.close()
    identical = sync["losses"] == pre["losses"]
    _gate(identical, "the prefetched feed's trajectory is not the "
                     "synchronous one's: the prefetcher reordered or "
                     "dropped a batch", AttributionGateError)

    def ms(sec):
        return sec / n_timed * 1e3

    return {
        "metric": metric,
        "value": ms(pre["feed_s"]),
        "unit": "ms/step",
        "vs_baseline": 0.0,  # attribution metric: no published reference
        "synthetic_data": bool(dataset.synthetic),
        "extra": {
            "device": str(device),
            "chips": 1,
            "global_batch": batch,
            "depth": depth,
            "timed_steps": n_timed,
            "sync_stall_ms_per_step": ms(sync["feed_s"]),
            "prefetched_stall_ms_per_step": ms(pre["feed_s"]),
            "stall_reduction_ms_per_step": ms(sync["feed_s"]
                                              - pre["feed_s"]),
            "sync_steps_per_sec": n_timed / sync["wall_s"],
            "prefetched_steps_per_sec": n_timed / pre["wall_s"],
            "mean_ring_occupancy": pre_stats["mean_occupancy"],
            "h2d_mbytes_per_step": pre_stats["h2d_bytes"] / max(
                1, pre_stats["batches"]) / 2**20,
            "loss_sync": sync["loss"],
            "loss_prefetched": pre["loss"],
            "trajectory_identical": identical,
        },
    }


def coldstart_child(cache_dir: str, n_steps: int, device: torch.device,
                    data_dir: str | None = None) -> dict:
    """One measured process of the cold/warm pair (`--coldstart-child`):
    LeNet-5 under ``optim.adam(1e-3, fused=True)`` with the store in
    `cache_dir` enabled, `n_steps` steps at batch 16 from the seeded init;
    time to first step, the `StartupClock` buckets, the store's stats,
    the fused Adam's launches and the loss trajectory as exact float32
    hex (the parent compares the pair's bits)."""
    from dist_mnist_tpu_torch.compilecache import (
        StartupClock,
        enable_persistent_cache,
    )
    from dist_mnist_tpu_torch.data.pipeline import ShardedBatcher
    from dist_mnist_tpu_torch.ops.kernels import (
        launch_counts,
        reset_launch_counts,
    )
    from dist_mnist_tpu_torch.train import make_train_step

    clock = StartupClock(t0=_T0)
    clock.note("import", time.monotonic() - _T0)
    with clock.phase("init"):
        cache = enable_persistent_cache(cache_dir)
        dataset = load_dataset("mnist", data_dir, seed=SEED)
        model = get_model("lenet5")
        optimizer = optim.adam(1e-3, fused=True)
        state = create_train_state(model, optimizer, SEED,
                                   dataset.train_images[:1], device)
        step = make_train_step(model, optimizer)
        it = iter(ShardedBatcher(dataset, COLDSTART_BATCH, device, seed=0))
    reset_launch_counts()
    losses = []
    state, out = step(state, next(it))
    out["loss"].item()  # fence: the first step finished
    clock.first_step_done()
    # the build or load the first step paid, attributed after the freeze:
    # first_step is the residual at snapshot time
    clock.note("compile", step.consume_compile_s())
    losses.append(out["loss"])
    for _ in range(n_steps - 1):
        state, out = step(state, next(it))
        losses.append(out["loss"])
    traj = _hex(losses)
    snap = clock.snapshot()
    stats = cache.stats()
    return {"time_to_first_step_ms": snap["time_to_first_step_ms"],
            "startup": snap, "cache": stats, "builds": stats["builds"],
            "launches": launch_counts()["fused_adam_update"],
            "losses": traj}


def run_coldstart_child(pair_dir: str, n_steps: int, device: torch.device,
                        data_dir: str | None = None,
                        timeout_s: float = 600.0) -> dict:
    """`coldstart_child` in a fresh process (``python -m
    dist_mnist_tpu_torch.bench --coldstart-child=<pair_dir>``); its JSON
    record. Raises `AttributionGateError` when it fails."""
    import subprocess
    import sys

    from dist_mnist_tpu_torch.cli.launch import _child_env

    cmd = [sys.executable, "-m", "dist_mnist_tpu_torch.bench",
           f"--coldstart-child={pair_dir}", f"--coldstart-steps={n_steps}",
           f"--device={device}",
           *([f"--data_dir={data_dir}"] if data_dir else [])]
    out = subprocess.run(cmd, capture_output=True, text=True,
                         timeout=timeout_s, env=_child_env())
    if out.returncode != 0:
        raise AttributionGateError(
            f"coldstart child rc={out.returncode}: "
            f"{out.stderr.strip()[-2000:]}")
    for line in reversed(out.stdout.strip().splitlines()):
        try:
            return json.loads(line)
        except ValueError:
            continue
    raise AttributionGateError("coldstart child printed no JSON line")


def run_coldstart(device: torch.device, n_steps: int = COLDSTART_STEPS, *,
                  data_dir: str | None = None, pair_dir: str | None = None,
                  timeout_s: float = 600.0) -> dict:
    """`--coldstart`: the same short run in two fresh processes sharing
    one store directory, the first cold (builds, saves), the second warm
    (loads what the first saved): `time_to_first_step_ms` (warm, what a
    supervisor's restart pays) with the cold one, the build ms the warm
    process did not pay and both `StartupClock` snapshots. Gates: the
    warm process hit the store, beat the cold time, and trained the same
    bits. Without a build (the CPU) the store gates are not applicable
    and say so. `pair_dir` (a fresh one named `COLDSTART_PREFIX`...
    when None, removed at the end) holds the store."""
    import shutil
    import tempfile

    metric = "time_to_first_step_ms"
    load_dataset("mnist", data_dir, seed=SEED)  # the children read its cache
    owned = pair_dir is None
    if owned:
        pair_dir = tempfile.mkdtemp(prefix=COLDSTART_PREFIX)
    try:
        cold = run_coldstart_child(pair_dir, n_steps, device, data_dir,
                                   timeout_s)
        warm = run_coldstart_child(pair_dir, n_steps, device, data_dir,
                                   timeout_s)
    finally:
        if owned:
            shutil.rmtree(pair_dir, ignore_errors=True)
    identical = warm["losses"] == cold["losses"]
    _gate(identical, "the warm trajectory diverged from the cold one: the "
                     "loaded library is not the one that was built",
          AttributionGateError)
    cold_ms = cold["time_to_first_step_ms"]
    warm_ms = warm["time_to_first_step_ms"]
    built = cold["builds"] > 0
    if built:
        _gate(warm["cache"]["hits"] > 0,
              f"the warm process missed the store: {warm['cache']}",
              AttributionGateError)
        _gate(warm_ms < cold_ms, f"warm start ({warm_ms:.0f} ms) not faster "
                                 f"than cold ({cold_ms:.0f} ms)",
              AttributionGateError)
    return {
        "metric": metric,
        "value": warm_ms,
        "unit": "ms",
        "vs_baseline": 0.0,  # startup metric: no published reference
        "extra": {
            "device": str(device),
            "cold_ms": cold_ms,
            "warm_ms": warm_ms,
            # build wall time the warm process did not pay, as the cold
            # process recorded it when it saved the entry
            "restart_compile_saved_ms": warm["cache"]["compile_ms_saved"],
            "ttfs_saved_ms": cold_ms - warm_ms,
            "steps": n_steps,
            "builds": cold["builds"],
            "warm_hits": warm["cache"]["hits"],
            "hit_gate": "passed" if built else NOT_APPLICABLE,
            "warm_beats_cold_gate": "passed" if built else NOT_APPLICABLE,
            "trajectory_identical": identical,
            "losses": cold["losses"],  # float32 hex, the pair's shared bits
            "launches_fused_adam_update": [cold["launches"],
                                           warm["launches"]],
            "cold_startup": cold["startup"],
            "warm_startup": warm["startup"],
            "cold_cache": cold["cache"],
            "warm_cache": warm["cache"],
            "departure": "the child trains with the fused Adam kernel "
                         "(the reference's child compiles its unfused "
                         "Adam's XLA step)",
        },
    }


def _rank_mesh(device: torch.device):
    """The data mesh over every rank of the process group (one rank
    without one)."""
    from dist_mnist_tpu_torch.cluster.mesh import MeshSpec, make_mesh

    return make_mesh(MeshSpec(data=-1), device=device)


def run_memory(device: torch.device, name: str | None = None, *,
               data_dir: str | None = None, mesh=None) -> dict | None:
    """`--memory`: per-rank resident state under dp and under fsdp on
    this world's ranks (`state_memory_bytes` from the shard shapes), and
    one training step's peak allocated bytes under each (`step_peak`,
    the card only). The headline is fsdp's param + optimizer bytes a
    rank; `reduction_x` the dp/fsdp ratio. The chief returns the record,
    the other ranks None."""
    from dist_mnist_tpu_torch.checkpoint.snapshot import fork_state
    from dist_mnist_tpu_torch.cluster import coordination
    from dist_mnist_tpu_torch.parallel.sharding import (
        DP_RULES,
        FSDP_RULES,
        shard_train_state,
    )
    from dist_mnist_tpu_torch.train import make_train_step

    cfg = CONFIGS[name or "lenet5_mnist"]
    mesh = mesh if mesh is not None else _rank_mesh(device)
    n = mesh.size
    dataset = load_dataset(cfg.dataset, data_dir, seed=cfg.seed)
    model = get_model(cfg.model, **cfg.model_kwargs)
    optimizer = optim.build_optimizer(cfg)
    loss_fn = (losses.clipped_softmax_cross_entropy if cfg.loss == "clipped"
               else losses.softmax_cross_entropy)
    # state bytes do not depend on the batch: keep the step small but the
    # batch divisible over the data ranks
    batch_size = max(1, min(cfg.batch_size, 512) // n) * n
    local = batch_size // n
    rows = slice(mesh.rank * local, (mesh.rank + 1) * local)
    batch = {"image": torch.from_numpy(np.ascontiguousarray(
                 dataset.train_images[:batch_size][rows])).to(device),
             "label": torch.from_numpy(np.ascontiguousarray(
                 dataset.train_labels[:batch_size][rows],
                 np.int32)).to(device)}
    base = create_train_state(model, optimizer, 0, dataset.train_images[:1],
                              device)
    per = {}
    for label, rules in (("dp", DP_RULES), ("fsdp", FSDP_RULES)):
        state = shard_train_state(fork_state(base), mesh, rules)
        step = make_train_step(model, optimizer, mesh=mesh, rules=rules,
                               loss_fn=loss_fn, remat=cfg.remat,
                               remat_policy=cfg.remat_policy)
        entry = dict(state_memory_bytes(state))
        if device.type == "cuda":
            _sync(device)
            torch.cuda.reset_peak_memory_stats(device)
            state, out = step(state, batch)
            out["loss"].item()
            entry["step_peak"] = {
                "peak_allocated_bytes": torch.cuda.max_memory_allocated(
                    device)}
        per[label] = entry
    if not coordination.is_chief():
        return None

    def resident(e):
        return e["param_bytes"] + e["opt_state_bytes"]

    value = resident(per["fsdp"])
    return {
        "metric": "fsdp_per_device_state_bytes",
        "value": float(value),
        "unit": "bytes/device",
        "vs_baseline": 0.0,  # attribution metric: no published reference
        "synthetic_data": bool(dataset.synthetic),
        "extra": {
            "device": str(device),
            "chips": n,
            "config": cfg.name,
            "global_batch": batch_size,
            "dp": per["dp"],
            "fsdp": per["fsdp"],
            "reduction_x": resident(per["dp"]) / max(1, value),
            "fsdp_over_dp": value / max(1, resident(per["dp"])),
            "note": "param_bytes/opt_state_bytes are per-rank RESIDENT "
                    "state from shard shapes; 'step_peak' is one training "
                    "step's torch.cuda.max_memory_allocated after "
                    "reset_peak_memory_stats (the reference reads XLA's "
                    "compiled memory analysis; a stated departure)",
        },
    }


#: the collective counters `--overlap` reports a step
_OVERLAP_CALLS = ("all_gather_calls", "reduce_scatter_calls",
                  "all_reduce_calls", "ring_shift_calls")


def run_overlap(device: torch.device, n_timed: int, *,
                bucket_mb: float = OVERLAP_BUCKET_MB,
                batch: int = OVERLAP_BATCH, warmup: int = OVERLAP_WARMUP,
                data_dir: str | None = None, mesh=None) -> dict | None:
    """`--overlap`: the same FSDP model timed twice on this world's ranks,
    through the serial twin (every gather before the forward, every flush
    after the whole backward: all communication exposed) and through the
    overlapped bucket schedule (`parallel/overlap.py`):
    `comm_exposed_ms_per_step` = serial - overlapped step time. Both are
    the same values moved through the same collectives, so their
    trajectories are asserted bit for bit; each variant's collective
    calls a step (`collective_stats`) are the chunk-structure evidence
    (`chunked`: gathers >= buckets and a gradient reduction). On one rank
    it reports the reference's honest zero. The chief returns the record,
    the other ranks None."""
    from dist_mnist_tpu_torch.checkpoint.snapshot import fork_state
    from dist_mnist_tpu_torch.cluster import coordination
    from dist_mnist_tpu_torch.data.pipeline import ShardedBatcher
    from dist_mnist_tpu_torch.parallel.collectives import collective_stats
    from dist_mnist_tpu_torch.parallel.overlap import (
        OverlapConfig,
        plan_stats,
    )
    from dist_mnist_tpu_torch.parallel.sharding import (
        FSDP_RULES,
        shard_train_state,
    )
    from dist_mnist_tpu_torch.train import make_train_step
    from dist_mnist_tpu_torch.train.state import params_digest

    metric = "comm_exposed_ms_per_step"
    mesh = mesh if mesh is not None else _rank_mesh(device)
    n = mesh.size
    if n < 2:
        # one rank moves no FSDP communication: the honest report is 0
        return {
            "metric": metric,
            "value": 0.0,
            "unit": "ms/step",
            "vs_baseline": 0.0,
            "extra": {"device": str(device), "chips": n,
                      "single_chip": True,
                      "note": "no fsdp communication exists on one rank; "
                              "nothing to overlap"},
        }
    dataset = load_dataset("mnist", data_dir, seed=SEED)
    # a hidden width the data ranks divide, so the fsdp rule splits both
    # matrices
    hidden = max(64, 64 * n)
    model, optimizer = get_model("mlp", hidden_units=hidden), optim.adam(1e-3)
    state0 = shard_train_state(
        create_train_state(model, optimizer, SEED, dataset.train_images[:1],
                           device), mesh, FSDP_RULES)
    stats = plan_stats(state0.params, mesh, FSDP_RULES,
                       OverlapConfig(bucket_mb=bucket_mb),
                       specs=state0.placement.specs.params)
    counters = collective_stats(mesh)

    def timed_variant(cfg) -> dict:
        step = make_train_step(model, optimizer, mesh=mesh, rules=FSDP_RULES,
                               overlap=cfg)
        it = iter(ShardedBatcher(dataset, batch, device, seed=0, mesh=mesh))
        state = fork_state(state0)
        for _ in range(warmup):
            state, out = step(state, next(it))
        out["loss"].item()  # fence: the warm-up off the clock
        before = dict(counters)
        losses_ = []
        t0 = time.monotonic()
        for _ in range(n_timed):
            state, out = step(state, next(it))
            losses_.append(out["loss"])
        traj = _hex(losses_)  # the stop-clock fetch
        wall_s = time.monotonic() - t0
        return {"ms": wall_s / n_timed * 1e3, "losses": traj,
                "digest": params_digest(state.params),
                "collectives": {k: (counters[k] - before.get(k, 0)) / n_timed
                                for k in _OVERLAP_CALLS}}

    serial = timed_variant(OverlapConfig(bucket_mb=bucket_mb, serial=True))
    over = timed_variant(OverlapConfig(bucket_mb=bucket_mb))
    identical = (serial["losses"] == over["losses"]
                 and serial["digest"] == over["digest"])
    _gate(identical, "the overlapped trajectory is not the serial twin's "
                     "bit for bit: the schedule changed the math",
          AttributionGateError)
    oc, n_buckets = over["collectives"], stats["buckets"]
    # chunk structure: the overlapped step gathers bucket by bucket (at
    # least one gather a bucket) and reduces the gradients collectively
    chunked = (oc["all_gather_calls"] + oc["ring_shift_calls"] >= n_buckets
               and oc["reduce_scatter_calls"] + oc["all_reduce_calls"] > 0)
    if not coordination.is_chief():
        return None
    return {
        "metric": metric,
        "value": max(0.0, serial["ms"] - over["ms"]),
        "unit": "ms/step",
        "vs_baseline": 0.0,  # attribution metric: no published reference
        "synthetic_data": bool(dataset.synthetic),
        "extra": {
            "device": str(device),
            "chips": n,
            "global_batch": batch,
            "timed_steps": n_timed,
            "hidden_units": hidden,
            "bucket_mb": bucket_mb,
            "n_buckets": n_buckets,
            "plan": stats,
            "gathered_mbytes_per_step": stats["gathered_bytes"] / 2**20,
            "serial_ms_per_step": serial["ms"],
            "overlapped_ms_per_step": over["ms"],
            "serial_collectives": serial["collectives"],
            "overlapped_collectives": oc,
            "chunked": chunked,
            "timing_resolves_overlap": serial["ms"] > over["ms"],
            "loss_serial": _unhex(serial["losses"][-1]),
            "loss_overlapped": _unhex(over["losses"][-1]),
            "trajectory_identical": identical,
        },
    }


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m dist_mnist_tpu_torch.bench",
        description="LeNet-5 MNIST training throughput and accuracy race; "
                    "with --config, one ladder config's training "
                    "throughput; with --serve, classifier serving latency "
                    "(--quant: int8 next to float; --longctx: the ViT's "
                    "variable-height grid; --decode: decode serving)")
    p.add_argument("--device", default=None,
                   help="cuda (default), cuda:N, or cpu")
    p.add_argument("--config", default=None,
                   help="a ladder config to time (e.g. vit_tiny_cifar_flash)"
                        f"; the port has {sorted(CONFIGS)}")
    p.add_argument("--serve", action="store_true",
                   help="a serving benchmark: alone, mlp_mnist's p99 "
                        "latency (one JSON line); the reference's --fleet "
                        "and --autoscale join with ROADMAP §1 item 15")
    p.add_argument("--quant", action="store_true",
                   help="with --serve: a float and an int8 mlp_mnist engine "
                        "on one stream (two JSON lines)")
    p.add_argument("--longctx", action="store_true",
                   help="with --serve: vit_tiny_cifar behind the auto "
                        "height ladder under variable-height traffic "
                        "(one JSON line)")
    p.add_argument("--decode", action="store_true",
                   help="with --serve: decode serving of the causal LM "
                        "(continuous vs static, then the dense / paged / "
                        "int8-paged capacity trio); three JSON lines")
    p.add_argument("--requests", type=int, default=512,
                   help="--serve: requests per timed run")
    p.add_argument("--concurrency", type=int, default=64,
                   help="--serve: loadgen in-flight window")
    p.add_argument("--race_rounds", type=int, default=40,
                   help="accuracy-race rounds of two chunks each")
    p.add_argument("--steps", type=int, default=2000,
                   help="timed steady-state steps")
    p.add_argument("--data_dir", default=None,
                   help="the dataset's files, or where its synthetic twin "
                        "is cached (default: <temp dir>/mnist-data)")
    p.add_argument("--faults", action="store_true",
                   help="resilience: recovery_latency_ms of the MLP under a "
                        "preemption and a corrupted checkpoint (one JSON "
                        "line); with --elastic, elastic_goodput_fraction of "
                        "a supervised two-rank run losing a host")
    p.add_argument("--async-save", dest="async_save", action="store_true",
                   help="with --faults: checkpoint through the "
                        "AsyncSnapshotter")
    p.add_argument("--elastic", action="store_true",
                   help="with --faults: the elastic supervisor against the "
                        "restart-the-world one")
    p.add_argument("--ckpt", action="store_true",
                   help="checkpoint cost: save_stall_ms_per_step, sync vs "
                        "the AsyncSnapshotter, then the peer ring against "
                        "the store under the elastic supervisor")
    # -- the attribution modes
    p.add_argument("--input", action="store_true",
                   help="input-stall attribution: the synchronous feed vs "
                        "the device-prefetched one on the same model and "
                        "stream (input_stall_ms_per_step)")
    p.add_argument("--prefetch-depth", dest="prefetch_depth", type=int,
                   default=2, help="prefetch ring depth in --input mode")
    p.add_argument("--coldstart", action="store_true",
                   help="cold start: the same short run in a cold process "
                        "then a warm one sharing a kernel store "
                        "(time_to_first_step_ms)")
    p.add_argument("--coldstart-child", dest="coldstart_child", default=None,
                   metavar="STORE_DIR", help=argparse.SUPPRESS)
    p.add_argument("--coldstart-steps", dest="coldstart_steps", type=int,
                   default=COLDSTART_STEPS,
                   help="steps per process in --coldstart mode")
    p.add_argument("--memory", action="store_true",
                   help="per-rank resident state, dp vs fsdp, and one "
                        "step's peak bytes (fsdp_per_device_state_bytes); "
                        "--config picks the config (default lenet5_mnist)")
    p.add_argument("--overlap", action="store_true",
                   help="the serial fsdp schedule vs the overlapped bucket "
                        "schedule on the same model and stream "
                        "(comm_exposed_ms_per_step)")
    p.add_argument("--bucket-mb", dest="bucket_mb", type=float,
                   default=OVERLAP_BUCKET_MB,
                   help="overlap bucket size (MiB) in --overlap mode")
    # -- what cli.launch passes each rank (--memory, --overlap)
    p.add_argument("--coordinator_address", default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--num_processes", type=int, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--process_id", type=int, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--platform", default=None, choices=["cpu", "gpu"],
                   help=argparse.SUPPRESS)
    return p


def _attribution_mode(args) -> str | None:
    """The attribution benchmark the flags name, or None; exits on two
    at once or on a modifier without its mode."""
    modes = [m for m in ("input", "coldstart", "memory", "overlap")
             if getattr(args, m)]
    if len(modes) > 1:
        raise SystemExit(f"error: one of --input, --coldstart, --memory, "
                         f"--overlap at a time, got "
                         f"{', '.join('--' + m for m in modes)}")
    if args.num_processes and args.num_processes > 1 and modes[:1] not in (
            ["memory"], ["overlap"]):
        raise SystemExit("error: only --memory and --overlap run on the "
                         "ranks of a launch")
    return modes[0] if modes else None


def _run_attribution(args, mode: str):
    """Run an attribution mode on this process's device (a launched
    rank's when --num_processes > 1) and print its record (the chief's
    only); a failed gate prints an `error` line and exits 1."""
    from dist_mnist_tpu_torch.cluster import coordination

    metric = {"input": "input_stall_ms_per_step",
              "coldstart": "time_to_first_step_ms",
              "memory": "fsdp_per_device_state_bytes",
              "overlap": "comm_exposed_ms_per_step"}[mode]
    cpu = args.platform == "cpu" or args.device == "cpu"
    try:
        ctx = coordination.initialize_distributed(
            args.coordinator_address, args.num_processes, args.process_id,
            platform="cpu" if cpu else None)
        device = (ctx.device if ctx is not None
                  else resolve_device("cpu" if cpu else args.device))
    except (RuntimeError, ValueError) as err:
        raise SystemExit(f"error: {err}") from None
    try:
        if mode == "input":
            record = run_input(device, args.steps, depth=args.prefetch_depth,
                               dataset=load_dataset("mnist", args.data_dir,
                                                    seed=SEED))
        elif mode == "coldstart":
            record = run_coldstart(device, args.coldstart_steps,
                                   data_dir=args.data_dir)
        elif mode == "memory":
            record = run_memory(device, args.config, data_dir=args.data_dir)
        else:
            record = run_overlap(device, min(args.steps, 60),
                                 bucket_mb=args.bucket_mb,
                                 data_dir=args.data_dir)
    except AttributionGateError as err:
        print(json.dumps({"metric": metric, "value": 0.0,
                          "error": str(err)}), flush=True)
        raise SystemExit(1) from None
    finally:
        coordination.shutdown()
    if record is not None:
        print(json.dumps(record), flush=True)
    return record


def _serve_mode(args) -> str | None:
    """The serving benchmark the flags name, or None without --serve;
    exits on a mode flag without --serve or on two modes."""
    modes = [m for m in ("quant", "longctx", "decode") if getattr(args, m)]
    if not args.serve:
        if modes:
            raise SystemExit(f"error: --{modes[0]} takes --serve")
        return None
    if len(modes) > 1:
        raise SystemExit(f"error: one serving mode at a time, got "
                         f"{', '.join('--' + m for m in modes)}")
    return modes[0] if modes else "serve"


def _resilience_mode(args) -> str | None:
    """The resilience benchmark the flags name, or None; exits on a
    modifier without its mode or on two modes at once."""
    if args.async_save and not args.faults:
        raise SystemExit("error: --async-save takes --faults")
    if args.elastic and not args.faults:
        raise SystemExit("error: --elastic takes --faults")
    if args.faults and args.ckpt:
        raise SystemExit("error: one of --faults, --ckpt at a time")
    if args.faults and args.elastic and args.async_save:
        raise SystemExit("error: --async-save is not a mode of --faults "
                         "--elastic")
    if args.ckpt:
        return "ckpt"
    if args.faults:
        return "elastic" if args.elastic else "faults"
    return None


def main(argv=None):
    """Runs the mode the flags name and prints its JSON line(s); returns
    the headline or config record, or the list of serving records."""
    args = build_parser().parse_args(argv)
    if args.coldstart_child:
        # one measured process of --coldstart's pair
        try:
            device = resolve_device(args.device)
        except RuntimeError as err:
            raise SystemExit(f"error: {err}") from None
        record = coldstart_child(args.coldstart_child, args.coldstart_steps,
                                 device, args.data_dir)
        print(json.dumps(record), flush=True)
        return record
    mode = _serve_mode(args)
    resilience = _resilience_mode(args)
    attribution = _attribution_mode(args)
    if resilience is not None and (mode is not None
                                   or args.config is not None):
        raise SystemExit("error: a resilience mode runs alone")
    if attribution is not None:
        if mode is not None or resilience is not None or (
                args.config is not None and attribution != "memory"):
            raise SystemExit("error: an attribution mode runs alone "
                             "(--memory takes --config)")
        if args.config is not None and args.config not in CONFIGS:
            raise SystemExit(f"error: unknown config {args.config!r}; the "
                             f"port has {sorted(CONFIGS)}")
        return _run_attribution(args, attribution)
    if args.config is not None and args.config not in CONFIGS:
        raise SystemExit(f"error: unknown config {args.config!r}; the port "
                         f"has {sorted(CONFIGS)}")
    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        raise SystemExit(f"error: {err}") from None
    if resilience is not None:
        metric = {"faults": "recovery_latency_ms",
                  "ckpt": "save_stall_ms_per_step",
                  "elastic": "elastic_goodput_fraction"}[resilience]
        try:
            if resilience == "faults":
                record = run_faults(device, dataset=load_dataset(
                    "mnist", args.data_dir, seed=SEED),
                    async_save=args.async_save)
            elif resilience == "ckpt":
                record = run_ckpt(device, data_dir=args.data_dir)
            else:
                record = run_faults_elastic(device, data_dir=args.data_dir)
        except ResilienceGateError as err:
            print(json.dumps({"metric": metric, "value": 0.0,
                              "error": str(err)}), flush=True)
            raise SystemExit(1) from None
        print(json.dumps(record), flush=True)
        return record
    if mode is not None:
        run, metric = {
            "serve": (run_serve, "serve_p99_latency_ms"),
            "quant": (run_serve_quant, "quant_p99_ms"),
            "longctx": (run_serve_longctx, "longctx_p99_ms"),
            "decode": (run_serve_decode, "decode_ttft_p99_ms"),
        }[mode]
        try:
            records = run(device, args.requests, args.concurrency)
        except (ServeGateError, DecodeGateError) as err:
            print(json.dumps({"metric": metric, "value": 0.0,
                              "error": str(err)}), flush=True)
            raise SystemExit(1) from None
        records = records if isinstance(records, list) else [records]
        for record in records:
            print(json.dumps(record), flush=True)
        return records
    if args.config is not None:
        record = run_config(CONFIGS[args.config], device, args.steps,
                            data_dir=args.data_dir)
        print(json.dumps(record), flush=True)
        return record
    dataset = load_dataset("mnist", args.data_dir, seed=SEED)
    result = run_headline(device, dataset=dataset,
                          race_rounds=args.race_rounds,
                          timed_steps=args.steps)
    print(json.dumps(result.record), flush=True)
    return result.record


if __name__ == "__main__":
    main()
