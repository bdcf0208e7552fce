"""The port's benchmarks: the headline training run (the reference
`bench.py` with no flags), one ladder config's training throughput
(`bench.py --config NAME`), classifier serving (`bench.py --serve`,
`--serve --quant`, `--serve --longctx`) and decode serving (`bench.py
--serve --decode`).

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
their docstrings. A failed hard gate prints an `error` line and exits 1.
Without a CUDA device and without ``--device=cpu`` every mode exits 1.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

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
    return p


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


def main(argv=None):
    """Runs the mode the flags name and prints its JSON line(s); returns
    the headline or config record, or the list of serving records."""
    args = build_parser().parse_args(argv)
    mode = _serve_mode(args)
    if args.config is not None and args.config not in CONFIGS:
        raise SystemExit(f"error: unknown config {args.config!r}; the port "
                         f"has {sorted(CONFIGS)}")
    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        raise SystemExit(f"error: {err}") from None
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
