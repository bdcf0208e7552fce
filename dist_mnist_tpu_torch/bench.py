"""The headline training benchmark of the port (the reference `bench.py`
with no flags): LeNet-5 on MNIST, global batch 200, Adam 1e-3, the
training split resident on the device, steps in chunks of 100.

    python -m dist_mnist_tpu_torch.bench                # on the GPU
    python -m dist_mnist_tpu_torch.bench --device=cpu --race_rounds=1 \\
        --steps=100                                     # plain CPU path

Two phases, as the reference's: an accuracy race (rounds of two chunks,
each round followed by a whole-test-set evaluation, until test accuracy
reaches 99% or the rounds run out; wall clock from the start), then
`--steps` steady-state steps timed after one warm-up chunk. Prints one
JSON line with the reference headline's schema: steps/sec/chip, examples
per second, MFU against the card's bf16 peak (`utils/flops.py`), and the
race result, labelled synthetic when the data is the procedural twin.
Without a CUDA device and without ``--device=cpu`` it exits 1.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from dist_mnist_tpu_torch import optim
from dist_mnist_tpu_torch.data.datasets import Dataset, load_dataset
from dist_mnist_tpu_torch.data.pipeline import DeviceDataset
from dist_mnist_tpu_torch.models.registry import get_model
from dist_mnist_tpu_torch.train import (
    TrainState,
    create_train_state,
    evaluate,
    make_eval_step,
    make_scanned_train_fn,
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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m dist_mnist_tpu_torch.bench",
        description="LeNet-5 MNIST training throughput and accuracy race")
    p.add_argument("--device", default=None,
                   help="cuda (default), cuda:N, or cpu")
    p.add_argument("--race_rounds", type=int, default=40,
                   help="accuracy-race rounds of two chunks each")
    p.add_argument("--steps", type=int, default=2000,
                   help="timed steady-state steps")
    p.add_argument("--data_dir", default=None,
                   help="IDX files, or where the synthetic twin is cached "
                        "(default: <temp dir>/mnist-data)")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        raise SystemExit(f"error: {err}") from None
    dataset = load_dataset("mnist", args.data_dir, seed=SEED)
    result = run_headline(device, dataset=dataset,
                          race_rounds=args.race_rounds,
                          timed_steps=args.steps)
    print(json.dumps(result.record), flush=True)
    return result.record


if __name__ == "__main__":
    main()
