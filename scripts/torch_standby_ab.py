#!/usr/bin/env python3
"""What a supervised run's stand-by ranks cost the generation that runs
beside them, in the PyTorch port.

    python3 scripts/torch_standby_ab.py [--platform=cpu] [--steps=60]
        [--rounds=2] [--out=chiprun_out/standby_ab.json]

A supervised launch (`cli.launch`, ``max_restarts > 0``) starts the next
generation's ranks as stand-bys while generation 0 trains: they import
torch and the train module beside it, then wait. This runs the same two
rank `mlp_mnist` launch (the geometry of `bench --faults --elastic`:
batch 64, a checkpoint every 10 steps, no fault) with ``max_restarts=0``
(no stand-by) and ``max_restarts=1`` (two stand-bys), in the order off,
on, on, off, `--rounds` times, each with a journal of its own, and reads
generation 0 from it: time to the chief's first step from the
generation's start, the chief's steps a second over its productive
time (`run_stop`'s goodput), its productive seconds and goodput
fraction, and the generation's wall. Without `--platform` the ranks share
the first card, as `chip_smoke.py`'s launches do. Prints the card's name
and power limit (on a card), one JSON line per run, and last a JSON line
with each side's median per figure; `--out` also writes that line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

FIGURES = ("first_step_s", "steps_per_s", "productive_s", "goodput_fraction",
           "generation_wall_s")


def one_run(side: str, steps: int, platform: str | None,
            data_dir: str) -> dict:
    from dist_mnist_tpu_torch.cli import launch as launch_mod
    from dist_mnist_tpu_torch.obs.events import read_journal

    with tempfile.TemporaryDirectory(prefix="standby_ab_") as tmp:
        journal = f"{tmp}/journal.jsonl"
        args = ["--config=mlp_mnist", f"--data_dir={data_dir}",
                f"--checkpoint_dir={tmp}/ckpt", f"--train_steps={steps}",
                "--batch_size=64", "--eval_every=0", "--log_every=10",
                "--checkpoint_every_steps=10"]
        with open(f"{tmp}/launch.log", "w") as log, \
                contextlib.redirect_stdout(log):
            rc = launch_mod.launch(
                2, args, platform=platform, journal=journal,
                max_restarts=1 if side == "on" else 0)
        recs = read_journal(journal)
    if rc != 0:
        raise SystemExit(f"the {side} run exited rc={rc}")

    def one(event, **match):
        return next(r for r in recs if r.get("event") == event and all(
            r.get(k) == v for k, v in match.items()))

    start = one("generation_start", gen=0)
    end = one("generation_end", gen=0)
    first = one("first_step", gen=0, host=0)
    stop = one("run_stop", gen=0, host=0)
    good = stop["goodput"]
    return {"side": side, "steps": stop["step"],
            "first_step_s": first["ts"] - start["ts"],
            "steps_per_s": stop["step"] / good["productive_s"],
            "productive_s": good["productive_s"],
            "goodput_fraction": good["goodput_fraction"],
            "generation_wall_s": end["ts"] - start["ts"]}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--platform", default=None, choices=["cpu"],
                   help="cpu: the ranks on the CPU; default: the card")
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--rounds", type=int, default=2,
                   help="each round runs off, on, on, off")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    from dist_mnist_tpu_torch.data.datasets import (
        default_data_dir,
        load_dataset,
    )

    if args.platform is None:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
    data_dir = str(default_data_dir())
    load_dataset("mnist", data_dir)  # the cache, before the timed runs
    runs = []
    for _ in range(args.rounds):
        for side in ("off", "on", "on", "off"):
            runs.append(one_run(side, args.steps, args.platform, data_dir))
            print(json.dumps(runs[-1]), flush=True)
    summary = {"standby_ab": {
        "platform": args.platform or "gpu", "steps": args.steps,
        "runs_per_side": 2 * args.rounds,
        **{side: {f: statistics.median(r[f] for r in runs
                                       if r["side"] == side)
                  for f in FIGURES} for side in ("off", "on")}}}
    line = json.dumps(summary)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
