#!/usr/bin/env python3
"""How much room the top-1 gate of `bench.run_serve_quant` has on freshly
initialized weights: for each seed of `mlp_mnist`'s fresh init, the int8
weight-only engine's top-1 agreement with the float engine over the
bench's 256-image pool (the same pool and the same `bench.top1_flips`
the bench gates at >= 0.99).

    python3 scripts/torch_quant_seed_sweep.py [--seeds 64] [--device cpu]

Sweeps seeds 0 .. N-1 and the config's own seed (the one the bench
serves). Prints one JSON line per seed, then a summary line: the seeds
under the gate, the least agreement, how many seeds flip each number of
rows, and the config seed's own reading. About a second a seed on the
CPU; on a card the int8 engine runs `quant_matmul`.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from dist_mnist_tpu_torch import bench  # noqa: E402
from dist_mnist_tpu_torch.configs import get_config  # noqa: E402
from dist_mnist_tpu_torch.serve import (  # noqa: E402
    build_zoo_engine,
    load_for_serving,
    make_images,
)

#: `run_serve_quant`'s gate
TOP1_MIN = 0.99


def agreement(seed: int, device: torch.device) -> dict:
    cfg = dataclasses.replace(get_config("mlp_mnist"), seed=seed)
    engines = [build_zoo_engine(load_for_serving(cfg, device, quant=q),
                                device, model_name="mlp",
                                max_bucket=bench.SERVE_MAX_BATCH)
               for q in (None, "int8")]
    pool = make_images(engines[0].image_shape, seed=0)
    flips = bench.top1_flips(*engines, pool)
    return {"seed": seed, "top1_flips": flips,
            "top1_agreement": 1.0 - flips / len(pool)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", type=int, default=64)
    p.add_argument("--device", default="cpu")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    own = get_config("mlp_mnist").seed
    rows = []
    for seed in sorted({*range(args.seeds), own}):
        rows.append(agreement(seed, device))
        print(json.dumps(rows[-1]), flush=True)
    under = [r["seed"] for r in rows if r["top1_agreement"] < TOP1_MIN]
    print(json.dumps({
        "seeds": len(rows), "device": str(device), "gate": TOP1_MIN,
        "seeds_under_gate": under,
        "share_under_gate": len(under) / len(rows),
        "min_agreement": min(r["top1_agreement"] for r in rows),
        "seeds_by_flips": dict(sorted(collections.Counter(
            r["top1_flips"] for r in rows).items())),
        "config_seed": own,
        "config_seed_agreement": next(r["top1_agreement"] for r in rows
                                      if r["seed"] == own)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
