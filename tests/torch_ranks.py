"""Run a function on N gloo ranks on the CPU, for the port's tests.

`run_ranks(fn, world, tmp_dir, *args)` spawns `world` processes (the
``spawn`` start method), each joining a gloo group through a file store in
`tmp_dir` (`cluster.coordination.initialize_distributed(platform="cpu")`,
one intra-op thread per rank), calls ``fn(*args)`` and returns every
rank's result, rank 0's first. `fn` must be importable by path, so the
cases live in this module, which imports the port and never JAX. A rank
that raises hands its traceback back and the call raises; a group that
outlives `timeout` is killed and the call raises.
"""

from __future__ import annotations

import os
import pickle
import traceback

import numpy as np
import torch


def _entry(fn, rank, world, store, out, args, timeout):
    from dist_mnist_tpu_torch.cluster import coordination

    torch.set_num_threads(1)
    try:
        coordination.initialize_distributed(
            num_processes=world, process_id=rank, platform="cpu",
            init_method=f"file://{store}", timeout_s=timeout)
        torch.set_num_threads(1)
        result = {"ok": fn(*args)}
    except BaseException:  # noqa: BLE001 — handed back to the parent
        result = {"error": traceback.format_exc()}
    finally:
        coordination.shutdown()
    with open(out, "wb") as fh:
        pickle.dump(result, fh)


def run_ranks(fn, world: int, tmp_dir, *args, timeout: float = 120.0):
    """[fn(*args) on rank r for r in range(world)] (see the module
    docstring)."""
    import multiprocessing as mp

    tmp_dir = str(tmp_dir)
    os.makedirs(tmp_dir, exist_ok=True)
    store = os.path.join(tmp_dir, f"store-{fn.__name__}-{world}")
    if os.path.exists(store):
        os.remove(store)
    outs = [os.path.join(tmp_dir, f"out-{fn.__name__}-{world}-{r}.pkl")
            for r in range(world)]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(fn, r, world, store, outs[r],
                                              args, timeout))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=timeout)
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
        for p in procs:
            p.join(timeout=30)
    if hung:
        raise TimeoutError(f"{len(hung)} of {world} ranks of {fn.__name__} "
                           f"still running after {timeout}s")
    results, errors = [], []
    for r, path in enumerate(outs):
        if not os.path.exists(path):
            errors.append(f"rank {r} left no result (exit code "
                          f"{procs[r].exitcode})")
            continue
        with open(path, "rb") as fh:
            res = pickle.load(fh)
        if "error" in res:
            errors.append(f"rank {r}:\n{res['error']}")
        else:
            results.append(res["ok"])
    if errors:
        raise RuntimeError(f"{fn.__name__} on {world} ranks:\n"
                           + "\n".join(errors))
    return results


def to_numpy(tree):
    """A tree of tensors as the same tree of numpy arrays."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def from_numpy(tree):
    if isinstance(tree, dict):
        return {k: from_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_numpy(v) for v in tree)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.array(tree, copy=True))
    return tree
