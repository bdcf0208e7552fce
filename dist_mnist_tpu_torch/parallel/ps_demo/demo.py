"""Live reenactment of `dist_mnist.py --job_name={ps,worker}` on one host
(port of the reference `parallel/ps_demo/demo.py`).

Topology as the reference lays it out, minus gRPC (the PS lives
in-process behind ctypes instead of behind a socket; the protocol and
blocking structure are the same):

- the C++ ParameterServer plays the `ps` job (variables, Adam slots,
  accumulators, token queue, all native),
- each Python thread plays a `worker` job: pull params, compute gradients
  on its own batch stream (torch autograd on `device`, the card by
  default), push.

This is a PROTOCOL demo, not a concurrency-parity claim: workers are
threads, so Python-side gradient compute serializes under the GIL (the
reference's workers were processes). What it reproduces is the blocking
structure (stale-grad drop, take_grad(n) aggregation, the token barrier),
whose state machines live in the C++ server and release the GIL while
blocking. For real multi-process training use the rank path
(`cli/launch.py`).

- async mode: push applies immediately; staleness tolerated, bounded,
- sync mode (`--sync_replicas`): pushes feed the accumulator; a chief
  thread runs the aggregate -> apply -> token loop; workers block on the
  token queue.

The flat parameter vector is the wire format. Its leaves are laid end to
end in sorted-key order, the order `jax.flatten_util.ravel_pytree`
gives the reference's tree, so a flat vector converted from the
reference means the same weights here (`ravel` / `unravel`).

    python -m dist_mnist_tpu_torch.parallel.ps_demo.demo

prints one JSON line per mode (async, then sync).
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from dist_mnist_tpu_torch.utils.tree import flatten_with_path


def ravel(tree) -> tuple[np.ndarray, list]:
    """(flat f32 numpy vector, layout) of a param tree: leaves in
    sorted-key order (`ravel_pytree`'s), each flattened row-major."""
    flat = flatten_with_path(tree)
    layout = [(path, tuple(leaf.shape)) for path, leaf in flat]
    vec = np.concatenate([leaf.detach().to("cpu", torch.float32)
                          .reshape(-1).numpy() for _, leaf in flat])
    return vec, layout


def unravel(flat: torch.Tensor, layout: list) -> dict:
    """The param tree of `layout` as views of the 1-D tensor `flat`."""
    tree: dict = {}
    off = 0
    for path, shape in layout:
        n = int(np.prod(shape, dtype=np.int64))
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = flat[off:off + n].reshape(shape)
        off += n
    return tree


def make_grad_fn(model, layout, device):
    """``grad_fn(flat, x, y)``: the gradient of the clipped cross-entropy
    of `model` at the flat params `flat` (numpy f32) on normalized images
    `x` and labels `y` (tensors on `device`), as a flat numpy vector."""
    from dist_mnist_tpu_torch.ops import losses

    def grad_fn(flat: np.ndarray, x: torch.Tensor, y: torch.Tensor):
        p = torch.from_numpy(np.ascontiguousarray(flat, np.float32)).to(
            device).requires_grad_(True)
        logits, _ = model.apply(unravel(p, layout), {}, x, train=False)
        loss = losses.clipped_softmax_cross_entropy(logits, y)
        (g,) = torch.autograd.grad(loss, p)
        return g.cpu().numpy()

    return grad_fn


def run_demo(
    mode: str = "async",
    num_workers: int = 2,
    train_steps: int = 200,
    batch_size: int = 100,
    hidden_units: int = 100,
    lr: float = 0.01,
    dataset=None,
    seed: int = 0,
    device=None,
) -> dict:
    """Train the reference MLP through the native PS on `device` (the card
    unless ``"cpu"`` is asked for). Every thread is joined before it
    returns. Returns the run's metrics."""
    from dist_mnist_tpu_torch.data.datasets import (
        default_data_dir,
        load_dataset,
    )
    from dist_mnist_tpu_torch.models.registry import get_model
    from dist_mnist_tpu_torch.ops.nn import normalize_images
    from dist_mnist_tpu_torch.parallel.ps_demo.bindings import ParameterServer
    from dist_mnist_tpu_torch.utils.device import resolve_device

    if mode not in ("async", "sync"):
        raise ValueError(f"mode must be async|sync, got {mode!r}")
    device = resolve_device(device)
    dataset = dataset or load_dataset(
        "mnist", str(default_data_dir()), seed=seed,
        synthetic_sizes=(8192, 1024))
    model = get_model("mlp", hidden_units=hidden_units)
    params0, _ = model.init(torch.Generator().manual_seed(seed),
                            torch.zeros(1, *dataset.train_images.shape[1:]))
    flat0, layout = ravel(params0)
    grad_fn = make_grad_fn(model, layout, device)

    ps = ParameterServer(
        [flat0.size],
        lr=lr,
        replicas_to_aggregate=num_workers if mode == "sync" else 0,
        staleness_bound=2 * num_workers if mode == "async" else -1,
    )
    ps.init(flat0)

    images = normalize_images(torch.from_numpy(dataset.train_images).to(
        device))
    labels = torch.from_numpy(dataset.train_labels.astype(np.int64)).to(
        device)
    n = images.shape[0]
    stop = threading.Event()
    applied_counts = [0] * num_workers
    errors: list = []

    def worker(widx: int):
        rng = np.random.default_rng(seed * 100 + widx)
        try:
            while not stop.is_set() and ps.step < train_steps:
                flat, pulled_step = ps.pull()  # weight pull
                idx = torch.from_numpy(rng.integers(0, n, batch_size)).to(
                    device)
                g = grad_fn(flat, images[idx], labels[idx])
                if mode == "async":
                    if ps.push_async(g, pulled_step):
                        applied_counts[widx] += 1
                else:
                    ps.push_sync(g, pulled_step)  # may be dropped as stale
                    token = ps.dequeue_token()  # the token barrier
                    if token < 0:
                        break
                    applied_counts[widx] += 1
        except Exception as exc:  # raised here after the join
            errors.append(exc)
            stop.set()

    def chief():
        # the chief-only queue-runner thread of the reference's sync mode
        while not stop.is_set() and ps.step < train_steps:
            if ps.chief_sync_once(tokens_per_step=num_workers) < 0:
                break

    threads = [threading.Thread(target=worker, args=(w,), daemon=True,
                                name=f"ps-demo-worker-{w}")
               for w in range(num_workers)]
    if mode == "sync":
        threads.append(threading.Thread(target=chief, daemon=True,
                                        name="ps-demo-chief"))
    t0 = time.monotonic()
    for t in threads:
        t.start()
    try:
        # a worker's error sets `stop`: the chief may be blocked on a take
        while ps.step < train_steps and not stop.is_set() \
                and any(t.is_alive() for t in threads):
            time.sleep(0.01)
    finally:
        stop.set()
        ps.close()  # wakes every blocked dequeue and take
        for t in threads:
            t.join()
    elapsed = time.monotonic() - t0
    if errors:
        raise errors[0]

    final_flat, final_step = ps.pull()
    with torch.no_grad():
        flat = torch.from_numpy(final_flat).to(device)
        x = normalize_images(torch.from_numpy(dataset.test_images).to(device))
        logits, _ = model.apply(unravel(flat, layout), {}, x, train=False)
        y = torch.from_numpy(dataset.test_labels.astype(np.int64)).to(device)
        test_acc = float((logits.argmax(-1) == y).to(torch.float32).mean())
    return {
        "mode": mode,
        "global_step": final_step,
        "steps_per_sec": final_step / elapsed,
        "test_accuracy": test_acc,
        "dropped_stale_grads": ps.dropped,
        "per_worker_applies": applied_counts,
        "elapsed": elapsed,
        "device": str(device),
    }


if __name__ == "__main__":
    import json
    import logging

    logging.basicConfig(level=logging.INFO)
    for mode in ("async", "sync"):
        print(json.dumps(run_demo(mode=mode), default=str))
