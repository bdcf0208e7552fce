"""Which collectives gloo takes CUDA tensors for, with two ranks on one GPU.

    python scripts/torch_gloo_cuda_probe.py

NCCL refuses two ranks on the same GPU, so ranks that share a card run
gloo. This script spawns two ranks on ``cuda:0`` under gloo and runs each
collective the data- and tensor-parallel steps use (all_reduce,
broadcast, all_gather_into_tensor, reduce_scatter_tensor, barrier) and
those sequence parallelism uses (point-to-point sends posted together by
``batch_isend_irecv``, as a ring shift posts them, and
``all_to_all_single``, as the Ulysses reshard calls it) once on CUDA
tensors, checking the result. The point-to-point sends come last: a
rank that dies on one leaves the earlier results written. It prints one
JSON line per collective and a summary line ``{"cuda_ok": [...],
"cuda_refused": [...]}``. The port's rule for shared cards
(`cluster/coordination.py`) is written from it.
"""

from __future__ import annotations

import json
import os
import socket
import sys
import tempfile


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank(rank: int, world: int, port: int, out_dir: str) -> None:
    import datetime

    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    dev = torch.device("cuda", 0)
    results = {}

    def attempt(name, fn):
        try:
            ok = bool(fn())
            results[name] = {"ok": ok}
        except Exception as err:  # noqa: BLE001 — the probe reports it
            results[name] = {"ok": False, "error": f"{type(err).__name__}: "
                                                   f"{str(err)[:300]}"}

    def all_reduce():
        t = torch.full((1000,), float(rank + 1), device=dev)
        dist.all_reduce(t)
        torch.cuda.synchronize()
        return torch.all(t == sum(range(1, world + 1))).item()

    def broadcast():
        t = torch.full((1000,), float(rank), device=dev)
        dist.broadcast(t, src=0)
        torch.cuda.synchronize()
        return torch.all(t == 0.0).item()

    def all_gather():
        t = torch.full((1000,), float(rank), device=dev)
        out = torch.empty(world * 1000, device=dev)
        dist.all_gather_into_tensor(out, t)
        torch.cuda.synchronize()
        want = torch.arange(world, device=dev).repeat_interleave(1000).float()
        return torch.equal(out, want)

    def reduce_scatter():
        t = torch.arange(world * 1000, device=dev, dtype=torch.float32)
        out = torch.empty(1000, device=dev)
        dist.reduce_scatter_tensor(out, t)
        torch.cuda.synchronize()
        want = world * torch.arange(rank * 1000, (rank + 1) * 1000,
                                    device=dev, dtype=torch.float32)
        return torch.equal(out, want)

    def barrier():
        dist.barrier()
        return True

    def all_to_all():
        # rank r sends chunk j (values 10 r + j) to rank j
        t = torch.cat([torch.full((1000,), 10.0 * rank + j, device=dev)
                       for j in range(world)])
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t)
        torch.cuda.synchronize()
        want = torch.cat([torch.full((1000,), 10.0 * j + rank, device=dev)
                          for j in range(world)])
        return torch.equal(out, want)

    def ring_shift():
        # rank r sends to r + 1 and receives from r - 1, both posted at once
        t = torch.full((1000,), float(rank), device=dev)
        out = torch.empty_like(t)
        ops = [dist.P2POp(dist.isend, t, (rank + 1) % world),
               dist.P2POp(dist.irecv, out, (rank - 1) % world)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        torch.cuda.synchronize()
        return torch.all(out == float((rank - 1) % world)).item()

    def write():
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
            json.dump(results, fh)

    for name, fn in (("all_reduce", all_reduce), ("broadcast", broadcast),
                     ("all_gather_into_tensor", all_gather),
                     ("reduce_scatter_tensor", reduce_scatter),
                     ("barrier", barrier),
                     ("all_to_all_single", all_to_all),
                     ("batch_isend_irecv", ring_shift)):
        attempt(name, fn)
        write()
        # a failed collective can leave the peer waiting: resync on the CPU
        dist.all_reduce(torch.zeros(1))
    dist.destroy_process_group()


def main() -> int:
    import torch
    import torch.multiprocessing as mp

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    out_dir = tempfile.mkdtemp(prefix="gloo_probe_")
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_rank, args=(r, 2, port, out_dir))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
        if p.is_alive():
            p.kill()
            p.join()
    per_rank = []
    for r in range(2):
        path = os.path.join(out_dir, f"rank{r}.json")
        if not os.path.exists(path):
            print(json.dumps({"rank": r, "error": "no result"}), flush=True)
            return 1
        with open(path) as fh:
            per_rank.append(json.load(fh))
        print(json.dumps({"rank": r, "exit_code": procs[r].exitcode}),
              flush=True)
    ok, refused = [], []
    for name in per_rank[0]:
        rows = [pr.get(name, {"ok": False, "error": "the rank died first"})
                for pr in per_rank]
        print(json.dumps({"collective": name, "ranks": rows}), flush=True)
        (ok if all(r["ok"] for r in rows) else refused).append(name)
    print(json.dumps({"cuda_ok": ok, "cuda_refused": refused}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
