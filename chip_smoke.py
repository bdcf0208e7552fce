#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`dist_mnist_tpu_torch`).

    python3 chip_smoke.py

Needs one NVIDIA GPU and `nvcc`; exits nonzero, printing no result, when
there is no CUDA device or when the port's package is not beside this
script. Phases (any failure exits nonzero before the final `ok` line):

1. print the card's name and power limit as `nvidia-smi` reports them;
2. build every CUDA kernel of the ported paths from the checkout's
   sources (`dist_mnist_tpu_torch/csrc/`, five sources, one `nvcc` each,
   all at once) and print ptxas' registers and spills;
3. hold each kernel against its plain PyTorch version on the card at the
   paths' shapes: `quant_matmul` at LeNet-5 fc1 [M,3136]x[3136,512] and
   fc2 [M,512]x[512,10] in bf16 (M in {1, 7, 16, 17, 64, 65, 200}), the
   MLP's [M,784]x[784,100] and [M,100]x[100,10] in f32 (M in {1, 2, 7,
   16, 17, 64, 65, 200}), and in both dtypes at [M,1000]x[1000,96] (a K
   the split size does not divide) and [M,1001]x[1001,40] (rows not
   aligned), within 1e-2 (bf16) and 2e-5 (f32) of the largest output, and
   both split-K reductions' bits the same twice and under another stream
   (bf16 fc1, M in {7, 64, 200}; f32 MLP hid, M in {1, 7, 64, 200}); both
   fused-Adam kernels at LeNet-5's
   8 leaf sizes and n in {1, 7, 129}, m' and v' within 1e-6 and delta
   within 1e-5 of the largest value (clip scale 0.37, weight decay on),
   and each over LeNet-5's 8 leaves in one launch, every leaf's outputs
   the plain version's bits;
   `paged_attention` (phase `paged_parity`: 9 rows, 8 heads of 16, pages
   of 32, table widths 1 to 128, lengths 1 to 4096) and
   `masked_flash_attention` (`masked_parity`: Sq 1 against Sk 64 and 4096,
   Sq 7 and 128 against Sk 256, f32; and its Sq > 1 route, the flash
   forward kernels with per-row lengths, at `vit_masked_forward`'s shape
   and lengths (B = 64, S = 33, lengths 25 and 33), at each masked cell
   of the zoo grid that `zoo_flash_serve` runs (B = 32, S = 9, 17, 33,
   65, the lengths the grid gives) and at (B, Sq, Sk) = (64, 65, 65),
   (8, 300, 300), (3, 5, 100), (2, 200, 128), (64, 33, 33), (32, 9, 9)
   and (32, 17, 17), H = 3, D = 64, lengths 1 to Sk, in bf16 and f32,
   with the lse) within 1e-5 of the largest output
   (bf16 1e-2; the lse 1e-5), with the pages or key blocks they visit
   counted, and the bf16 one-pass route's share of outputs equal to its
   plain version's bf16 values (the reference's streamed rule over
   128-key blocks) at S = 9, 17, 33 and 65, at least `MASKED_MATCH_MIN`
   (`masked_share`; the tiled route's at S = 300 read without a limit),
   and each decode kernel's bits, and the Sq > 1 route's out and
   lse at Sq = Sk = 65 and 300, the same on a second call and on a second
   stream (`decode_repeat`); the flash kernels (phase
   `flash_parity`): the forward's out and lse and the backward's dq, dk,
   dv at ViT's shape (S = 65, 3 heads of 64) for B in {1, 7, 64} in bf16
   and f32, at S = 17 and 300 with block_k = 128, the bf16 tensor-core
   forward and backward at S in {1, 17, 65, 128, 129, 300} with and
   without block_k = 128, at D in {16, 40, 128} and on views that are not
   16-byte aligned (out 1e-2, lse 1e-5, dq/dk/dv 1e-2), the backward at
   Sq != Sk, its bits twice and under another stream, the bf16 one at
   ViT's shape >= 90% of its dq/dk/dv equal to the plain version's bf16
   values (what tells the hi/lo split from P and dS rounded to bf16
   once), `flash_attention_lse`'s autograd with a nonzero lse cotangent,
   and the masked backward with lengths 1 to 65 (dk, dv exactly 0 past
   each length, key steps and blocks entered counted), within 1e-2
   (bf16), 1e-5 (f32 forward, lse) and 1e-4 (f32 backward) of the largest
   value, each line naming the backward's body (`bwd_route`: "mma" or
   "fma"); every case in f32 as well as bf16 (the f32 forward at every
   case of the bf16 forward and at ViT's shape for B in {1, 7, 64}, out
   and lse within 1e-5, the f32 backward within 1e-4);
4. serve `lenet5_mnist --quant=int8` (seeded fresh init) on the card
   through the serving CLI's entry point (`cli/serve.py main`: server +
   closed-loop loadgen, 512 requests), with every launch counter set to 0
   just before and read just after; check that the int8 weights quantized
   on the card equal the CPU's bit for bit; then check one fixed batch of
   served logits (finite, [64, 10]) against the same engine with the
   kernel swapped for its plain version: max abs difference <= 0.04 (the
   bf16 logit bound the JAX package's tests use) and the same top-1 on
   >= 98% of rows; then time one served batch of 64 on the host clock and
   break its device time down by kernel with `torch.profiler`; then the
   same for the CLI's default config, `mlp_mnist` (f32) served int8
   (`mlp_serve`): 2 f32 `quant_matmul` launches per batch the engine ran
   and no other kernel, one fixed batch of 64 logits within 1e-4 of the
   largest against the plain version and the same top-1 on >= 98% of
   rows, and one served batch's host wall and device time by kernel;
5. train LeNet-5 through the port's headline bench function
   (`bench.run_headline`: batch 200, chunks of 100, MNIST or its synthetic
   twin resident on the card) with `optim.adam(1e-3, fused=True)`, 1,000
   steps when the race ends after its first round, with every launch
   counter set to 0 just before and read just after: `fused_adam_update`
   must launch once per step (over all 8 leaves), the loss must be finite
   and fall, and test accuracy reach 0.97;
6. trajectories: from one initial state and generator seed (so the same
   batches and dropout masks), 100 steps with plain `optim.adam(1e-3)`
   against `adam(1e-3, fused=True)`, and with
   `chain(clip_by_global_norm(0.5), adamw(1e-3, weight_decay=0.01))`
   against `fused_adamw(1e-3, weight_decay=0.01, clip_norm=0.5)` (whose
   `fused_adam_clip_wd_update` launches are counted over its run, once
   per step): the final losses within 1% and the test accuracies within
   0.5 points;
7. one training step's host wall and its device time by kernel from
   `torch.profiler`, and the device's idle share;
8. decode serving: the port's `bench --serve --decode` entry point (64
   requests, concurrency 16) with every counter set to 0 just before and
   read just after — its three JSON lines and hard gates, and
   `paged_attention` launched twice (depth 2) per decode step of the int8
   engine and no other kernel (`decode_serve`); a dense engine with
   `attention_impl="flash"` at the capacity geometry, `masked_flash_attention`
   launched twice per decode step, teacher-forced agreement >= 0.99 with
   the dense `"xla"` engine (`decode_flash`); incremental decode against
   the full forward at every position, bitwise or not
   (`decode_contract`); the host wall and device time by kernel of one
   int8 decode step (`decode_profile`);
9. ViT-Tiny training: the port's `bench --config vit_tiny_cifar_flash
   --steps 100` entry point at full width (dim 192, depth 12, 3 heads,
   S = 65, batch 64; CIFAR-10 or its synthetic twin; remat and augment)
   with every counter set to 0 just before and read just after: per step
   24 forward, 12 dQ and 12 dK/dV launches and no other kernel, finite
   chunk losses, the last below the first (`vit_train`); from one state
   and generator seed, the first step's gradients with the kernels
   against those with the plain `"xla"` attention (every leaf, qkv's q,
   k and v parts apart, within 5e-2 relative L2 error), and 20 steps of
   each whose losses stay within 1e-2 at every step
   (`vit_kernel_vs_plain`); one step's host wall and device time by
   kernel (`vit_profile`); then one eval forward of ViT-Tiny at full width
   (seeded weights) on 64 images of the zoo's height-16 bucket (S = 33,
   real heights 9..16, the token mask `SeqGrid.mask` builds) through
   `ViTTiny.apply(..., mask=)`, counters set to 0 just before and read
   just after: 12 masked-forward launches (one a layer) and no other
   kernel, logits within 2e-2 of the largest logit of the same forward
   with the plain `"xla"` attention and the same top-1 on >= 98% of rows,
   and its host wall and device time by kernel (`vit_masked_forward`);
10. the classifier serving benches at the reference's defaults (512
   requests, concurrency 64), counters set to 0 just before and read
   just after each, their hard gates and JSON lines: `bench.run_serve`
   and `bench.run_serve_longctx` (`vit_tiny_cifar`, "xla") launch no
   kernel, `bench.run_serve_quant` 2 f32 `quant_matmul` launches per
   batch of the int8 engine and no other (`serve_benches`); then
   `bench.run_serve_longctx` through `vit_tiny_cifar_flash` (bf16, full
   width): 12 masked-forward launches per batch of a masked cell, 12
   flash-forward launches per batch of the dense native cell, no other
   kernel, no cell run for the first time after prewarm, and one fixed
   batch per height bucket (and one of full height) against the same
   grid with the "xla" attention, within `ZOO_LOGIT_TOL` of the largest
   logit and the same top-1 on `ZOO_TOP1` of the rows that limit decides
   (`zoo_flash_serve`);
11. the training CLI (`cli.train.main` in-process, every counter set to
   0 just before each command and read just after; `train_cli`):
   LeNet-5 for 1,000 steps on the host batcher, prefetched two batches
   ahead on a side stream, checkpoints every 250 steps: step 1,000
   reached, test accuracy >= 0.97, a commit marker at every cadence
   step, the reference's record names in `metrics.csv` and
   `events.jsonl`, no kernel launched; the same run resumed to step
   1,200 (logs restored=True, starts at 1,000); `cli.train.run_config`
   with a hook that raises `PreemptionError` once at step 600 and
   max_recoveries=1: restores step 500, replays, and ends with params,
   Adam slots and generator equal to the first run's bit for bit (cuDNN
   deterministic for both runs); `vit_tiny_cifar_flash` at full width and
   its own batch 1,024 for 30 steps with an eval at step 30 and
   checkpoints every 15: 24 forward, 12 dQ and 12 dK/dV launches a step
   plus 12 forward launches per eval batch (10 of 1,000 images) and no
   other kernel, finite losses, markers at 0, 15 and 30; then
   `cli.serve.main --checkpoint_dir=... --seq_buckets=auto` (256
   requests, concurrency 64): checkpoint_step 30, every request ok, the
   engine's params the checkpoint's bits (the same paths, leaf by leaf),
   12 masked-forward launches per masked batch and 12 forward launches
   per dense batch, no other kernel, no cell run for the first time after
   prewarm (that loadgen sends native-height images, as the reference's
   does, so only prewarm runs the masked cells there); then the same
   checkpoint through `load_for_serving` behind the zoo grid under
   `run_longctx_loadgen`'s mixed heights (512 requests, concurrency 64),
   counted from the traffic alone: every request ok, no first run, at
   least one masked batch, 12 masked-forward launches per masked batch
   and 12 forward launches per dense batch and no other kernel, and one
   fixed batch per height bucket within `ZOO_LOGIT_TOL` of the same
   engine's logits on the plain versions (`served_checkpoint_varlen`);
   it prints each run's steps/s, goodput, feed wait, prefetched bytes, checkpoint save
   and restore times and launch counts;
12. data parallelism (`data_parallel`): `bench --config resnet20_cifar
   --steps 100` and `--config lenet5_fashion` on one rank at the per-chip
   batch 128 (counters set to 0 just before each and read just after: no
   kernel launched, the unfused Adam of the reference's configs; steps/s,
   MFU and chunk losses printed, the last below the first), and
   `resnet20_cifar_fsdp` there, whose `mesh_note` must say it was benched
   as DP; then three runs of `python -m dist_mnist_tpu_torch.cli.launch
   --num_processes=2` with both ranks on the one card (gloo over CUDA
   tensors; each run's log under `chiprun_out/`): `lenet5_fashion` (DP,
   `DP_STEPS` steps at 128 a rank): both ranks' final params the same
   bits (their digests) and one all-reduce of every param and the two
   metrics a step; `resnet20_cifar_fsdp` (FSDP, checkpoints every 25
   steps) against the same run under `--sharding=dp`: every logged loss
   within `DP_FSDP_LOSS_TOL` of DP's (plus the log's rounding,
   `LOG_RESOLUTION`), per-rank params + Adam slots 0.45–0.55 of
   DP's, and the chief's last checkpoint restored here under DP at step
   `DP_STEPS` with the run's final params bit for bit;
   `vit_tiny_cifar_flash` (DP, `DP_VIT_STEPS` steps at 64 a rank), each
   rank counting its launches over its loop: exactly 24 forward, 12 dQ
   and 12 dK/dV a step and no other kernel. Every run's startup line
   (the backend) and its collectives' bytes per step are printed;
12b. tensor parallelism (`tensor_parallel`): two spawned rank processes
   on the one card (gloo), a model = 2 mesh: `causal_tiny`'s decode
   engine over int8 pages and then a dense cache under the seeded decode
   loadgen (`TP_LOAD`), the chief driving and the follower following,
   each rank's counters set to 0 just before each engine and read just
   after: streams equal to the one-rank engine's on the card, each
   rank's KV bytes half of one rank's on 2 of the 4 heads, exactly
   `depth` `paged_attention` launches a rank per int8 decode step, no
   kernel on the dense cache and no call of the paged plain version;
   then `flash_attention_sharded` and `masked_flash_attention_sharded`
   at B = 64, S = 65, 4 heads of 64, bf16: out, lse, dQ, dK and dV
   bitwise the unsharded kernels' on the same inputs, one forward and
   one backward launch a rank; `python -m dist_mnist_tpu_torch.cli.serve
   --decode --mesh=model=2` (`TP_SERVE_REQUESTS`, every one ok); and two
   `cli.launch` runs, `vit_tiny_cifar_tp` on 2 ranks (data 1 x model 2,
   global batch 128) and `vit_tiny_cifar_fsdp_tp` on 4 (data 2 x model
   2, 256), `TP_VIT_STEPS` steps each: finite falling losses, the same
   on every rank, the replicated leaves' digests equal, per-rank params
   + AdamW slots within `TP_STATE_RATIO_TOL` of `TP_STATE_RATIO` of DP's,
   the model group's collectives counted (`tp_` keys), no kernel on the
   "xla" ViT, and the chief's checkpoint restored here under DP equal to
   the final params; and `paged_attention` timed at the TP step's shape
   on 2 heads and on 4;
12c. sequence parallelism (`sequence_parallel`): the flash kernels at
   the path's shapes against their plain versions (`flash_attention_lse`
   at a ring block, B = 128, 32 tokens, 3 heads of 64, bf16, the rank's
   own strided K/V and a shifted contiguous block, with a random nonzero
   lse cotangent; `flash_attention` at Ulysses' local call, B = 128, S =
   64, 2 heads of 48, bf16, the D = 64 instantiation); then two spawned
   rank processes on the one card (gloo, data = 1 x seq = 2, ViT-Tiny at
   full width, 64 tokens, batch 128): ring and Ulysses attention on each
   rank's tokens against one rank's attention over the whole sequence
   (flash in bf16 within `SP_BF16_TOL`, "xla" in f32 within
   `SP_F32_TOL`), output and q, k, v gradients; `ring_flash` and
   `ulysses_flash` step 1 against one rank's unsharded step on the same
   params and batch (`SP_LOSS_TOL`, `SP_GRAD_TOL`); one `ring_flash` step
   under each of `dots_no_batch`, `save_attn` and `dots` (the same loss;
   flash-forward launches, `sp_` bytes and peak bytes printed); and
   `vit_tiny_cifar_ring_flash` and `_ulysses_flash` for `SP_STEPS` steps
   each through the training CLI's `run_config`, the counters set to 0
   just before the loop and read just after: finite falling losses, the
   same on both ranks, the same final params, exactly `sp_launches`
   flash launches a rank and step and no other kernel, the `sp_`
   collectives a step exactly `sp_bytes`, the chief's checkpoint
   restored on one rank bit for bit; steps/s and peak allocated bytes a
   rank against one rank at the same batch;
12d. model parallelism (`model_parallel`): four spawned rank processes on
   the one card (gloo): one MoE layer at the path's shape (16,384 tokens
   of 192, 4 experts of 768, capacity 1,280 a shard) through
   `moe_ffn_adaptive` on data = 1 x model = 4, each rank's output within
   `MP_EP_TOL` of `moe_ffn_dense` on its token shard with the shards'
   mean drop fraction and ep_engaged 1; `allgather_matmul` and
   `matmul_reducescatter` at ViT-Tiny's MLP shapes within `MP_CMM_TOL`
   of `torch.matmul`; the pipeline's first step of `vit_tiny_cifar_pp`
   at batch 256 on data = 1 x pipe = 4 within `MP_LOSS_TOL` /
   `MP_GRAD_TOL` of the plain stack on one rank; then
   `vit_tiny_cifar_moe` (model = 4) and `vit_tiny_cifar_pp` (pipe = 4)
   through `cli.launch` on four ranks, `MP_STEPS` steps at batch 256,
   each rank's counters set to 0 just before its loop and read just
   after: finite falling losses, the same on every rank, the same final
   params, every kernel counter 0 (no TPU kernel is on this path), the
   `ep_` / `pp_` collectives a step exactly `ep_bytes` / `pp_bytes`,
   ep_engaged 1 at every step, the chief's checkpoint restored on one
   rank bit for bit; the drop fraction and expert load a step, steps/s
   and peak allocated bytes a rank against one rank at the same batch;
12e. the native layer (`native`): both C++ libraries built with g++ from
   the checkout's sources into `build/torch_native/`; `lenet5_mnist`
   through `cli.train`'s `run_config` for `NATIVE_STEPS` steps with
   `--input_pipeline=native` and then `python` (steps/s and feed wait,
   figures); the native run preempted and recovered through the C++
   batcher's `at_step` equal to the straight run bit for bit; two
   spawned ranks at data = 2 whose rows of each global batch, joined,
   are the one-rank stream's; the parameter-server demo on the card, sync
   and async, above the reference test's accuracy floors;
12f. multislice (`multislice`): `make_mesh(..., slices=with_fake_slices(
   ...))` on spawned ranks: four ranks of `lenet5_fashion` at data = 4
   over two slices (each rank's coordinates and groups the hybrid
   layout's; losses and params the row-major mesh's bit for bit), then
   eight ranks of `vit_tiny_cifar_pp` at data 2 x pipe 4 over four
   slices, where the layout is not row-major (coordinates and groups
   gated the same way; losses within `MS_PP_TOL` of the row-major
   mesh's);
12g. the zoo's sharded placement (`zoo_sharded`): `vit_tiny_cifar_flash`
   served by two ranks under `--serve_rules=tp` through `cli.serve`'s
   classifier mode with the zoo grid and mixed heights (every request
   ok; each rank's launches, from 0 just before, exactly 12 of the flash
   forward a dense batch and 12 of the masked forward a masked batch the
   chief ran; fixed batches within `ZOO_LOGIT_TOL` of the one-rank "xla"
   engine), then `vit_tiny_cifar_fsdp_tp` by four ranks (data 2 x model
   2: every request ok, each rank's resident bytes the rules' share, and
   a checkpoint trained under dp served under fsdp_tp within
   `ZS_RESTORE_TOL` of serving it unsharded);
13. time each kernel at the shapes its path gives it, beside its plain
   version and, where one exists, one library call computing the same
   function (for the Adam kernels `torch._fused_adam_`/`_fused_adamw_`, a
   yardstick that computes a neighbouring function in place; for
   `paged_attention` a composite of gather, dequantize and
   `F.scaled_dot_product_attention`; for the flash kernels
   `F.scaled_dot_product_attention`, forward, and forward + backward
   through autograd; the flash kernels' f32 route too, its masked
   backward beside SDPA f32 with the prefix mask), each as a CUDA
   graph of back-to-back calls timed with CUDA events, and compute its
   bound: max(bytes / memory rate, FLOPs / peak rate for the operands'
   type) for the card, and for the flash rows the same bound for the
   products the kernels themselves run (`design_bound_ms`); the decode
   kernels also at every length 4096 (the long context) and the masked
   forward at Sq > 1 (B = 64, S = 33 with `vit_masked_forward`'s lengths,
   B = 64, S = 65 and B = 8, S = 300; H = 3, D = 64, bf16 and f32; the
   kernels line takes the first), each beside its launch floor (an empty
   kernel of the same grid, block and arguments);
14. print the `{"kernels": [...]}` line (nine kernels: the masked forward's
   Sq > 1 route apart from its Sq = 1 route; the flash rows with their
   launches in `data_parallel`'s ViT run, both ranks, and each rank's in
   `tensor_parallel`, in each `sequence_parallel` run and (the flash
   forward and the masked forward's Sq > 1 route) in `zoo_sharded`;
   `paged_attention` with each rank's TP launches and
   its times at 2 and 4 heads), then, last, the `ok` line.

A failure prints `{"phase": "fail", "error": ...}` on stdout and the
same message on stderr, and exits 1.
"""

from __future__ import annotations

import contextlib
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

#: memory bytes/s and dense peak FLOP/s by operand type, by card (NVIDIA
#: data sheets): bf16 on the tensor cores, float32 outside them (the
#: kernel's float32 path is full-precision FMA, not TF32)
_CARD_RATES = {"pcie": (2.0e12, {"bfloat16": 756e12, "float32": 51e12}),
               "sxm": (3.35e12, {"bfloat16": 989e12, "float32": 67e12})}


def fail(msg: str) -> None:
    """Report `msg` on stdout (a JSON line) and stderr, and exit 1."""
    print(json.dumps({"phase": "fail", "error": msg}), flush=True)
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def rel_err(got, want) -> tuple[float, float]:
    """(max abs error, max abs error / max |want|) in f32."""
    got, want = got.detach().float(), want.detach().float()
    err = float((got - want).abs().max())
    return err, err / (float(want.abs().max()) + 1e-12)


def graph_ms(torch, fn, calls: int = 100, rounds: int = 5) -> float:
    """Device ms per call: `calls` calls captured in one CUDA graph, the
    graph replayed under CUDA events; median over `rounds` replays."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()  # warm-up outside the capture (allocator, handles)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def profile_fields(torch, prof, reps: int, wall_ms: float) -> dict:
    """Device ms per repetition by kernel name (cut to 100 characters)
    from a `torch.profiler` run of `reps` repetitions, their sum, the
    device's idle share of the host wall `wall_ms`, and the device
    operations (kernels, copies, memsets) per repetition."""
    device_ms, n_events = {}, 0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            n_events += 1
            kernel = evt.name[:100]
            device_ms[kernel] = (device_ms.get(kernel, 0.0)
                                 + evt.time_range.elapsed_us() / 1e3 / reps)
    busy_ms = sum(device_ms.values()) if device_ms else None
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": None if busy_ms is None else 1 - busy_ms / wall_ms,
        "device_ops_per_rep": n_events / reps,  # kernels, copies, memsets
        "device_ms_by_kernel": dict(sorted(device_ms.items(),
                                           key=lambda kv: -kv[1]))}


#: LeNet-5's param leaves and their sizes (1,663,370 elements in all)
LENET_LEAVES = {"conv1/b": 32, "conv1/w": 800, "conv2/b": 64,
                "conv2/w": 51200, "fc1/b": 512, "fc1/w": 1605632,
                "fc2/b": 10, "fc2/w": 5120}


def adam_parity(torch, dev) -> dict:
    """Both fused-Adam kernels against their plain versions on the same
    card inputs, at LeNet-5's leaf sizes and at n = 1, 7, 129 (tails after
    the float4 loop), one leaf a launch; then each kernel over LeNet-5's 8
    leaves in one launch (the ``*_leaves`` functions, as the optimizers
    call them). Fails unless m' and v' are within 1e-6 and delta within
    1e-5 of the largest value, and unless every leaf's delta, m' and v'
    from the one launch are the plain version's bits. Returns the worst
    errors by kernel."""
    from dist_mnist_tpu_torch.ops.kernels.fused_adam import (
        fused_adam_clip_wd_update,
        fused_adam_clip_wd_update_leaves,
        fused_adam_clip_wd_update_reference,
        fused_adam_update,
        fused_adam_update_leaves,
        fused_adam_update_reference,
    )

    gen = torch.Generator().manual_seed(1)
    lr_t = torch.full((), 3.1e-3, device=dev)
    scalars = torch.tensor([3.1e-3, 0.37, 1e-5], device=dev)  # clip < 1, wd
    worst = {}
    sizes = [*LENET_LEAVES.items(), ("n=1", 1), ("n=7", 7), ("n=129", 129)]
    for label, n in sizes:
        g = torch.randn(n, generator=gen).to(dev)
        m = (0.1 * torch.randn(n, generator=gen)).to(dev)
        v = (0.01 * torch.rand(n, generator=gen)).to(dev)
        p = torch.randn(n, generator=gen).to(dev)
        for name, fn, ref, args in (
                ("fused_adam_update", fused_adam_update,
                 fused_adam_update_reference, (g, m, v, lr_t)),
                ("fused_adam_clip_wd_update", fused_adam_clip_wd_update,
                 fused_adam_clip_wd_update_reference, (g, m, v, p, scalars))):
            got, want = fn(*args), ref(*args)
            torch.cuda.synchronize()
            errs = {out: rel_err(a, b)
                    for out, a, b in zip(("delta", "m", "v"), got, want)}
            bitwise = all(torch.equal(a, b) for a, b in zip(got, want))
            print(json.dumps({"phase": "adam_parity", "kernel": name,
                              "leaf": label, "n": n, "bitwise": bitwise,
                              **{f"{out}_max_abs_err": e[0]
                                 for out, e in errs.items()},
                              **{f"{out}_max_rel_err": e[1]
                                 for out, e in errs.items()}}), flush=True)
            for out, tol in (("delta", 1e-5), ("m", 1e-6), ("v", 1e-6)):
                if errs[out][1] > tol:
                    fail(f"{name} {label}: {out} rel err {errs[out][1]} > "
                         f"{tol}")
            w = worst.setdefault(name, {"abs": 0.0, "rel": 0.0})
            w["abs"] = max(w["abs"], *(e[0] for e in errs.values()))
            w["rel"] = max(w["rel"], *(e[1] for e in errs.values()))

    # every LeNet-5 leaf in one launch: each leaf's outputs the plain bits
    leaves = [[(s * torch.randn(n, generator=gen)).abs() if i == 2 else
               s * torch.randn(n, generator=gen)
               for n in LENET_LEAVES.values()]
              for i, s in enumerate((1.0, 0.1, 0.01, 1.0))]
    g, m, v, p = ([t.to(dev) for t in ts] for ts in leaves)
    for name, fn, ref, args, counter in (
            ("fused_adam_update", fused_adam_update_leaves,
             fused_adam_update_reference, (g, m, v, lr_t), fused_adam_update),
            ("fused_adam_clip_wd_update", fused_adam_clip_wd_update_leaves,
             fused_adam_clip_wd_update_reference, (g, m, v, p, scalars),
             fused_adam_clip_wd_update)):
        before = counter.launches
        got = fn(*args)
        launches = counter.launches - before
        torch.cuda.synchronize()
        bitwise = {}
        for i, label in enumerate(LENET_LEAVES):
            want = ref(*(a[i] if isinstance(a, list) else a for a in args))
            bitwise[label] = all(torch.equal(got[j][i], want[j])
                                 for j in range(3))
        print(json.dumps({"phase": "adam_parity", "kernel": name,
                          "leaf": "LeNet-5's 8 leaves, one launch",
                          "launches": launches, "bitwise_by_leaf": bitwise}),
              flush=True)
        if launches != 1 or not all(bitwise.values()):
            fail(f"{name} over 8 leaves: {launches} launches, bitwise "
                 f"{bitwise}")
    return worst


def trajectory(torch, dev, dataset, dd, optimizer, steps: int = 100):
    """`steps` fused LeNet-5 steps from the seed-0 initial state (batch 200
    and dropout drawn from the state's seeded generator): the per-step
    losses (fetched once, at the end) and the final test accuracy."""
    from dist_mnist_tpu_torch.models.registry import get_model
    from dist_mnist_tpu_torch.train import (
        create_train_state,
        evaluate,
        make_eval_step,
        make_fused_train_step,
    )

    model = get_model("lenet5")
    state = create_train_state(model, optimizer, 0, dataset.train_images[:1],
                               dev)
    step = make_fused_train_step(model, optimizer, dd, 200)
    losses = []
    for _ in range(steps):
        state, out = step(state)
        losses.append(out["loss"])
    losses = torch.stack(losses).cpu().numpy()
    acc = evaluate(make_eval_step(model), state, dataset.test_images,
                   dataset.test_labels, batch_size=10_000)["accuracy"]
    return losses, acc


def time_adam(torch, dev, state, bw: float, f32_peak: float) -> dict:
    """Both Adam kernels over one update of LeNet-5's 8 leaves ("step": one
    launch of the ``*_leaves`` function, as the optimizers make it) and of
    fc1/w alone (the one-leaf function), beside their plain versions (leaf
    by leaf) and the nearest torch call
    (`torch._fused_adam_` / `_fused_adamw_`: eps inside the bias
    correction, params updated in place — a yardstick, not the same
    function), each timed by `graph_ms`; and the bound from the bytes and
    f32 operations each update needs (`fused_adam_cost`).

    A training step finds the Adam slots cold in L2 (the forward and
    backward ran in between), and fc1/w's 19 MB of inputs fit in the
    card's 50 MB L2, so back-to-back calls on one set of operands would
    beat the memory bound. Each call therefore takes the next of
    `ROTATE` copies of its operands (>= 120 MB in all); the kernel is also
    timed on one set (`kernel_ms_l2_warm`)."""
    import itertools

    from dist_mnist_tpu_torch.ops.kernels.fused_adam import (
        adam_leaf_plan,
        fused_adam_clip_wd_update,
        fused_adam_clip_wd_update_leaves,
        fused_adam_clip_wd_update_reference,
        fused_adam_cost,
        fused_adam_update,
        fused_adam_update_leaves,
        fused_adam_update_reference,
    )
    from dist_mnist_tpu_torch.utils.tree import flatten_with_path

    ROTATE = 6
    flat = flatten_with_path(state.params)
    paths = ["/".join(path) for path, _ in flat]
    params = [p for _, p in flat]
    ms = [x for _, x in flatten_with_path(state.opt_state["m"])]
    vs = [x for _, x in flatten_with_path(state.opt_state["v"])]
    gen = torch.Generator(device=dev).manual_seed(2)
    gs = [1e-2 * torch.randn(p.shape, generator=gen, device=dev)
          for p in params]
    lr_t = torch.full((), 1e-3, device=dev)
    scalars = torch.tensor([1e-3, 0.5, 1e-5], device=dev)
    out = {}
    for name, clip_wd in (("fused_adam_update", False),
                          ("fused_adam_clip_wd_update", True)):
        fn = fused_adam_clip_wd_update if clip_wd else fused_adam_update
        leaves_fn = (fused_adam_clip_wd_update_leaves if clip_wd
                     else fused_adam_update_leaves)
        ref = (fused_adam_clip_wd_update_reference if clip_wd
               else fused_adam_update_reference)
        yard = torch._fused_adamw_ if clip_wd else torch._fused_adam_
        extra = (lambda p: (p, scalars)) if clip_wd else (lambda p: (lr_t,))
        for label, idxs in (("step", range(len(params))),
                            ("fc1/w", [paths.index("fc1/w")])):
            # operand sets [(g, m, v, p) per leaf]; the yardstick updates
            # its set in place
            sets = [[tuple(t[i].clone() for t in (gs, ms, vs, params))
                     for i in idxs] for _ in range(ROTATE)]
            steps = [torch.ones((), device=dev) for _ in idxs]

            def cycling(call):
                it = itertools.cycle(sets)
                return lambda: call(next(it))

            def run(f):
                return lambda s: [f(g, m, v, *extra(p)) for g, m, v, p in s]

            def run_leaves(s):
                g, m, v, p = (list(x) for x in zip(*s))
                return leaves_fn(g, m, v, *((p, scalars) if clip_wd
                                            else (lr_t,)))

            kernel = run_leaves if label == "step" else run(fn)

            def run_yard(s):
                g, m, v, p = (list(x) for x in zip(*s))
                yard(p, g, m, v, [], steps, lr=1e-3, beta1=0.9, beta2=0.999,
                     weight_decay=0.01 if clip_wd else 0.0, eps=1e-8,
                     amsgrad=False, maximize=False)

            row = {
                "kernel_ms": graph_ms(torch, cycling(kernel)),
                "kernel_ms_l2_warm": graph_ms(
                    torch, lambda: kernel(sets[0])),
                "plain_ms": graph_ms(torch, cycling(run(ref))),
                "yardstick": f"torch.{yard.__name__}",
                "yardstick_ms": graph_ms(torch, cycling(run_yard)),
            }
            cost = fused_adam_cost([params[i].numel() for i in idxs],
                                   clip_wd=clip_wd)
            t_bytes = cost["hbm_bytes"] / bw * 1e3
            t_ops = cost["flops"] / f32_peak * 1e3
            row.update(bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       hbm_bytes=cost["hbm_bytes"])
            out[(name, label)] = row
            launches = len(adam_leaf_plan([params[i].numel()
                                           for i in idxs]).tables)
            print(json.dumps({"phase": "time", "kernel": name,
                              "shape": label, "launches_per_call": launches,
                              **row}), flush=True)
    return out


#: the decode path's shapes (`bench.py --serve --decode`'s capacity trio):
#: 8 slots + the scratch row, 8 heads of 16, pages of 32 tokens, max_seq 4096
DEC_ROWS, DEC_HEADS, DEC_DIM, DEC_PAGE, DEC_SEQ = 9, 8, 16, 32, 4096
#: one decode step's lengths (pos + 1) on that path: 8 live rows of short
#: requests (prompt <= 32, <= 32 new tokens) and the scratch row
DEC_LENGTHS = [33, 47, 21, 58, 40, 64, 29, 51, 1]
#: the parity mix of lengths (every edge of a 32-token page and a 32-key
#: block, and the full cache)
DEC_MIX = [1, 31, 32, 33, 64, 4096, 1, 4096, 33]


def _kv_pool(torch, quant_mod, gen, pages, dev):
    x = torch.randn(pages, DEC_PAGE, DEC_HEADS, DEC_DIM, generator=gen)
    q, scale = quant_mod.quantize_kv(x.to(dev))
    return quant_mod.QuantizedArray(q, scale, "kv_head")


def _paged_operands(torch, quant_mod, dev, n, lengths, seed):
    """q, int8 K/V pools and a page table of width n for `lengths` (each
    clipped to n pages), every row's pages distinct."""
    gen = torch.Generator().manual_seed(seed)
    pages = max(2 * n * DEC_ROWS, 64)
    kp = _kv_pool(torch, quant_mod, gen, pages, dev)
    vp = _kv_pool(torch, quant_mod, gen, pages, dev)
    q = torch.randn(DEC_ROWS, 1, DEC_HEADS, DEC_DIM, generator=gen).to(dev)
    table = torch.randperm(pages, generator=gen)[:DEC_ROWS * n] \
        .reshape(DEC_ROWS, n).to(torch.int32).to(dev)
    lens = torch.tensor([min(x, n * DEC_PAGE) for x in lengths],
                        dtype=torch.int32).to(dev)
    return q, kp, vp, table, lens


#: the masked forward's Sq > 1 cases in `masked_parity` as (B, Sq, Sk), H = 3,
#: D = 64, lengths from 1 to Sk: ViT's shape (the one-pass kernel), above 128
#: keys (the tiled one), Sq != Sk, Sq > 128 against Sk <= 128, the
#: height-16 bucket's S = 33 (keys padded to 48), and the zoo grid's
#: height-4 and height-8 cells at its max batch, S = 9 and 17 (keys padded
#: to 32; one and two warps a block)
MASKED_SQ_CASES = ((64, 65, 65), (8, 300, 300), (3, 5, 100), (2, 200, 128),
                   (64, 33, 33), (32, 9, 9), (32, 17, 17))


def masked_lengths(b: int, sk: int) -> list[int]:
    """`b` lengths spread from 1 to `sk`, both ends included."""
    return np.linspace(1, sk, b).round().astype(int).tolist()


def decode_kernel_parity(torch, dev) -> dict:
    """Both decode kernels against their plain versions on the same card
    inputs at the decode path's shapes. paged_attention: R=9, H=8, D=16,
    T=32, table widths 1, 2, 4, 8, 128, lengths 1, 31, 32, 33, 64, 4096
    mixed across rows (clipped to the width); masked_flash_attention:
    Sq=1 against Sk 64 and 4096, Sq 7 and 128 against Sk 256 (f32), and
    its Sq > 1 route at `vit_masked_forward`'s shape and lengths
    (`masked_vit_path_parity`), at each masked cell of the zoo grid that
    `zoo_flash_serve` runs (`masked_zoo_path_parity`) and at
    `MASKED_SQ_CASES`, in bf16 and f32
    with the lse (`masked_parity`). Fails unless max abs error <= 1e-5 x
    the largest |out| (paged_attention, and every f32 masked case) and the
    visits are ceil(len / T) pages (clipped to the width). Returns the
    worst absolute error per kernel, the masked forward's routes apart."""
    from dist_mnist_tpu_torch.ops import quant as quant_mod
    from dist_mnist_tpu_torch.ops.kernels.paged_attention import (
        paged_attention_probe,
        paged_attention_reference,
    )

    worst = {"paged_attention": 0.0, "masked_flash_attention": 0.0,
             "masked_flash_attention_sq_gt1": 0.0}
    mix = DEC_MIX
    for n in (1, 2, 4, 8, 128):
        for shift in range(2):  # every length on more than one row
            lengths = mix[shift:] + mix[:shift]
            q, kp, vp, table, lens = _paged_operands(
                torch, quant_mod, dev, n, lengths, seed=n * 10 + shift)
            got, visits = paged_attention_probe(q, kp, vp, table, lens)
            want = paged_attention_reference(q, kp, vp, table, lens)
            torch.cuda.synchronize()
            abs_err, rel = rel_err(got, want)
            pages = -(-lens.cpu() // DEC_PAGE)
            vis_ok = torch.equal(visits.cpu(), pages.float()[:, None]
                                 .expand(-1, DEC_HEADS))
            print(json.dumps({"phase": "paged_parity", "n_pages": n,
                              "lengths": lens.cpu().tolist(),
                              "max_abs_err": abs_err, "max_rel_err": rel,
                              "visits_ok": vis_ok}), flush=True)
            if rel > 1e-5 or not vis_ok:
                fail(f"paged_attention n={n}: rel err {rel}, visits "
                     f"{visits[:, 0].tolist()} vs pages {pages.tolist()}")
            worst["paged_attention"] = max(worst["paged_attention"], abs_err)
    for path in (masked_vit_path_parity, masked_zoo_path_parity):
        for key, err in path(torch, dev).items():
            worst[key] = max(worst[key], err)
    masked_share(torch, dev)
    cases = [(DEC_ROWS, sq, sk, DEC_HEADS, DEC_DIM, torch.float32,
              [min(x, sk) for x in mix])
             for sq, sk in ((1, 64), (1, DEC_SEQ), (7, 256), (128, 256))]
    cases += [(b, sq, sk, 3, 64, dtype, masked_lengths(b, sk))
              for b, sq, sk in MASKED_SQ_CASES
              for dtype in (torch.bfloat16, torch.float32)]
    masked_parity(torch, dev, cases, torch.Generator().manual_seed(3), worst)
    return worst


def masked_vit_path_parity(torch, dev) -> dict:
    """The masked forward's Sq > 1 route at the shape and lengths that
    `vit_masked_forward` gives it (B = 64, Sq = Sk = 33, H = 3, D = 64,
    the bucket's lengths 25 and 33 from `vit_bucket_rows`), in bf16 (the
    path's dtype) and f32, through `masked_parity`. Returns the worst
    absolute error per route (the Sq = 1 one 0)."""
    lengths = (vit_bucket_rows(np.random.default_rng(0))[1] + 1).tolist()
    worst = {"masked_flash_attention": 0.0,
             "masked_flash_attention_sq_gt1": 0.0}
    masked_parity(torch, dev,
                  [(VIT_B, VIT_MASK_S, VIT_MASK_S, VIT_H, VIT_D, dtype,
                    lengths) for dtype in (torch.bfloat16, torch.float32)],
                  torch.Generator().manual_seed(33), worst)
    return worst


#: the zoo grid's batch (`bench.LONGCTX_MAX_BATCH`) and ViT-Tiny's images
ZOO_B, ZOO_IMAGE, ZOO_PATCH = 32, (32, 32, 3), 4


def zoo_cell_lengths(rng) -> dict:
    """For each masked cell of the zoo's auto height ladder of 32 x 32
    images in patches of 4 (heights 4, 8, 16, and the native 32 under a
    mask), `ZOO_B` attention lengths (`SeqGrid.n_tokens` of a real height
    drawn from `rng` within the bucket, and CLS), keyed by the cell's
    attention length S: heights 1..4 give 9 keys, 5..8 give 17, 9..16 25
    or 33, 17..32 41 to 65. Row 0 holds the bucket's full height."""
    from dist_mnist_tpu_torch.serve.zoo import default_seq_grid

    grid = default_seq_grid(ZOO_IMAGE, ZOO_PATCH)
    cells, low = {}, 0
    for h in grid.heights:
        real = rng.integers(low + 1, h + 1, size=ZOO_B)
        real[0] = h
        cells[grid.n_tokens(h) + 1] = [grid.n_tokens(int(r)) + 1
                                       for r in real]
        low = h
    return cells


def masked_zoo_path_parity(torch, dev) -> dict:
    """The masked forward's Sq > 1 route at every masked cell that
    `zoo_flash_serve` runs (B = 32, H = 3, D = 64; S = 9, 17, 33 and 65,
    each with the lengths the grid gives its rows, `zoo_cell_lengths`),
    smallest first, in bf16 (the path's dtype) and f32, through
    `masked_parity`. At S = 9 and 17 the one-pass kernel stages 32 keys
    and runs one and two warps a block, and every row is full, so key S is
    the first padded one. Returns the worst absolute error per route (the
    Sq = 1 one 0)."""
    worst = {"masked_flash_attention": 0.0,
             "masked_flash_attention_sq_gt1": 0.0}
    cases = [(ZOO_B, s_len, s_len, VIT_H, VIT_D, dtype, lengths)
             for s_len, lengths in zoo_cell_lengths(
                 np.random.default_rng(9)).items()
             for dtype in (torch.bfloat16, torch.float32)]
    masked_parity(torch, dev, cases, torch.Generator().manual_seed(9), worst)
    return worst


#: the least share of the bf16 masked forward's outputs (Sk <= 128, the
#: one-pass kernel) equal to its plain version's bf16 values. The plain
#: version follows the reference's streamed rule (the unnormalized p
#: rounded to bf16, one division by l at the end), and at Sk <= 128 the
#: kernel's one tile is the reference's one block of 128 keys, so only a
#: sum in another order or an exp an ulp apart sets an output apart. The
#: normalized rule (p / l rounded to bf16) passes the 1e-2 limits but not
#: this. Read on an H100 80GB HBM3 at 700 W before the limit was set: the
#: checkout 0.99977 (S = 33) and 0.99991 (S = 65), the
#: `masked_normalized_rule` mutant (scripts/torch_flash_mutation_check.py)
#: 0.53770 and 0.55184
MASKED_MATCH_MIN = 0.9


def masked_share(torch, dev) -> float:
    """The bf16 masked forward at Sq > 1 against its plain version on the
    same card inputs: the share of out equal to the plain version's bf16
    values at `vit_masked_forward`'s shape and lengths (B = 64, S = 33,
    lengths 25 and 33), at (64, 65, 65) with lengths 1..65 and at the zoo
    grid's S = 9 and 17 cells with their lengths (B = 32,
    `zoo_cell_lengths`), all on the one-pass kernel, held to
    `MASKED_MATCH_MIN`. Also reads, without a limit, the share of the
    tiled kernel (B = 8, S = 300, lengths 1..300), which rescales every
    64 keys where the reference's blocks hold 128. Fails below the limit;
    returns the smallest checked share."""
    from dist_mnist_tpu_torch.ops.kernels.masked_flash import (
        masked_flash_attention,
        masked_flash_attention_reference,
        masked_forward_body,
    )

    path_lens = (vit_bucket_rows(np.random.default_rng(0))[1] + 1).tolist()
    zoo_lens = zoo_cell_lengths(np.random.default_rng(9))
    gen = torch.Generator().manual_seed(35)
    shares = {}
    for b, s_len, lengths, checked in (
            (VIT_B, VIT_MASK_S, path_lens, True),
            (VIT_B, 65, masked_lengths(VIT_B, 65), True),
            (8, 300, masked_lengths(8, 300), False),
            (ZOO_B, 9, zoo_lens[9], True), (ZOO_B, 17, zoo_lens[17], True)):
        q, k, v = (torch.randn(b, s_len, VIT_H, VIT_D, generator=gen)
                   .to(dev, torch.bfloat16) for _ in range(3))
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        got = masked_flash_attention(q, k, v, lens)
        want = masked_flash_attention_reference(q, k, v, lens)
        torch.cuda.synchronize()
        share = bf16_match_share([got], [want])
        body = masked_forward_body(s_len, s_len, torch.bfloat16)
        shares[(s_len, checked)] = share
        print(json.dumps({"phase": "masked_parity", "case": "bf16 share "
                          "equal to the plain version's bf16 values",
                          "b": b, "sq": s_len, "sk": s_len, "body": body,
                          "share": share, "max_rel_err": rel_err(got,
                                                                 want)[1],
                          "min": MASKED_MATCH_MIN if checked else None}),
              flush=True)
    low = min(v for (_, checked), v in shares.items() if checked)
    if low < MASKED_MATCH_MIN:
        fail(f"bf16 masked forward: {low} of its outputs equal to the plain "
             f"version's bf16 values, below {MASKED_MATCH_MIN}")
    return low


def masked_parity(torch, dev, cases, gen, worst: dict) -> None:
    """Each case (B, Sq, Sk, H, D, dtype, lengths) of masked_flash_attention
    on the card, q/k/v drawn from `gen`, against its plain version: out
    within `FLASH_TOL`'s forward limit of the largest |out| (f32 1e-5, bf16
    1e-2), the lse (Sq > 1, the route that writes it) within `LSE_TOL`,
    and visits ceil(len / 32) key blocks. Fails on any miss; raises
    `worst`'s entry of the case's route to its absolute error."""
    from dist_mnist_tpu_torch.ops.kernels.masked_flash import (
        BLOCK_K,
        masked_flash_attention_forward,
        masked_flash_attention_forward_reference,
        masked_flash_attention_probe,
        masked_flash_attention_reference,
        masked_forward_body,
    )

    for b, sq, sk, h, d, dtype, lengths in cases:
        q, k, v = (torch.randn(b, s, h, d, generator=gen).to(dev, dtype)
                   for s in (sq, sk, sk))
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        got, visits = masked_flash_attention_probe(q, k, v, lens)
        want = masked_flash_attention_reference(q, k, v, lens)
        lse_err = None
        if sq > 1:  # the route that writes the lse the backward reads
            _, lse = masked_flash_attention_forward(q, k, v, lens)
            lse_err = rel_err(lse, masked_flash_attention_forward_reference(
                q, k, v, lens)[1])[1]
        torch.cuda.synchronize()
        abs_err, rel = rel_err(got, want)
        blocks = -(-lens.cpu() // BLOCK_K)
        vis_ok = torch.equal(visits.cpu(), blocks.float()[:, None, None]
                             .expand(-1, h, sq))
        name = str(dtype).removeprefix("torch.")
        tol = FLASH_TOL[name][0]  # the forward's, as the flash forward's
        print(json.dumps({"phase": "masked_parity", "b": b, "sq": sq,
                          "sk": sk, "h": h, "d": d, "dtype": name,
                          "body": masked_forward_body(sq, sk, dtype),
                          "lengths": lens.cpu().tolist(),
                          "max_abs_err": abs_err, "max_rel_err": rel,
                          "lse_max_rel_err": lse_err, "tol": tol,
                          "visits_ok": vis_ok}), flush=True)
        if rel > tol or not vis_ok or (lse_err is not None
                                       and lse_err > LSE_TOL):
            fail(f"masked_flash_attention B={b} Sq={sq} Sk={sk} {name}: rel "
                 f"err {rel}, lse {lse_err}, or visits are not "
                 "ceil(len / 32)")
        key = ("masked_flash_attention" if sq == 1
               else "masked_flash_attention_sq_gt1")
        worst[key] = max(worst[key], abs_err)


def decode_flash(torch, dev, reset_counts, read_counts) -> dict:
    """A continuous engine at the capacity trio's geometry with
    `attention_impl="flash"` (dense cache) serves the bench's seeded
    traffic, and the int8 trio's teacher-forced replay then holds it to
    the dense `"xla"` engine's streams (>= 0.99). Counters are set to 0
    before the flash engine is built and read after its replay: every one
    of its decode steps must launch masked_flash_attention once per
    layer."""
    from dist_mnist_tpu_torch import bench
    from dist_mnist_tpu_torch.serve import (
        DecodeScheduler,
        build_decode_engine,
        make_prompts,
        run_decode_loadgen,
    )

    def serve(engine) -> dict:
        engine.prewarm()
        with DecodeScheduler(engine) as sched:
            return run_decode_loadgen(sched, n_requests=64, concurrency=16,
                                      seed=0, keep_streams=True,
                                      **bench.CAPACITY_TRAFFIC)

    kw = dict(max_slots=bench.DECODE_SLOTS,
              prompt_buckets=bench.CAPACITY_PROMPT_BUCKETS,
              **bench.CAPACITY_GEOM)
    xla = serve(build_decode_engine(dev, **kw))
    reset_counts()
    engine = build_decode_engine(dev, attention_impl="flash", **kw)
    flash = serve(engine)
    reqs = make_prompts(64, max_seq=bench.CAPACITY_GEOM["max_seq"], seed=0,
                        vocab_size=engine.model.vocab_size,
                        **bench.CAPACITY_TRAFFIC)
    hits, total = bench.decode_forced_agreement(engine, reqs, xla["streams"])
    torch.cuda.synchronize()
    counts = read_counts()
    out = {"phase": "decode_flash", "launches": counts,
           "decode_steps": engine.decode_steps, "ok": flash["ok"],
           "errors": flash["errors"], "forced_agreement": hits / total,
           "forced_positions": total,
           "free_running_streams_equal_xla": flash["streams"]
           == xla["streams"],
           "ttft_p99_ms": flash["ttft_p99_ms"],
           "tokens_per_s_mean": flash["tokens_per_s_mean"],
           "xla_tokens_per_s_mean": xla["tokens_per_s_mean"]}
    print(json.dumps(out), flush=True)
    depth = bench.CAPACITY_GEOM["depth"]
    if flash["ok"] != 64 or flash["errors"]:
        fail(f"decode_flash: {flash['ok']}/64 ok, {flash['errors']} errors")
    if counts["masked_flash_attention"] != depth * engine.decode_steps \
            or engine.decode_steps == 0:
        fail(f"decode_flash: {counts['masked_flash_attention']} "
             f"masked_flash_attention launches for {engine.decode_steps} "
             f"decode steps (want {depth} per step)")
    if hits / total < 0.99:
        fail(f"decode_flash: teacher-forced agreement {hits / total} < 0.99")
    return out


def decode_contract(torch, dev) -> dict:
    """Contract (c) on the card: an incremental decode of the capacity
    geometry's dense `"xla"` model, one token per step from position 0,
    against its full forward at every position: bitwise or not, and the
    largest difference."""
    from dist_mnist_tpu_torch import bench
    from dist_mnist_tpu_torch.serve import init_lm_for_serving
    from dist_mnist_tpu_torch.utils.tree import tree_map

    model, params = init_lm_for_serving("causal_tiny", seed=0,
                                        **bench.CAPACITY_GEOM)
    params = tree_map(lambda t: t.to(dev), params)
    gen = torch.Generator().manual_seed(4)
    rows, steps = 2, 64
    tokens = torch.randint(0, model.vocab_size, (rows, steps),
                           generator=gen).to(torch.int32).to(dev)
    with torch.no_grad():
        full, _ = model.apply(params, {}, tokens)
        cache = model.init_cache(rows, device=dev)
        worst, bitwise = 0.0, True
        for pos in range(steps):
            logits, _ = model.decode_step(
                params, cache, tokens[:, pos],
                torch.full((rows,), pos, dtype=torch.int32, device=dev))
            bitwise &= bool(torch.equal(logits, full[:, pos]))
            worst = max(worst, float((logits - full[:, pos]).abs().max()))
    out = {"phase": "decode_contract", "positions": steps, "rows": rows,
           "bitwise": bitwise, "max_abs_diff": worst,
           "max_abs_logit": float(full.abs().max())}
    print(json.dumps(out), flush=True)
    if not np.isfinite(worst) or worst > 1e-4:
        fail(f"decode_contract: decode vs full forward differ by {worst}")
    return out


def decode_profile(torch, dev) -> dict:
    """Where one int8 decode step of the capacity trio spends its time:
    8 live slots (prompts of 32, a few steps in), the host wall of
    `engine.decode` (dispatch to token ids on the host) and the device
    time by kernel from `torch.profiler`."""
    from dist_mnist_tpu_torch import bench
    from dist_mnist_tpu_torch.serve import build_decode_engine, make_prompts

    engine = build_decode_engine(
        dev, max_slots=bench.DECODE_SLOTS,
        prompt_buckets=bench.CAPACITY_PROMPT_BUCKETS, **bench.CAPACITY_GEOM,
        cache_layout="paged", kv_page_tokens=32, kv_quant="int8")
    engine.prewarm()
    reqs = make_prompts(engine.max_slots, max_seq=DEC_SEQ, seed=5,
                        min_prompt=32, max_prompt=32,
                        vocab_size=engine.model.vocab_size)
    slots = list(range(engine.max_slots))
    for slot, (prompt, _) in zip(slots, reqs):
        engine.try_reserve(slot, len(prompt) + 32)
    first = engine.prefill([p for p, _ in reqs], slots)
    tokens = np.zeros(engine.grid.rows, np.int32)
    positions = np.zeros(engine.grid.rows, np.int32)
    tokens[:len(slots)] = first
    positions[:len(slots)] = 32
    for _ in range(5):  # warm-up steps
        tokens = engine.decode(tokens, positions)
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        tokens = engine.decode(tokens, positions)
    wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            tokens = engine.decode(tokens, positions)
    out = {"phase": "decode_profile", "live_slots": len(slots),
           "lengths": (positions[:len(slots)] + 1).tolist(),
           **profile_fields(torch, prof, reps, wall_ms)}
    print(json.dumps(out), flush=True)
    return out


def _same_bits(torch, a, b) -> bool:
    return torch.equal(a.contiguous().view(torch.uint8),
                       b.contiguous().view(torch.uint8))


def decode_repeat(torch, dev) -> dict:
    """Each decode kernel, and the masked forward's Sq > 1 route, gives the
    same bits on a second call and on a second stream: `paged_attention`
    at table widths 2 (`DEC_LENGTHS`) and 128 (`DEC_MIX`), the masked
    forward at Sq = 1 against Sk = 4096 (`DEC_MIX`) in f32 and bf16, and at
    Sq > 1 (out and lse) at ViT's shape (B = 64, Sq = Sk = 65, the one-pass
    kernel) and above 128 keys (B = 8, Sq = Sk = 300, the tiled kernel),
    H = 3, D = 64, in bf16 and f32. Fails on any difference."""
    from dist_mnist_tpu_torch.ops import quant as quant_mod
    from dist_mnist_tpu_torch.ops.kernels.masked_flash import (
        masked_flash_attention,
        masked_flash_attention_forward,
    )
    from dist_mnist_tpu_torch.ops.kernels.paged_attention import (
        paged_attention,
    )

    cases = []
    for n, lengths in ((2, DEC_LENGTHS), (128, DEC_MIX)):
        ops = _paged_operands(torch, quant_mod, dev, n, lengths, seed=200 + n)
        cases.append((f"paged_attention n_pages={n}",
                       lambda ops=ops: (paged_attention(*ops),)))
    gen = torch.Generator().manual_seed(11)
    lens = torch.tensor(DEC_MIX, dtype=torch.int32, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        qkv = tuple(torch.randn(DEC_ROWS, s, DEC_HEADS, DEC_DIM, generator=gen)
                    .to(dev, dtype) for s in (1, DEC_SEQ, DEC_SEQ))
        cases.append((f"masked_flash_attention sq=1 sk={DEC_SEQ} {dtype}",
                      lambda qkv=qkv: (masked_flash_attention(*qkv, lens),)))
    for b, s_len in ((64, 65), (8, 300)):
        lens_s = torch.tensor(masked_lengths(b, s_len), dtype=torch.int32,
                              device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            qkv = tuple(torch.randn(b, s_len, 3, 64, generator=gen)
                        .to(dev, dtype) for _ in range(3))
            cases.append((
                f"masked_flash_attention sq={s_len} sk={s_len} {dtype} "
                "(out, lse)",
                lambda qkv=qkv, lens_s=lens_s: masked_flash_attention_forward(
                    *qkv, lens_s)))
    out = {}
    for name, fn in cases:
        first, again = fn(), fn()
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            other = fn()
        torch.cuda.current_stream().wait_stream(stream)
        torch.cuda.synchronize()
        same = all(_same_bits(torch, a, b) and _same_bits(torch, a, c)
                   for a, b, c in zip(first, again, other))
        out[name] = same
        print(json.dumps({"phase": "decode_repeat", "case": name,
                          "bitwise_twice_and_other_stream": same}),
              flush=True)
        if not same:
            fail(f"decode_repeat: {name} gives other bits on a second call "
                 "or stream")
    return out


def time_decode_kernels(torch, dev, bw: float, f32_peak: float,
                        bf16_peak: float = 989e12) -> dict:
    """Both decode kernels at one decode step of the path (`DEC_LENGTHS`:
    paged_attention at table widths 2 and 128, masked_flash_attention at
    Sq=1 against the dense max_seq=4096 cache), at every length 4096 (the
    long context: paged width 128, masked Sq = 1 against Sk = 4096), and
    the masked forward's Sq > 1 route at the masked backward's shape (B =
    64, S = 65, H = 3, D = 64, lengths 2..65), above 128 keys (B = 8,
    S = 300, lengths 2..300) and at `vit_masked_forward`'s shape (B = 64,
    S = 33, the bucket's lengths), bf16 and f32, beside their plain versions,
    a torch yardstick, the bound and the launch floor, each timed by
    `graph_ms` (L2 warm).

    Yardsticks: no one torch call computes paged int8 attention, so the
    paged rows' is a COMPOSITE (gather the table's pages, dequantize, then
    `F.scaled_dot_product_attention` with the prefix mask); the masked
    rows' is the one call `F.scaled_dot_product_attention(q, k, v,
    attn_mask=prefix_mask)` on [B, H, S, D] copies of the operands. The
    port calls neither. Bounds: the bytes each call must move (paged: the
    ACTIVE pages' int8 tiles and scales, `paged_attention_cost`
    "active_bytes"; masked: each row's first `len` K and V rows) over the
    memory rate, against the operations over the operands' peak (f32, or
    bf16 for the bf16 row). `launch_floor_ms`: an empty kernel with the
    kernel's grid, block and arguments (`*_launch_floor`)."""
    import torch.nn.functional as F

    from dist_mnist_tpu_torch.ops import quant as quant_mod
    from dist_mnist_tpu_torch.ops.kernels.masked_flash import (
        masked_flash_attention,
        masked_flash_attention_launch_floor,
        masked_flash_attention_reference,
        masked_flash_cost,
        masked_forward_body,
    )
    from dist_mnist_tpu_torch.ops.kernels.paged_attention import (
        paged_attention,
        paged_attention_cost,
        paged_attention_launch_floor,
        paged_attention_reference,
    )

    def bound(cost_bytes, flops, peak=f32_peak):
        t_bytes, t_ops = cost_bytes / bw * 1e3, flops / peak * 1e3
        return {"bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bound_bytes": cost_bytes, "bound_flops": flops}

    out = {}
    # the path's bucket, the widest table, and the widest table full
    for key, n, lengths in ((("paged_attention", 2), 2, DEC_LENGTHS),
                            (("paged_attention", 128), 128, DEC_LENGTHS),
                            (("paged_attention", 128, "len4096"), 128,
                             [DEC_SEQ] * DEC_ROWS)):
        q, kp, vp, table, lens = _paged_operands(
            torch, quant_mod, dev, n, lengths, seed=99)
        idx = table.long()
        mask = (torch.arange(n * DEC_PAGE, device=dev)[None, :]
                < lens[:, None])[:, None, None, :]

        def composite():
            k = (kp.q[idx].float() * kp.scale[idx]).reshape(
                DEC_ROWS, -1, DEC_HEADS, DEC_DIM).transpose(1, 2)
            v = (vp.q[idx].float() * vp.scale[idx]).reshape(
                DEC_ROWS, -1, DEC_HEADS, DEC_DIM).transpose(1, 2)
            return F.scaled_dot_product_attention(q.transpose(1, 2), k, v,
                                                  attn_mask=mask)

        cost = paged_attention_cost(lens.cpu().numpy(), n, DEC_PAGE,
                                    DEC_HEADS, DEC_DIM)
        row = {"kernel_ms": graph_ms(torch, lambda: paged_attention(
                   q, kp, vp, table, lens)),
               "launch_floor_ms": graph_ms(
                   torch, lambda: paged_attention_launch_floor(
                       q, kp, vp, table, lens)),
               "plain_ms": graph_ms(torch, lambda: paged_attention_reference(
                   q, kp, vp, table, lens)),
               "library_ms": None,
               "composite": "gather + dequant + F.scaled_dot_product_attention"
                            " (prefix mask)",
               "composite_ms": graph_ms(torch, composite),
               "reference_cost_hbm_bytes": cost["hbm_bytes"],
               **bound(cost["active_bytes"], cost["flops"])}
        out[key] = row
        print(json.dumps({"phase": "time", "kernel": "paged_attention",
                          "n_pages": n, "lengths": lens.cpu().tolist(),
                          **row}), flush=True)

    def masked_row(key, q, k, v, lens, peak, **fields):
        b, sq, h, d = q.shape
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        mask = (torch.arange(k.shape[1], device=dev)[None, :]
                < lens[:, None])[:, None, None, :]
        cost = masked_flash_cost(lens.cpu().numpy(), sq, h, d,
                                 itemsize=q.element_size())
        row = {"kernel_ms": graph_ms(torch, lambda: masked_flash_attention(
                   q, k, v, lens)),
               "launch_floor_ms": graph_ms(
                   torch, lambda: masked_flash_attention_launch_floor(
                       q, k, v, lens)),
               "plain_ms": graph_ms(
                   torch, lambda: masked_flash_attention_reference(
                       q, k, v, lens)),
               "library": "F.scaled_dot_product_attention(q, k, v, "
                          "attn_mask=prefix_mask)",
               "library_ms": graph_ms(
                   torch, lambda: F.scaled_dot_product_attention(
                       qt, kt, vt, attn_mask=mask)),
               **bound(cost["hbm_bytes"], cost["flops"], peak)}
        out[key] = row
        print(json.dumps({"phase": "time", "kernel": "masked_flash_attention",
                          "sq": sq, "sk": k.shape[1], "dtype": str(q.dtype),
                          **fields, **row}), flush=True)

    gen = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn(DEC_ROWS, s, DEC_HEADS, DEC_DIM,
                           generator=gen).to(dev) for s in (1, DEC_SEQ,
                                                            DEC_SEQ))
    masked_row(("masked_flash_attention", DEC_SEQ), q, k, v,
               torch.tensor(DEC_LENGTHS, dtype=torch.int32, device=dev),
               f32_peak, lengths=DEC_LENGTHS)
    masked_row(("masked_flash_attention", DEC_SEQ, "len4096"), q, k, v,
               torch.full((DEC_ROWS,), DEC_SEQ, dtype=torch.int32, device=dev),
               f32_peak, lengths=f"{DEC_SEQ} x {DEC_ROWS}")
    # the Sq > 1 route (the flash forward's kernels with the lengths): at
    # the masked backward's shape (the one-pass kernel in bf16), above 128
    # keys (the tiled kernel in bf16), and at `vit_masked_forward`'s shape
    # and lengths
    h, d = 3, 64
    path_lens = (vit_bucket_rows(np.random.default_rng(0))[1] + 1).tolist()
    for b, s_len, seed, lengths in (
            (64, 65, 8, np.linspace(2, 65, 64).round().astype(int).tolist()),
            (8, 300, 9, np.linspace(2, 300, 8).round().astype(int).tolist()),
            (VIT_B, VIT_MASK_S, 10, path_lens)):
        gen = torch.Generator().manual_seed(seed)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        label = ("the bucket's 25 and 33" if s_len == VIT_MASK_S
                 else f"2..{s_len}")
        for dtype, peak in ((torch.bfloat16, bf16_peak),
                            (torch.float32, f32_peak)):
            q, k, v = (torch.randn(b, s_len, h, d, generator=gen)
                       .to(dev, dtype) for _ in range(3))
            masked_row((f"masked_flash_attention_sq{s_len}", str(dtype)), q,
                       k, v, lens, peak, lengths=label,
                       body=masked_forward_body(s_len, s_len, dtype))
    return out


#: the int8 MLP's served logits against the plain engine's: f32 sums in
#: another order, relative to the largest logit
MLP_LOGIT_TOL = 1e-4


def mlp_serve(torch, dev, reset_counts, read_counts) -> dict:
    """The serving CLI's default config (`mlp_mnist`, f32 compute) served
    `--quant=int8` through its entry point (`cli/serve.py main`, fresh
    seeded init, 512 requests, concurrency 64), with every launch counter
    set to 0 just before and read just after: exactly 2 `quant_matmul`
    launches (hid, sm) per batch the engine ran, prewarm included, every
    one on the f32 route, and no launch of any other kernel. Then one
    fixed batch of 64 served logits against the same engine with the
    kernel swapped for its plain version (within `MLP_LOGIT_TOL` of the
    largest logit, the same top-1 on >= 98% of rows), and the host wall
    and device time by kernel of one served batch of 64. Fails on any
    miss; returns the phase's record."""
    from dist_mnist_tpu_torch.cli import serve as serve_cli
    from dist_mnist_tpu_torch.ops import quant as quant_mod
    from dist_mnist_tpu_torch.ops.kernels.quant_matmul import (
        quant_matmul,
        quant_matmul_reference,
    )
    from dist_mnist_tpu_torch.serve import (
        InferenceEngine,
        load_for_serving,
        make_images,
    )

    reset_counts()
    quant_matmul.f32_launches = 0
    summary = serve_cli.main([
        "--quant=int8", f"--device={dev}", "--max_batch=64",
        "--requests=512", "--concurrency=64"])
    counts = read_counts()
    f32_launches = quant_matmul.f32_launches
    n_runs = summary["cache"]["hits"] + summary["cache"]["misses"]
    out = {"phase": "mlp_serve", "config": "mlp_mnist", "launches": counts,
           "quant_matmul_f32_launches": f32_launches, "batches_run": n_runs,
           **{k: summary[k] for k in ("ok", "errors", "p50_ms", "p99_ms",
                                      "n_batches", "mean_batch_size",
                                      "cache")}}
    if summary["ok"] != 512 or summary["errors"] != 0:
        fail(f"mlp_serve: {summary['ok']}/512 ok, {summary['errors']} errors")
    if counts["quant_matmul"] != 2 * n_runs or n_runs == 0 \
            or f32_launches != counts["quant_matmul"]:
        fail(f"mlp_serve: {counts['quant_matmul']} quant_matmul launches "
             f"({f32_launches} f32) for {n_runs} MLP batches (want 2 per "
             "batch, hid and sm, all f32)")
    others = {k: v for k, v in counts.items() if k != "quant_matmul" and v}
    if others:
        fail(f"mlp_serve: other kernels launched on the MLP path: {others}")

    bundle = load_for_serving("mlp_mnist", dev, quant="int8")
    engine = InferenceEngine(
        bundle.model, bundle.params, bundle.model_state, device=dev,
        image_shape=bundle.image_shape, max_bucket=64)
    images = make_images(bundle.image_shape, seed=123, n=64)
    served = engine.predict(images)
    quant_mod.quant_matmul = quant_matmul_reference
    try:
        plain = engine.predict(images)
    finally:
        quant_mod.quant_matmul = quant_matmul
    top = float(np.max(np.abs(plain)))
    diff = float(np.max(np.abs(served - plain)))
    agree = float(np.mean(served.argmax(-1) == plain.argmax(-1)))
    out.update(logits_shape=list(served.shape), max_abs_logit=top,
               max_abs_diff_vs_plain=diff,
               max_rel_diff_vs_plain=diff / (top + 1e-12),
               top1_agreement=agree, tol=MLP_LOGIT_TOL)
    if served.shape != (64, 10) or not np.isfinite(served).all():
        fail(f"mlp_serve logits: shape {served.shape} or non-finite values")
    if not diff <= MLP_LOGIT_TOL * top or agree < 0.98:
        fail(f"mlp_serve logits vs plain path: max abs {diff} (largest "
             f"{top}), top-1 {agree}")

    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        engine.predict(images)
    wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            engine.predict(images)
    out["profile"] = {"batch": 64, **profile_fields(torch, prof, reps,
                                                    wall_ms)}
    print(json.dumps(out), flush=True)
    return out


#: ViT-Tiny's attention shape on the training path (`vit_tiny_cifar_flash`,
#: per-chip batch 64): 64 patch tokens + CLS, 3 heads of 64
VIT_B, VIT_S, VIT_H, VIT_D = 64, 65, 3, 64
#: rows of the `quant_matmul` parity cases: the timed ones (1, 7 and 64),
#: and each route's tile edges (bf16: 64 rows a tile; f32: M rounded up to
#: a power of two, at most 16 rows a tile). The f32 rows take in every
#: batch bucket the serving engine pads the MLP's batches to (1 .. 64), so
#: each of the kernel's row counts runs here at the path's own shapes
QMM_ROWS = (1, 7, 64)
QMM_BF16_ROWS = (1, 7, 16, 17, 64, 65, 200)
QMM_F32_ROWS = (1, 2, 4, 7, 8, 16, 17, 32, 64, 65, 200)
QMM_TIMED = ("lenet5/fc1", "lenet5/fc2", "mlp/hid", "mlp/sm")


#: `quant_matmul` parity shapes: (label, K, H, dtypes). LeNet-5's fc1 and
#: fc2 in bf16, the MLP's layers in f32, and in both routes a K the split
#: size does not divide and rows that are not aligned (K % 8, H % 16: the
#: plain-load staging in bf16, plain x loads in f32)
QMM_SHAPES = (("lenet5/fc1", 3136, 512, ("bfloat16",)),
              ("lenet5/fc2", 512, 10, ("bfloat16",)),
              ("mlp/hid", 784, 100, ("float32",)),
              ("mlp/sm", 100, 10, ("float32",)),
              ("ragged-k", 1000, 96, ("bfloat16", "float32")),
              ("unaligned", 1001, 40, ("bfloat16", "float32")))
#: kernel-vs-plain limits relative to the largest output: one bf16 ulp;
#: f32 sums taken in another order
QMM_TOL = {"bfloat16": 1e-2, "float32": 2e-5}


def qmm_parity(torch, dev) -> tuple[dict, dict]:
    """`quant_matmul` against its plain version on the same card inputs at
    `QMM_SHAPES`, bf16 at `QMM_BF16_ROWS` rows and f32 at `QMM_F32_ROWS`,
    within `QMM_TOL` of the largest output. Fails on any miss. Returns the
    timed shapes' operands and the worst errors."""
    from dist_mnist_tpu_torch.ops import quant as quant_mod
    from dist_mnist_tpu_torch.ops.kernels.quant_matmul import (
        quant_matmul,
        quant_matmul_reference,
    )

    gen = torch.Generator().manual_seed(0)
    operands, worst = {}, {"abs": 0.0, "rel": 0.0}
    for label, d, h, dtypes in QMM_SHAPES:
        w = torch.randn(d, h, generator=gen) / d ** 0.5
        qa = quant_mod.quantize(w.to(dev))
        for name in dtypes:
            dtype = getattr(torch, name)
            ms = QMM_BF16_ROWS if name == "bfloat16" else QMM_F32_ROWS
            for m in ms:
                x = torch.rand(m, d, generator=gen).to(dev, dtype)
                got = quant_matmul(x, qa.q, qa.scale)
                want = quant_matmul_reference(x, qa.q, qa.scale)
                torch.cuda.synchronize()
                abs_err, rel = rel_err(got, want)
                tol = QMM_TOL[name]
                print(json.dumps({"phase": "parity", "shape": label, "m": m,
                                  "dtype": str(dtype), "max_abs_err": abs_err,
                                  "max_rel_err": rel, "tol": tol}),
                      flush=True)
                if not (got.shape == want.shape and rel <= tol):
                    fail(f"quant_matmul {label} {name} M={m}: rel err {rel} "
                         f"> {tol}")
                worst["abs"] = max(worst["abs"], abs_err)
                worst["rel"] = max(worst["rel"], rel)
                if m in QMM_ROWS and label in QMM_TIMED:
                    operands[(label, m)] = (x, qa)
    return operands, worst


def split_k_repeat(torch, dev) -> None:
    """Both split-K reductions sum their partials in split order,
    whichever block arrives last: at fc1's shape (bf16) and the MLP's
    hidden layer (f32), the same inputs give the same bits twice and under
    another stream. Fails on any bit."""
    from dist_mnist_tpu_torch.ops import quant as quant_mod
    from dist_mnist_tpu_torch.ops.kernels.quant_matmul import (
        quant_matmul,
        route_tile,
        split_k_plan,
    )

    gen = torch.Generator().manual_seed(1)
    for label, d, h, dtype, bits, ms in (
            ("lenet5/fc1", 3136, 512, torch.bfloat16, torch.int16,
             (7, 64, 200)),
            ("mlp/hid", 784, 100, torch.float32, torch.int32,
             (1, 7, 64, 200))):
        qa = quant_mod.quantize((torch.randn(d, h, generator=gen)
                                 / d ** 0.5).to(dev))
        for m in ms:
            x = torch.rand(m, d, generator=gen).to(dev, dtype)
            first = quant_matmul(x, qa.q, qa.scale)
            again = quant_matmul(x, qa.q, qa.scale)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                other = quant_matmul(x, qa.q, qa.scale)
            torch.cuda.synchronize()
            same = (torch.equal(first.view(bits), again.view(bits))
                    and torch.equal(first.view(bits), other.view(bits)))
            print(json.dumps({"phase": "parity", "check": "split-K bitwise "
                              "repeat (twice, and under another stream)",
                              "shape": label, "dtype": str(dtype), "m": m,
                              "splits": split_k_plan(
                                  m, d, h, route_tile(dtype, m))[1],
                              "bitwise": same}), flush=True)
            if not same:
                fail(f"quant_matmul {label} M={m}: split-K repeat changed "
                     "bits")


#: kernel-vs-plain tolerances, relative to the largest |value|: bf16
#: outputs are rounded once from f32 sums taken in another order (one bf16
#: ulp, 2^-8, of the largest value); f32 forward 1e-5 (as the decode
#: kernels); f32 backward 1e-4 (dS = P (dP - delta) cancels); the f32 lse
#: 1e-5
FLASH_TOL = {"bfloat16": (1e-2, 1e-2), "float32": (1e-5, 1e-4)}
LSE_TOL = 1e-5


def grad_errs(grads, want) -> list[tuple[float, float]]:
    """(max abs error, relative error) of each of dq, dk, dv, relative to
    the largest value of the same gradient, or to 2^-8 of the call's
    largest gradient where that is larger: at S = 1 dq and dk are 0 in
    exact arithmetic, and a kernel's f32 dP - delta, summed in another
    order than delta, leaves ~1e-7 there."""
    top = max(float(w.detach().float().abs().max()) for w in want)
    out = []
    for got, ref in zip(grads, want):
        err = float((got.detach().float() - ref.detach().float()).abs().max())
        out.append((err, err / max(float(ref.detach().float().abs().max()),
                                   top / 256, 1e-12)))
    return out


def bwd_route(torch, dtype) -> str:
    """The backward body a dtype takes: bf16 the tensor-core kernels
    (`flash_dq_mma`, `flash_dkv_mma`), f32 the register-tiled FMA kernels
    on the CUDA cores (`flash_dq_f32`, `flash_dkv_f32`)."""
    return "mma" if dtype == torch.bfloat16 else "fma"


def _fused_qkv(torch, b, s, h, d, dtype, dev, seed):
    """q, k, v as the ViT path gives them: strided views of one [B, S, 3,
    H, D] projection."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(b, s, 3, h, d, generator=gen).to(dev, dtype).unbind(2)


#: the least share of the bf16 backward's dq, dk and dv elements at ViT's
#: call equal to the plain version's bf16 values. The hi/lo split keeps
#: each f32-operand term to 2^-16, so only sums within ~2^-16 of a bf16
#: rounding boundary round the other way; P and dS rounded to bf16 once
#: (the lo products dropped) leave ~2^-9 per term, half an ulp of the
#: output. Emulated on the CPU (`tests/test_torch_flash.py`): 0.998 and
#: 0.589, both within 4.2e-3 relative. An error in ulps tells them apart less well: where dS cancels,
#: the plain value is near 0 and every ulp count is large.
SPLIT_MATCH_MIN = 0.9


def bf16_match_share(grads, want) -> float:
    """The share of all the elements of `grads` equal to those of `want`."""
    same = sum(int((a == w).sum()) for a, w in zip(grads, want))
    return same / sum(w.numel() for w in want)


def flash_split_share(torch, dev) -> float:
    """The bf16 backward at ViT's call (the fused projection's strided
    views, the kernel's own lse and delta): the share of dq, dk and dv
    equal to the plain version's bf16 values, held to `SPLIT_MATCH_MIN`.
    It tells the hi/lo split from P and dS rounded to bf16 once, which
    the 1e-2 limit cannot. Fails below it; returns the share."""
    from dist_mnist_tpu_torch.ops.kernels import flash_attention as fa

    q, k, v = _fused_qkv(torch, VIT_B, VIT_S, VIT_H, VIT_D, torch.bfloat16,
                         dev, seed=90)
    do = torch.randn(VIT_B, VIT_S, VIT_H, VIT_D, generator=torch.Generator()
                     .manual_seed(91)).to(dev, torch.bfloat16)
    out, lse = fa.flash_attention_forward(q, k, v)
    delta = fa.attention_delta(out, do)
    grads = (fa.flash_attention_dq(q, k, v, do, lse, delta),
             *fa.flash_attention_dkv(q, k, v, do, lse, delta))
    want = fa.flash_attention_backward_reference(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    share = bf16_match_share(grads, want)
    print(json.dumps({"phase": "flash_parity", "case": "bf16 backward, "
                      "share equal to the plain version's bf16 values",
                      "bwd_route": "mma", "share": share,
                      **{f"{g}_share": bf16_match_share([a], [w])
                         for g, a, w in zip(("dq", "dk", "dv"), grads,
                                            want)},
                      "min": SPLIT_MATCH_MIN,
                      **{f"{g}_max_rel_err": rel_err(a, w)[1]
                         for g, a, w in zip(("dq", "dk", "dv"), grads,
                                            want)}}), flush=True)
    if share < SPLIT_MATCH_MIN:
        fail(f"bf16 flash backward: {share} of dq/dk/dv equal to the plain "
             f"version's bf16 values, below {SPLIT_MATCH_MIN}")
    return share


def flash_parity(torch, dev) -> dict:
    """The flash kernels against their plain versions on the same card
    inputs: the forward (out, lse) and the backward (dq, dk, dv, from the
    kernel's own lse and delta) at ViT's shape for B in {1, 7, 64} in bf16
    and f32, at S = 17 and S = 300 with block_k = 128 (the streamed
    rounding at S = 300); in bf16 (the tensor-core kernels) and f32 (the
    register-tiled forward, the FMA backward) the forward and backward at
    S in {1, 17, 65, 128, 129, 300} with and without block_k = 128, D in
    {16, 40, 64, 128} and views that are not 16-byte aligned, one launch
    of each kernel a case; the bf16 backward at Sq != Sk, unmasked and
    masked; its bits at ViT's shape
    twice and under another stream, and the share of them equal to the
    plain version's bf16 values (`flash_split_share`, at least
    `SPLIT_MATCH_MIN`); `flash_attention_lse` through its
    autograd Function with a nonzero lse cotangent; and the masked
    backward at ViT's shape with lengths 1 .. 65 (B = 65): dk and dv past
    each length exactly 0, and the key steps and blocks each kernel
    entered exactly ceil(len / TILE) and ceil(len / KEY_BLOCK). Each line
    names the backward's body (`bwd_route`: "mma" or "fma"). Fails on any
    miss. Returns the worst abs errors by kernel."""
    from dist_mnist_tpu_torch.ops.kernels import flash_attention as fa
    from dist_mnist_tpu_torch.ops.kernels.masked_flash import (
        masked_flash_attention_backward,
        masked_flash_attention_backward_probe,
        masked_flash_attention_forward,
    )

    worst = {"flash_attention_forward": 0.0, "flash_attention_backward": 0.0,
             "masked_flash_attention_backward": 0.0}
    cases = [(b, VIT_S, VIT_H, VIT_D, dt, None) for b in (1, 7, 64)
             for dt in (torch.bfloat16, torch.float32)]
    cases += [(2, s, 2, 64, dt, 128) for s in (17, 300)
              for dt in (torch.bfloat16, torch.float32)]
    for i, (b, s, h, d, dtype, block_k) in enumerate(cases):
        q, k, v = _fused_qkv(torch, b, s, h, d, dtype, dev, seed=20 + i)
        do = torch.randn(b, s, h, d, generator=torch.Generator()
                         .manual_seed(40 + i)).to(dev, dtype)
        bk = fa.quantize_block_k(block_k, s)
        out, lse = fa.flash_attention_forward(q, k, v, bk)
        delta = fa.attention_delta(out, do)
        grads = (fa.flash_attention_dq(q, k, v, do, lse, delta),
                 *fa.flash_attention_dkv(q, k, v, do, lse, delta))
        want_out, want_lse = fa.flash_attention_forward_reference(q, k, v, bk)
        want = fa.flash_attention_backward_reference(q, k, v, do, lse, delta)
        torch.cuda.synchronize()
        name = str(dtype).removeprefix("torch.")
        fwd_tol, bwd_tol = FLASH_TOL[name]
        errs = {"out": rel_err(out, want_out), "lse": rel_err(lse, want_lse),
                **{g: rel_err(a, w) for g, a, w in zip(("dq", "dk", "dv"),
                                                        grads, want)}}
        print(json.dumps({"phase": "flash_parity", "b": b, "s": s, "h": h,
                          "d": d, "dtype": name, "block_k": block_k,
                          "rounding": "normalized" if bk is None
                          else "streamed", "bwd_route": bwd_route(torch, dtype),
                          **{f"{n}_max_abs_err": e[0]
                             for n, e in errs.items()},
                          **{f"{n}_max_rel_err": e[1]
                             for n, e in errs.items()},
                          "tol": {"fwd": fwd_tol, "lse": LSE_TOL,
                                  "bwd": bwd_tol}}), flush=True)
        if errs["out"][1] > fwd_tol or errs["lse"][1] > LSE_TOL:
            fail(f"flash forward B={b} S={s} {name}: out {errs['out']}, "
                 f"lse {errs['lse']}")
        if any(errs[g][1] > bwd_tol for g in ("dq", "dk", "dv")):
            fail(f"flash backward B={b} S={s} {name}: {errs}")
        worst["flash_attention_forward"] = max(
            worst["flash_attention_forward"], errs["out"][0])
        worst["flash_attention_backward"] = max(
            worst["flash_attention_backward"],
            *(errs[g][0] for g in ("dq", "dk", "dv")))

    # both routes' forward and backward at ragged S (bf16: one pass up to
    # 128, tiles of 64 above; f32: one tile of every key up to 128, tiles
    # of 64 above; block_k = 128 streams above 128), every padded head dim
    # (D = 40 zero-padded to 64) and views that are not 16-byte aligned;
    # the backward from the forward's own lse and delta
    ragged = [(3, s, 2, 64, "fused", bk)
              for s in (1, 17, 65, 128, 129, 300) for bk in (None, 128)]
    ragged += [(2, s, 2, d, "contiguous", bk) for d in (16, 40, 64, 128)
               for s, bk in ((65, None), (300, None), (300, 128))]
    ragged += [(2, s, 3, 64, "unaligned", bk)
               for s, bk in ((65, None), (129, None), (129, 128))]
    counters = (fa.flash_attention_forward, fa.flash_attention_dq,
                fa.flash_attention_dkv)
    for dtype, seed in ((torch.bfloat16, 100), (torch.float32, 400)):
        name = str(dtype).removeprefix("torch.")
        fwd_tol, bwd_tol = FLASH_TOL[name]
        for i, (b, s, h, d, layout, block_k) in enumerate(ragged):
            q, k, v = _fused_qkv(torch, b, s, h, d, dtype, dev, seed=seed + i)
            if layout == "contiguous":
                q, k, v = (t.contiguous() for t in (q, k, v))
            elif layout == "unaligned":  # one element past a 16-byte start
                q, k, v = (torch.cat([t.new_zeros(1), t.flatten()])[1:]
                           .view(t.shape) for t in (q, k, v))
            do = torch.randn(b, s, h, d, generator=torch.Generator()
                             .manual_seed(seed + 100 + i)).to(dev, dtype)
            bk = fa.quantize_block_k(block_k, s)
            before = [fn.launches for fn in counters]
            out, lse = fa.flash_attention_forward(q, k, v, bk)
            delta = fa.attention_delta(out, do)
            grads = (fa.flash_attention_dq(q, k, v, do, lse, delta),
                     *fa.flash_attention_dkv(q, k, v, do, lse, delta))
            want_out, want_lse = fa.flash_attention_forward_reference(
                q, k, v, bk)
            want = fa.flash_attention_backward_reference(q, k, v, do, lse,
                                                         delta)
            torch.cuda.synchronize()
            errs = {"out": rel_err(out, want_out),
                    "lse": rel_err(lse, want_lse),
                    **dict(zip(("dq", "dk", "dv"), grad_errs(grads, want)))}
            launched = [fn.launches - n for fn, n in zip(counters, before)]
            print(json.dumps({
                "phase": "flash_parity", "case": f"{name} forward and "
                "backward", "dtype": name, "b": b, "s": s, "h": h, "d": d,
                "layout": layout, "aligned16": fa.views_aligned16(q, k, v),
                "fwd_plan": fa.f32_forward_plan(b, s, s, h, d)
                if dtype == torch.float32 else None,
                "block_k": block_k, "rounding": "normalized"
                if bk is None else "streamed",
                "bwd_route": bwd_route(torch, dtype),
                "launches_fwd_dq_dkv": launched,
                **{f"{n}_max_abs_err": e[0] for n, e in errs.items()},
                **{f"{n}_max_rel_err": e[1] for n, e in errs.items()},
                "tol": {"fwd": fwd_tol, "lse": LSE_TOL, "bwd": bwd_tol}}),
                flush=True)
            if launched != [1, 1, 1] or errs["out"][1] > fwd_tol \
                    or errs["lse"][1] > LSE_TOL \
                    or any(errs[g][1] > bwd_tol for g in ("dq", "dk", "dv")):
                fail(f"{name} flash B={b} S={s} D={d} {layout} "
                     f"block_k={block_k}: {launched} launches, {errs}")
            worst["flash_attention_forward"] = max(
                worst["flash_attention_forward"], errs["out"][0])
            worst["flash_attention_backward"] = max(
                worst["flash_attention_backward"],
                *(errs[g][0] for g in ("dq", "dk", "dv")))

    # Sq != Sk (the masked decode shapes): both routes' backward kernels,
    # through their launches unmasked and through the masked backward with
    # lengths
    sq_sk = ((7, 200, False), (130, 65, False), (1, 300, True), (70, 33, True))
    for i, (dtype, (sq, sk, masked)) in enumerate(
            (dt, c) for dt in (torch.bfloat16, torch.float32) for c in sq_sk):
        name = str(dtype).removeprefix("torch.")
        bwd_tol = FLASH_TOL[name][1]
        gen = torch.Generator().manual_seed(300 + i % len(sq_sk))
        q, k, v, do = (torch.randn(3, n, 2, 64, generator=gen).to(
            dev, dtype) for n in (sq, sk, sk, sq))
        lengths = (torch.tensor([1, sk // 2, sk], dtype=torch.int32,
                                device=dev) if masked else None)
        if masked:
            out, lse = masked_flash_attention_forward(q, k, v, lengths)
            delta = fa.attention_delta(out, do)
            grads = masked_flash_attention_backward(q, k, v, lengths, do, lse,
                                                    delta)
        else:
            out, lse = fa.flash_attention_forward_reference(q, k, v)
            delta = fa.attention_delta(out, do)
            grads = (fa.launch_dq(q, k, v, do, lse, delta),
                     *fa.launch_dkv(q, k, v, do, lse, delta))
        want = fa.flash_attention_backward_reference(q, k, v, do, lse, delta,
                                                     lengths)
        torch.cuda.synchronize()
        errs = grad_errs(grads, want)
        print(json.dumps({"phase": "flash_parity", "case": f"{name} backward,"
                          " Sq != Sk", "sq": sq, "sk": sk, "masked": masked,
                          "bwd_route": bwd_route(torch, dtype),
                          "grad_max_abs_err": max(e[0] for e in errs),
                          "grad_max_rel_err": max(e[1] for e in errs),
                          "tol": bwd_tol}), flush=True)
        if max(e[1] for e in errs) > bwd_tol:
            fail(f"{name} flash backward Sq={sq} Sk={sk} masked={masked}: "
                 f"{errs}")
        worst["flash_attention_backward"] = max(
            worst["flash_attention_backward"], *(e[0] for e in errs))

    # no atomics: both routes' backward bits at ViT's shape, twice and under
    # another stream, unmasked (strided views) and masked (lengths 2..65)
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).removeprefix("torch.")
        q, k, v = _fused_qkv(torch, VIT_B, VIT_S, VIT_H, VIT_D, dtype, dev,
                             seed=90)
        do = torch.randn(VIT_B, VIT_S, VIT_H, VIT_D, generator=torch
                         .Generator().manual_seed(91)).to(dev, dtype)
        out, lse = fa.flash_attention_forward(q, k, v)
        delta = fa.attention_delta(out, do)
        qc, kc, vc = (t.contiguous() for t in (q, k, v))
        lengths = torch.arange(2, VIT_B + 2, dtype=torch.int32, device=dev)
        m_out, m_lse = masked_flash_attention_forward(qc, kc, vc, lengths)
        m_delta = fa.attention_delta(m_out, do)
        runs = {
            "unmasked": lambda: (
                fa.flash_attention_dq(q, k, v, do, lse, delta),
                *fa.flash_attention_dkv(q, k, v, do, lse, delta)),
            "masked": lambda: masked_flash_attention_backward(
                qc, kc, vc, lengths, do, m_lse, m_delta)}
        for label, run in runs.items():
            first, again = run(), run()
            stream = torch.cuda.Stream()
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                other = run()
            torch.cuda.current_stream().wait_stream(stream)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b2) and torch.equal(a, c)
                       for a, b2, c in zip(first, again, other))
            print(json.dumps({"phase": "flash_parity", "case": f"{name} "
                              "backward, bitwise repeat", "input": label,
                              "bwd_route": bwd_route(torch, dtype),
                              "same_bits_twice_and_on_another_stream": same}),
                  flush=True)
            if not same:
                fail(f"{name} flash backward ({label}): dq/dk/dv bits differ "
                     "between repeats or streams")
    flash_split_share(torch, dev)

    # flash_attention_lse's autograd Function: both cotangents
    q, k, v = (t.detach().requires_grad_() for t in _fused_qkv(
        torch, 7, VIT_S, VIT_H, VIT_D, torch.float32, dev, seed=60))
    out, lse = fa.flash_attention_lse(q, k, v)
    gen = torch.Generator().manual_seed(61)
    w_out = torch.randn(out.shape, generator=gen).to(dev)
    w_lse = torch.randn(lse.shape, generator=gen).to(dev)
    got = torch.autograd.grad((out * w_out).sum() + (lse * w_lse).sum(),
                              (q, k, v))
    with torch.no_grad():
        r_out, r_lse = fa.flash_attention_forward_reference(q, k, v)
        want = fa.flash_attention_backward_reference(
            q, k, v, w_out, r_lse, fa.attention_delta(r_out, w_out, w_lse))
    torch.cuda.synchronize()
    errs = [rel_err(a, w) for a, w in zip(got, want)]
    print(json.dumps({"phase": "flash_parity", "case": "flash_attention_lse "
                      "autograd, nonzero dlse", "b": 7, "dtype": "float32",
                      "bwd_route": "fma",
                      "grad_max_abs_err": max(e[0] for e in errs),
                      "grad_max_rel_err": max(e[1] for e in errs),
                      "lse_max_rel_err": rel_err(lse, r_lse)[1]}), flush=True)
    if max(e[1] for e in errs) > FLASH_TOL["float32"][1]:
        fail(f"flash_attention_lse backward with dlse: {errs}")

    # the masked backward in both routes: lengths 1 .. 65, one per row
    b = VIT_S
    lens = np.arange(1, b + 1, dtype=np.int32)
    lengths = torch.from_numpy(lens).to(dev)
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).removeprefix("torch.")
        q, k, v = (t.contiguous() for t in _fused_qkv(
            torch, b, VIT_S, VIT_H, VIT_D, dtype, dev, seed=70))
        do = torch.randn(b, VIT_S, VIT_H, VIT_D, generator=torch.Generator()
                         .manual_seed(71)).to(dev, dtype)
        dq, dk, dv, dq_vis, dkv_vis = masked_flash_attention_backward_probe(
            q, k, v, lengths, do)
        out, lse = masked_flash_attention_forward(q, k, v, lengths)
        want = fa.flash_attention_backward_reference(
            q, k, v, do, lse, fa.attention_delta(out, do), lengths)
        torch.cuda.synchronize()
        zeros_ok = all(int(torch.count_nonzero(g[r, n:])) == 0
                       for g in (dk, dv) for r, n in enumerate(lens))
        vis_ok = (torch.equal(dq_vis.cpu(), torch.from_numpy(
            -(-lens // fa.TILE)).float()[:, None, None].expand(
                b, VIT_H, VIT_S))
            and torch.equal(dkv_vis.cpu(), torch.from_numpy(
                -(-lens // fa.KEY_BLOCK)).float()[:, None].expand(b, VIT_H)))
        errs = [rel_err(a, w) for a, w in zip((dq, dk, dv), want)]
        print(json.dumps({"phase": "flash_parity", "case": "masked backward, "
                          "lengths 1..65", "b": b, "dtype": name,
                          "bwd_route": bwd_route(torch, dtype),
                          "grad_max_abs_err": max(e[0] for e in errs),
                          "grad_max_rel_err": max(e[1] for e in errs),
                          "zeros_past_length": zeros_ok, "visits_ok": vis_ok}),
              flush=True)
        if not (zeros_ok and vis_ok) or max(e[1] for e in errs) > \
                FLASH_TOL[name][1]:
            fail(f"{name} masked backward: zeros {zeros_ok}, visits "
                 f"{vis_ok}, {errs}")
        worst["masked_flash_attention_backward"] = max(
            worst["masked_flash_attention_backward"], *(e[0] for e in errs))
    return worst


def vit_state(torch, dev, dataset, attention_impl: str, **remat):
    """`vit_tiny_cifar_flash`'s model (with `attention_impl`), optimizer,
    initial state (seed 0) and fused step at the per-chip batch; `remat`
    (remat, remat_policy) overrides the config's. Returns (state, step,
    model, step keywords)."""
    from dist_mnist_tpu_torch import bench, optim
    from dist_mnist_tpu_torch.configs import get_config
    from dist_mnist_tpu_torch.data.pipeline import DeviceDataset
    from dist_mnist_tpu_torch.models.registry import get_model
    from dist_mnist_tpu_torch.train import (
        create_train_state,
        make_fused_train_step,
    )

    cfg = get_config("vit_tiny_cifar_flash")
    model = get_model(cfg.model, **{**cfg.model_kwargs,
                                    "attention_impl": attention_impl})
    opt = optim.build_optimizer(cfg)
    state = create_train_state(model, opt, 0, dataset.train_images[:1], dev)
    batch, _ = bench.ladder_batch(cfg, 1)
    step_kw = {"remat": cfg.remat, "remat_policy": cfg.remat_policy,
               "augment": cfg.augment, **remat}
    step = make_fused_train_step(model, opt, DeviceDataset(dataset, dev),
                                 batch, **step_kw)
    return state, step, model, step_kw


VIT_PLAIN_STEPS = 20
#: |loss, kernels - plain attention| at every step: the plain "xla" path
#: rounds its logits to bf16 (the scores einsum in q's dtype) where the
#: kernel keeps them in f32, so the bf16 model's two trajectories part by
#: bf16 rounding. On an H100 SXM (700 W) the largest per-step gap read
#: 2.7e-3, with losses falling from ~2.3 to 1.04 over the 20 steps.
VIT_PLAIN_TOL = 1e-2
#: relative L2 error of the first step's gradients, kernels against the
#: plain attention (`grad_errors`). On an H100 SXM (700 W) the worst leaf
#: read 2.1e-2 (qkv's q bias; bf16 rounding of the plain path's logits);
#: the same run with dK written as zero read 1.0 on qkv's k weight while
#: its losses stayed within 4.8e-3 of the plain ones at every step.
VIT_GRAD_TOL = 5e-2


def vit_first_grads(torch, dev, dataset, impl: str) -> dict:
    """{leaf name: gradient} of the first training step of
    `vit_tiny_cifar_flash` (seed-0 state, its generator's batch, crops and
    dropout masks, remat as configured) with `attention_impl=impl`."""
    from dist_mnist_tpu_torch.data.pipeline import DeviceDataset
    from dist_mnist_tpu_torch.ops import losses
    from dist_mnist_tpu_torch.train.step import loss_and_grads
    from dist_mnist_tpu_torch.utils.tree import flatten_with_path

    state, _, model, step_kw = vit_state(torch, dev, dataset, impl)
    batch = DeviceDataset(dataset, dev).sample(state.rng, VIT_B)
    grads = loss_and_grads(model, losses.softmax_cross_entropy, state.params,
                           state.model_state, batch, rng=state.rng,
                           **step_kw)[3]
    return {"/".join(map(str, path)): g.float()
            for path, g in flatten_with_path(grads)}


def grad_errors(got: dict, want: dict) -> dict:
    """Relative L2 error of each gradient leaf, the fused qkv projection's
    split into its q, k and v parts (each part's gradient comes from one
    of the attention backward's dq, dk, dv). The k part of the qkv bias's
    gradient is 0 in exact arithmetic (a bias on every key shifts a row's
    logits by one constant, which the softmax ignores), so its error is
    taken relative to the whole bias's gradient."""
    out = {}
    for name, w in want.items():
        g = got[name]
        if "qkv" not in name.split("/"):
            out[name] = float((g - w).norm() / w.norm())
            continue
        for part, gp, wp in zip("qkv", g.chunk(3, dim=-1),
                                w.chunk(3, dim=-1)):
            ref = w if part == "k" and name.endswith("/b") else wp
            out[f"{name}[{part}]"] = float((gp - wp).norm() / ref.norm())
    return out


def vit_kernel_vs_plain(torch, dev, dataset) -> dict:
    """The flash kernels against the plain `"xla"` attention in
    `vit_tiny_cifar_flash` training, from one initial state and generator
    seed (the same batches, crops and dropout masks): the first step's
    gradients, every leaf (qkv's q, k, v parts apart) within
    `VIT_GRAD_TOL` relative L2 error, and `VIT_PLAIN_STEPS` steps whose
    losses stay within `VIT_PLAIN_TOL` of each other at every step."""
    grad_err = grad_errors(vit_first_grads(torch, dev, dataset, "flash"),
                           vit_first_grads(torch, dev, dataset, "xla"))
    worst_leaf = max(grad_err, key=grad_err.get)
    losses = {}
    for impl in ("flash", "xla"):
        state, step, _, _ = vit_state(torch, dev, dataset, impl)
        seq = []
        for _ in range(VIT_PLAIN_STEPS):
            state, out = step(state)
            seq.append(out["loss"])
        losses[impl] = torch.stack(seq).cpu().numpy()
    step_gap = float(np.max(np.abs(losses["flash"] - losses["xla"])))
    out = {"phase": "vit_kernel_vs_plain", "steps": VIT_PLAIN_STEPS,
           "first_loss": float(losses["xla"][0]),
           "final_loss_kernel": float(losses["flash"][-1]),
           "final_loss_plain": float(losses["xla"][-1]),
           "final_loss_gap": abs(float(losses["flash"][-1]
                                       - losses["xla"][-1])),
           "max_step_loss_gap": step_gap, "tol": VIT_PLAIN_TOL,
           "grad_rel_l2_worst": grad_err[worst_leaf],
           "grad_rel_l2_worst_leaf": worst_leaf,
           "grad_rel_l2_qkv": {n: e for n, e in grad_err.items()
                               if "qkv" in n},
           "grad_tol": VIT_GRAD_TOL}
    print(json.dumps(out), flush=True)
    if not np.isfinite(losses["flash"]).all() or step_gap > VIT_PLAIN_TOL:
        fail(f"vit_kernel_vs_plain: losses {losses['flash'].tolist()} vs "
             f"plain {losses['xla'].tolist()}")
    if not grad_err[worst_leaf] <= VIT_GRAD_TOL:
        fail(f"vit_kernel_vs_plain: first-step gradient of {worst_leaf} "
             f"{grad_err[worst_leaf]} from the plain attention's")
    return out


def vit_profile(torch, dev, dataset) -> dict:
    """Where one `vit_tiny_cifar_flash` training step (batch 64, remat,
    augment) spends its time: the host wall per step (ends in a
    synchronize) and the device time by kernel from `torch.profiler`, the
    device operations per step and the idle share; and the host wall of
    the same step without remat and under the `nothing` policy, which
    shows what the selective checkpoint's dispatch mode costs the host."""
    reps = 10

    def wall(state, step):
        for _ in range(5):  # allocator and cuBLAS warm-up
            state, _ = step(state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            state, _ = step(state)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps, state

    other = {label: wall(*vit_state(torch, dev, dataset, "flash",
                                    **kw)[:2])[0]
             for label, kw in (("no_remat", {"remat": False}),
                               ("remat_nothing",
                                {"remat_policy": "nothing"}))}
    state, step = vit_state(torch, dev, dataset, "flash")[:2]
    wall_ms, state = wall(state, step)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            state, _ = step(state)
        torch.cuda.synchronize()
    out = {"phase": "vit_profile", "batch": VIT_B,
           "remat_policy": "dots_no_batch",
           "wall_ms_by_remat": {"dots_no_batch": wall_ms, **other},
           **profile_fields(torch, prof, reps, wall_ms)}
    print(json.dumps(out), flush=True)
    return out


#: the zoo's height-16 bucket of ViT-Tiny (`serve/zoo.py default_seq_grid` of
#: 32 x 32 images, patch 4): 4 patch rows of 8 tokens, and the real heights
#: its rows hold (a height above 8 and at most 16 takes this bucket)
VIT_MASK_HEIGHT, VIT_MASK_REAL = 16, (9, 16)
#: the bucket's attention length: 32 patch tokens and CLS
VIT_MASK_S = VIT_MASK_HEIGHT // 4 * 32 // 4 + 1
#: |logits with the kernels - logits with the plain "xla" attention|,
#: relative to the largest plain logit, and the least share of rows whose
#: top-1 must agree
VIT_MASK_TOL, VIT_MASK_TOP1 = 2e-2, 0.98


def vit_bucket_rows(rng) -> tuple[np.ndarray, np.ndarray]:
    """`VIT_B` real heights of the height-16 bucket's rows drawn from `rng`,
    and each row's real patch tokens (`SeqGrid.n_tokens` of 32 x 32 images
    in patches of 4): 24 or 32, so 25 or 33 keys with CLS."""
    heights = rng.integers(VIT_MASK_REAL[0], VIT_MASK_REAL[1] + 1, size=VIT_B)
    return heights, -(-heights // 4) * (32 // 4)


def vit_masked_forward(torch, dev, reset_counts, read_counts) -> dict:
    """ViT-Tiny at `vit_tiny_cifar_flash`'s full width (dim 192, depth 12,
    3 heads of 64, patch 4, bf16 activations; weights from seed 0) serving
    a sub-native bucket as the zoo does: 64 images 16 rows high (32 patch
    tokens and CLS, S = 33), each row's real height drawn from 9..16 (seed
    0) with the rows below it zero, and the token mask `SeqGrid.mask`
    builds for it (33 or 25 real tokens with CLS). One eval forward
    through `ViTTiny.apply(..., mask=)`, with every launch counter set to
    0 just before and read just after: the masked forward launched once a
    layer (12) and no other kernel; logits finite, within `VIT_MASK_TOL` of
    the largest logit of the same forward with `attention_impl="xla"`, and
    the same top-1 on at least `VIT_MASK_TOP1` of the rows. Then the
    forward's host wall (ends in a synchronize) and its device time by
    kernel from `torch.profiler`."""
    from dist_mnist_tpu_torch.configs import get_config
    from dist_mnist_tpu_torch.models.registry import get_model
    from dist_mnist_tpu_torch.utils.tree import tree_map

    cfg = get_config("vit_tiny_cifar_flash")
    model = get_model(cfg.model, **cfg.model_kwargs)
    plain = get_model(cfg.model, **{**cfg.model_kwargs,
                                    "attention_impl": "xla"})
    params, state = model.init(torch.Generator().manual_seed(0),
                               torch.zeros(1, 32, 32, 3))
    params = tree_map(lambda t: t.to(dev), params)
    if model.patch != 4:
        fail(f"vit_masked_forward: patch {model.patch}, the bucket's is 4")
    rng = np.random.default_rng(0)
    heights, tokens = vit_bucket_rows(rng)
    images = rng.random((VIT_B, VIT_MASK_HEIGHT, 32, 3), dtype=np.float32)
    for row, h in enumerate(heights):
        images[row, h:] = 0.0  # the bucket's padding rows
    mask = np.arange(VIT_MASK_S - 1)[None, :] < tokens[:, None]
    x = torch.from_numpy(images).to(dev)
    m = torch.from_numpy(mask).to(dev)

    def forward(mdl):
        with torch.no_grad():
            return mdl.apply(params, state, x, train=False, mask=m)[0]

    reset_counts()
    logits = forward(model)
    torch.cuda.synchronize()
    counts = read_counts()
    want = forward(plain)
    torch.cuda.synchronize()
    got_np, want_np = logits.cpu().numpy(), want.cpu().numpy()
    diff = float(np.max(np.abs(got_np - want_np)))
    largest = float(np.max(np.abs(want_np)))
    agree = float(np.mean(got_np.argmax(-1) == want_np.argmax(-1)))
    reps = 20
    for _ in range(5):  # allocator and cuBLAS warm-up
        forward(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        forward(model)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            forward(model)
        torch.cuda.synchronize()
    depth = model.depth
    out = {"phase": "vit_masked_forward", "batch": VIT_B,
           "bucket_height": VIT_MASK_HEIGHT, "seq": int(mask.shape[1]) + 1,
           "lengths": sorted({int(n) + 1 for n in tokens}),
           "launches": counts, "launches_per_layer":
           counts["masked_flash_attention"] / depth,
           "shape": list(got_np.shape), "max_abs_diff_vs_xla": diff,
           "max_abs_logit_xla": largest, "tol": VIT_MASK_TOL * largest,
           "top1_agreement": agree,
           **profile_fields(torch, prof, reps, wall_ms)}
    print(json.dumps(out), flush=True)
    others = {k: v for k, v in counts.items()
              if k != "masked_flash_attention" and v}
    if counts["masked_flash_attention"] != depth or others:
        fail(f"vit_masked_forward: launches {counts} (want "
             f"{depth} masked_flash_attention, no other kernel)")
    if got_np.shape != (VIT_B, 10) or not np.isfinite(got_np).all():
        fail(f"vit_masked_forward: logits {got_np.shape} or non-finite")
    if diff > VIT_MASK_TOL * largest or agree < VIT_MASK_TOP1:
        fail(f"vit_masked_forward: logits {diff} from the plain attention's "
             f"(largest {largest}), top-1 agreement {agree}")
    return out


#: the serving benches' traffic: the reference's defaults
SERVE_REQUESTS, SERVE_CONCURRENCY = 512, 64


def serve_benches(torch, dev, reset_counts, read_counts) -> dict:
    """The port's classifier serving benches at the reference's defaults
    (512 requests, concurrency 64), each through the bench's entry point
    (`bench.main(["--serve", ...])`, which prints their JSON lines) with
    every launch counter set to 0 just before and read just after:
    `bench.run_serve` (`mlp_mnist` float: no kernel),
    `bench.run_serve_quant` (float and int8 `mlp_mnist`: exactly 2 f32
    `quant_matmul` launches per batch the int8 engine ran, prewarm
    included, none for the float engine, no other kernel) and
    `bench.run_serve_longctx` (`vit_tiny_cifar`, "xla" attention: no
    kernel). Their hard gates (every request ok, no first run after
    prewarm, int8 bytes <= 0.30x float, top-1 agreement >= 0.99) raise
    inside; the int8 p99 ordering is a field. Fails on any miss; returns
    the launch counts per bench."""
    from dist_mnist_tpu_torch import bench
    from dist_mnist_tpu_torch.ops.kernels.quant_matmul import quant_matmul

    out = {}
    for name, flags in (("serve", []), ("serve_quant", ["--quant"]),
                        ("serve_longctx", ["--longctx"])):
        reset_counts()
        quant_matmul.f32_launches = 0
        try:  # the bench's entry point prints the records' JSON lines
            records = bench.main(["--serve", *flags, f"--device={dev}",
                                  f"--requests={SERVE_REQUESTS}",
                                  f"--concurrency={SERVE_CONCURRENCY}"])
        except SystemExit:  # a hard gate failed: its error line is above
            fail(f"serve_benches {name}: a hard gate failed")
        torch.cuda.synchronize()
        counts = read_counts()
        want = {}
        if name == "serve_quant":
            batches = records[1]["extra"]["batches_run"]
            want["quant_matmul"] = 2 * batches["int8"]
            if batches["int8"] == 0 or \
                    quant_matmul.f32_launches != counts["quant_matmul"]:
                fail(f"serve_benches {name}: {batches} batches, "
                     f"{quant_matmul.f32_launches} of "
                     f"{counts['quant_matmul']} quant_matmul launches f32")
        out[name] = counts
        print(json.dumps({"phase": "serve_benches", "bench": name,
                          "launches": counts, "want": want,
                          **{r["metric"]: r["value"] for r in records}}),
              flush=True)
        if {k: v for k, v in counts.items() if v} != want:
            fail(f"serve_benches {name}: launches {counts} (want {want}, "
                 "no other kernel)")
    return out


#: `zoo_flash_serve`'s check of fixed batches against the "xla" engine:
#: the largest logit difference relative to each batch's largest "xla"
#: logit, and the least top-1 agreement over the rows the comparison can
#: decide, those whose two highest "xla" logits lie more than that limit
#: apart (closer rows may flip within it). The same logit limit holds the
#: flash engine against itself with the kernels swapped for their plain
#: versions (read 0.0096 to 0.0208 on sound runs). The kernels' own limits
#: at these cells' shapes and lengths are `masked_zoo_path_parity`'s. vit_masked_forward's 2e-2 over
#: every row (top-1 0.98) sits at this path's own bf16 noise: at the zoo
#: config's seeded weights (largest logit ~2) the same engine with the
#: kernels swapped for their plain versions is up to 0.0235 of the
#: largest logit from "xla" and 0.0208 from the kernels, and 3 to 4 of 160
#: rows flip at near ties (H100 80GB HBM3 at 700 W; PERF.md §6)
ZOO_LOGIT_TOL, ZOO_TOP1 = 4e-2, 0.98


def zoo_fixed_batches(grid, seed: int = 12) -> list:
    """One fixed batch of 32 images per seq bucket of the zoo `grid`, their
    real heights drawn within the bucket (row 0 at the bucket's full
    height, the rows past each real height zeroed), and one batch of full
    height for the dense native cell: ``[(name, images, heights)]``."""
    rng = np.random.default_rng(seed)
    batches, low = [], 0
    for h in (*grid.heights, None):
        b_h = grid.native_height if h is None else h
        real = (np.full(32, b_h) if h is None
                else rng.integers(low + 1, h + 1, size=32))
        real[0] = b_h  # every bucket holds its full height too
        images = rng.integers(0, 256, size=(32, b_h, grid.width,
                                            grid.channels), dtype=np.uint8)
        for row, r in enumerate(real):
            images[row, r:] = 0  # the rows past each real height
        batches.append(("dense" if h is None else f"masked {b_h}", images,
                        real))
        low = b_h if h is not None else low
    return batches


@contextlib.contextmanager
def plain_attention():
    """The ViT's flash and masked flash forward calls swapped for their
    plain versions while the block runs."""
    from dist_mnist_tpu_torch.ops.kernels import flash_attention as fa
    from dist_mnist_tpu_torch.ops.kernels import masked_flash as mf
    from dist_mnist_tpu_torch.parallel import flash as pflash

    kernels = (pflash.flash_attention, pflash.masked_flash_attention)
    pflash.flash_attention = (lambda q, k, v, block_k=None:
                              fa.flash_attention_forward_reference(
                                  q, k, v, block_k)[0])
    pflash.masked_flash_attention = mf.masked_flash_attention_reference
    try:
        yield
    finally:
        pflash.flash_attention, pflash.masked_flash_attention = kernels


def rel_logit_diffs(a, b) -> list[float]:
    """Per batch, the largest |a - b| over the largest |b|."""
    return [float(np.max(np.abs(x - y))) / float(np.max(np.abs(y)))
            for x, y in zip(a, b)]


def zoo_flash_serve(torch, dev, reset_counts, read_counts) -> dict:
    """`bench.run_serve_longctx` through `vit_tiny_cifar_flash` (bf16, full
    width: dim 192, depth 12, 3 heads; seeded fresh init) at the
    reference's defaults, every launch counter set to 0 just before and
    read just after: 12 launches of the masked forward per batch the
    engine ran in a masked cell and 12 of the unmasked flash forward per
    batch in the dense native cell (the engine's per-cell run counts,
    prewarm included), no other kernel, no first run after prewarm. Then,
    per seq bucket, one fixed batch of 32 images whose real heights fall
    in the bucket (and one of full height, the dense cell) through the
    same grid with the "xla" attention (`vit_tiny_cifar`: the same seeded
    weights): logits within `ZOO_LOGIT_TOL` of the largest logit, the same
    top-1 on `ZOO_TOP1` of the rows that limit decides (at least half of
    them). Also the same flash engine with the kernels swapped for their
    plain versions: the kernels' logits within `ZOO_LOGIT_TOL` of its
    largest logit, and its distance from "xla" printed beside (this
    comparison's noise floor). Fails on any miss; returns the phase's
    record."""
    from dist_mnist_tpu_torch import bench
    from dist_mnist_tpu_torch.serve import build_zoo_engine, load_for_serving
    from dist_mnist_tpu_torch.utils.tree import leaves

    reset_counts()
    try:
        record = bench.run_serve_longctx(dev, SERVE_REQUESTS,
                                         SERVE_CONCURRENCY,
                                         config="vit_tiny_cifar_flash")
    except bench.ServeGateError as err:
        fail(f"zoo_flash_serve: {err}")
    torch.cuda.synchronize()
    counts = read_counts()
    print(json.dumps(record), flush=True)
    extra = record["extra"]
    cells = extra["cache"]["per_cell"]
    masked_runs = sum(n for c, n in cells.items() if c.endswith("/masked"))
    dense_runs = sum(n for c, n in cells.items() if c.endswith("/dense"))
    depth = 12
    want = {"masked_flash_attention": depth * masked_runs,
            "flash_attention_forward": depth * dense_runs}
    out = {"phase": "zoo_flash_serve", "launches": counts, "want": want,
           "masked_batches": masked_runs, "dense_batches": dense_runs,
           "seq_bucket_counts": extra["seq_bucket_counts"],
           "longctx_p99_ms": record["value"],
           "recompiles_during_traffic": extra["recompiles_during_traffic"]}
    if {k: v for k, v in counts.items() if v} != want or not masked_runs \
            or not dense_runs:
        print(json.dumps(out), flush=True)
        fail(f"zoo_flash_serve: launches {counts} (want {want}, no other "
             "kernel)")

    engines = {}
    for name in ("vit_tiny_cifar_flash", "vit_tiny_cifar"):
        bundle = load_for_serving(name, dev)
        engines[name] = build_zoo_engine(bundle, dev, model_name=name,
                                         max_bucket=32, seq_buckets="auto")
    flash, plain = engines["vit_tiny_cifar_flash"], engines["vit_tiny_cifar"]
    if not all(torch.equal(x, y) for x, y in zip(leaves(flash.params),
                                                  leaves(plain.params))):
        fail("zoo_flash_serve: the flash and xla configs' seeded weights "
             "differ")
    batches = zoo_fixed_batches(flash.seq_grid)
    got = [flash.predict(x, heights=r) for _, x, r in batches]
    ref = [plain.predict(x, heights=r) for _, x, r in batches]
    # the same flash engine with the kernels swapped for their plain
    # versions: the noise floor of this bf16 comparison, reported beside it
    with plain_attention():
        swapped = [flash.predict(x, heights=r) for _, x, r in batches]
    rel = rel_logit_diffs

    if any(g.shape != (32, 10) or not np.isfinite(g).all() for g in got):
        fail("zoo_flash_serve: logits of a fixed batch not [32, 10] or "
             "non-finite")
    ref_all, got_all = np.concatenate(ref), np.concatenate(got)
    top2 = np.sort(ref_all, axis=-1)[:, -2:]
    margin = np.concatenate([np.full(len(y), ZOO_LOGIT_TOL * np.abs(y).max())
                             for y in ref])
    decided = top2[:, 1] - top2[:, 0] > margin
    same = got_all.argmax(-1) == ref_all.argmax(-1)
    agree = float(np.mean(same[decided])) if decided.any() else 0.0
    diffs, vs_plain = rel(got, ref), rel(got, swapped)
    out.update(fixed_batches=[name for name, _, _ in batches],
               max_rel_logit_diff=max(diffs),
               rel_logit_diff_per_batch=diffs,
               plain_vs_xla_rel_logit_diff=rel(swapped, ref),
               kernels_vs_plain_rel_logit_diff=vs_plain,
               top1_agreement=agree, rows_decided=int(decided.sum()),
               top1_agreement_all_rows=float(np.mean(same)),
               top1_agreement_plain_vs_xla_all_rows=float(np.mean(
                   np.concatenate(swapped).argmax(-1)
                   == ref_all.argmax(-1))),
               tol=ZOO_LOGIT_TOL, top1_min=ZOO_TOP1)
    print(json.dumps(out), flush=True)
    if max(diffs) > ZOO_LOGIT_TOL or max(vs_plain) > ZOO_LOGIT_TOL \
            or agree < ZOO_TOP1 or 2 * decided.sum() < len(decided):
        fail(f"zoo_flash_serve: logits {diffs} of the largest from the xla "
             f"engine's and {vs_plain} from the plain versions' (limit "
             f"{ZOO_LOGIT_TOL}), top-1 {agree} over the "
             f"{int(decided.sum())} of {len(decided)} rows it decides")
    return out


#: the train_cli phase's LeNet-5 runs: steps, checkpoint cadence, the
#: resumed run's end, and the step at which the recovery run is preempted
CLI_STEPS, CLI_EVERY, CLI_RESUME_TO, CLI_PREEMPT_AT = 1000, 250, 1200, 600
#: the ViT-Tiny run through the CLI: steps, eval and checkpoint cadence
CLI_VIT_STEPS, CLI_VIT_EVERY = 30, 15
CLI_VIT_EVAL_BATCHES = 10  # 10,000 test images in batches of 1,000
#: record names the reference's CLI writes that the port's must too
CLI_CSV_TAGS = ("steps_per_sec", "loss", "accuracy", "test/loss",
                "test/accuracy", "step_time/p50_ms", "goodput/productive_s",
                "input/feed_stall_ms_per_step", "input/h2d_mbytes_per_step",
                "memory/param_bytes_per_device", "memory/bytes_in_use")
CLI_EVENTS = ("run_start", "first_step", "checkpoint_save",
              "checkpoint_commit", "checkpoint_restore", "span", "run_stop")


class _PreemptOnce:
    """A hook that raises PreemptionError once, after step `at`."""

    def __init__(self, error, at: int):
        self.error, self.at, self.fired = error, at, False

    def begin(self, loop):
        pass

    def before_step(self, step):
        pass

    def after_step(self, step, state, outputs):
        if step == self.at and not self.fired:
            self.fired = True
            raise self.error(f"injected at step {step}")

    def end(self, state):
        pass


def served_checkpoint_varlen(torch, dev, checkpoint_dir, reset_counts,
                             read_counts) -> dict:
    """The `vit_tiny_cifar_flash` checkpoint in `checkpoint_dir`, restored
    by `load_for_serving`, behind the zoo grid (auto heights, max batch
    `bench.LONGCTX_MAX_BATCH`, every cell prewarmed) under
    `run_longctx_loadgen`'s mixed-height traffic (`SERVE_REQUESTS` at
    `SERVE_CONCURRENCY`), the launch counters set to 0 after prewarm and
    read after the traffic: every request ok, no first run of a cell, at
    least one masked batch, and 12 masked-forward launches per masked
    batch and 12 forward launches per dense batch of the traffic, no
    other kernel. Then `zoo_fixed_batches` through the engine, on the
    kernels and on their plain versions: finite [32, 10] logits within
    `ZOO_LOGIT_TOL` of the plain versions' largest logit. Fails on any
    miss; returns the record."""
    from dist_mnist_tpu_torch import bench
    from dist_mnist_tpu_torch.configs import get_config
    from dist_mnist_tpu_torch.serve import (
        InferenceServer,
        ServeConfig,
        build_zoo_engine,
        load_for_serving,
        run_longctx_loadgen,
    )

    cfg = get_config("vit_tiny_cifar_flash")
    bundle = load_for_serving(cfg, dev, checkpoint_dir=checkpoint_dir)
    engine = build_zoo_engine(bundle, dev, model_name=cfg.model,
                              max_bucket=bench.LONGCTX_MAX_BATCH,
                              seq_buckets="auto")

    def runs(kind):
        return sum(n for c, n in engine.cache_stats()["per_cell"].items()
                   if c.endswith("/" + kind))

    server = InferenceServer(engine, ServeConfig(
        max_batch=bench.LONGCTX_MAX_BATCH, max_wait_ms=2.0,
        queue_depth=4 * SERVE_CONCURRENCY))
    with server:
        masked0, dense0 = runs("masked"), runs("dense")
        reset_counts()
        summary = run_longctx_loadgen(server, n_requests=SERVE_REQUESTS,
                                      concurrency=SERVE_CONCURRENCY, seed=0)
        torch.cuda.synchronize()
        counts = read_counts()
    masked, dense = runs("masked") - masked0, runs("dense") - dense0
    depth = 12
    want = {k: v for k, v in (("masked_flash_attention", depth * masked),
                              ("flash_attention_forward", depth * dense))
            if v}
    batches = zoo_fixed_batches(engine.seq_grid)
    got = [engine.predict(x, heights=r) for _, x, r in batches]
    with plain_attention():
        plain = [engine.predict(x, heights=r) for _, x, r in batches]
    diffs = rel_logit_diffs(got, plain)
    out = {"checkpoint_step": bundle.step, "restored": bundle.restored,
           "ok": summary["ok"], "errors": summary["errors"],
           "p99_ms": summary["p99_ms"],
           "seq_bucket_counts": summary["seq_bucket_counts"],
           "recompiles_during_traffic":
               summary["recompiles_during_traffic"],
           "masked_batches": masked, "dense_batches": dense,
           "launches": counts, "want": want,
           "fixed_batches": [name for name, _, _ in batches],
           "kernels_vs_plain_rel_logit_diff": diffs, "tol": ZOO_LOGIT_TOL}
    print(json.dumps({"phase": "train_cli", "serve_varlen": out}),
          flush=True)
    if (not bundle.restored or bundle.step != CLI_VIT_STEPS
            or summary["ok"] != SERVE_REQUESTS or summary["errors"]
            or summary["recompiles_during_traffic"]):
        fail(f"train_cli: the checkpoint under mixed-height traffic {out}")
    if {k: v for k, v in counts.items() if v} != want or not masked:
        fail(f"train_cli: mixed-height traffic launches {counts} (want "
             f"{want}, at least one masked batch, no other kernel)")
    if any(g.shape != (32, 10) or not np.isfinite(g).all() for g in got) \
            or max(diffs) > ZOO_LOGIT_TOL:
        fail(f"train_cli: the trained weights' logits {diffs} of the "
             f"largest from the plain versions' (limit {ZOO_LOGIT_TOL})")
    return out


def train_cli(torch, dev, reset_counts, read_counts) -> dict:
    """The training CLI on the card (`cli.train.main` in-process), every
    launch counter set to 0 just before each command and read just after:
    LeNet-5 for `CLI_STEPS` steps (python pipeline, prefetch depth 2,
    checkpoints every `CLI_EVERY`): step reached, test accuracy >= 0.97,
    a commit marker at every cadence step, the reference's metric and
    journal record names, no kernel launched; the same run resumed to
    `CLI_RESUME_TO` (restored=True, from step `CLI_STEPS`); `run_config`
    with a hook that raises PreemptionError once at `CLI_PREEMPT_AT` and
    max_recoveries=1: restored, replayed, and its final params, optimizer
    slots and generator equal to the first run's bit for bit (cuDNN set
    deterministic for those two runs). Then `vit_tiny_cifar_flash` at full
    width and its own batch 1,024 for `CLI_VIT_STEPS` steps: 24 forward,
    12 dQ and 12 dK/dV launches a step plus 12 forward launches per eval
    batch and no other kernel, finite losses, checkpoints at every
    `CLI_VIT_EVERY`; and that checkpoint served by `cli.serve.main
    --seq_buckets=auto`: checkpoint_step, every request ok, the engine's
    params the checkpoint's bits, 12 masked-forward launches per masked
    batch and 12 forward launches per dense batch, no cell run for the
    first time after prewarm; then `served_checkpoint_varlen`. Fails on
    any miss; returns the record."""
    import logging
    import shutil
    import tempfile

    from dist_mnist_tpu_torch.cli import serve as serve_cli
    from dist_mnist_tpu_torch.cli import train as cli
    from dist_mnist_tpu_torch.configs import get_config
    from dist_mnist_tpu_torch.hooks import StepCounterHook
    from dist_mnist_tpu_torch.obs.events import read_journal
    from dist_mnist_tpu_torch.train.loop import PreemptionError
    from dist_mnist_tpu_torch.utils.tree import flatten_with_path

    work = Path(tempfile.mkdtemp(prefix="train_cli_"))
    d1, l1, d2, l2 = (str(work / n) for n in ("d1", "l1", "d2", "l2"))
    j3 = str(work / "j3.jsonl")
    out = {"phase": "train_cli"}
    records = []

    class _Capture(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    capture = _Capture(level=logging.INFO)
    logging.getLogger("dist_mnist_tpu_torch").addHandler(capture)

    def rate(ctx):
        return next(h.last_rate for h in ctx["loop"].hooks
                    if isinstance(h, StepCounterHook))

    def counted(fn, *a, **k):
        reset_counts()
        t0 = time.perf_counter()
        result = fn(*a, **k)
        torch.cuda.synchronize()
        return result, read_counts(), time.perf_counter() - t0

    def deterministic(fn, *a, **k):
        cudnn = torch.backends.cudnn
        prev = cudnn.deterministic, cudnn.benchmark
        cudnn.deterministic, cudnn.benchmark = True, False
        try:
            return counted(fn, *a, **k)
        finally:
            cudnn.deterministic, cudnn.benchmark = prev

    def run_record(ctx, wall, counts):
        return {"steps_per_sec": rate(ctx), "wall_s": wall,
                "goodput": ctx["loop"].goodput.snapshot(),
                "feed_wait_s": ctx["loop"].feed_wait_s,
                "h2d_bytes": (ctx["prefetch"] or {}).get("h2d_bytes"),
                "launches": counts}

    def leaf_diffs(a, b) -> dict:
        """Each leaf's largest |a - b| by path; fails unless the two trees
        hold the same paths, at least one."""
        fa_, fb_ = flatten_with_path(a), flatten_with_path(b)
        if not fa_ or [p for p, _ in fa_] != [p for p, _ in fb_]:
            fail(f"train_cli: trees of other paths: {len(fa_)} leaves "
                 f"against {len(fb_)}")
        return {"/".join(str(p) for p in path): (
            0.0 if torch.equal(x.cpu(), y.cpu()) else float(
                (x.double().cpu() - y.double().cpu()).abs().max()))
            for (path, x), (_, y) in zip(fa_, fb_)}

    def journal_ms(path, event, **match):
        return [r["dur_ms"] for r in read_journal(path)
                if r["event"] == event
                and all(r.get(k) == v for k, v in match.items())]

    try:
        lenet = ["--config=lenet5_mnist", "--device=cuda:0",
                 f"--checkpoint_dir={d1}", f"--checkpoint_every_steps="
                 f"{CLI_EVERY}", f"--logdir={l1}"]
        # 1. LeNet-5 through the CLI
        (s1, f1, c1), n1, w1 = deterministic(
            cli.main, lenet + [f"--train_steps={CLI_STEPS}"])
        out["lenet"] = {**run_record(c1, w1, n1), "step": s1.step_int,
                        "test_acc": f1["accuracy"],
                        "synthetic_data": c1["dataset"].synthetic}
        markers = sorted(int(p.name.split(".")[0])
                         for p in Path(d1, "commits").iterdir())
        tags = {row.split(",")[1] for row in
                Path(l1, "metrics.csv").read_text().splitlines()[1:]}
        names = {r["event"] for r in read_journal(Path(l1, "events.jsonl"))}
        print(json.dumps(out), flush=True)
        if s1.step_int != CLI_STEPS or f1["accuracy"] < 0.97:
            fail(f"train_cli: LeNet-5 ended at step {s1.step_int} with test "
                 f"accuracy {f1['accuracy']} (want {CLI_STEPS}, >= 0.97)")
        want_markers = list(range(0, CLI_STEPS + 1, CLI_EVERY))
        if markers != want_markers:
            fail(f"train_cli: commit markers {markers}, want {want_markers}")
        missing = (set(CLI_CSV_TAGS) - tags) | (
            set(CLI_EVENTS) - {"checkpoint_restore"} - names)
        if missing:
            fail(f"train_cli: record names missing from metrics.csv or "
                 f"events.jsonl: {sorted(missing)}")
        if any(n1.values()):
            fail(f"train_cli: LeNet-5 through the CLI launched kernels {n1}")
        # 2. resumed to CLI_RESUME_TO
        records.clear()
        (s2, _, c2), n2, w2 = counted(
            cli.main, lenet + [f"--train_steps={CLI_RESUME_TO}"])
        logged_restored = any("restored=True" in m for m in records)
        out["resume"] = {**run_record(c2, w2, n2), "step": s2.step_int,
                         "initial_step": c2["initial_step"],
                         "logged_restored": logged_restored,
                         "restore_ms": journal_ms(Path(l1, "events.jsonl"),
                                                  "checkpoint_restore")}
        if not (logged_restored and c2["initial_step"] == CLI_STEPS
                and s2.step_int == CLI_RESUME_TO) or any(n2.values()):
            fail(f"train_cli: resume {out['resume']}")
        # 3. preempted at CLI_PREEMPT_AT, recovered, equal to run 1
        hook = _PreemptOnce(PreemptionError, CLI_PREEMPT_AT)
        (s3, _, c3), n3, w3 = deterministic(
            cli.run_config, get_config("lenet5_mnist",
                                       train_steps=CLI_STEPS),
            device=dev, checkpoint_dir=str(work / "d3"),
            checkpoint_every_steps=CLI_EVERY, max_recoveries=1,
            prefetch_depth=2, extra_hooks=[hook], journal=j3)
        diffs = {}
        for tree in ("params", "opt_state"):
            diffs.update({f"{tree}/{k}": v for k, v in leaf_diffs(
                getattr(s3, tree), getattr(s1, tree)).items()})
        same_rng = torch.equal(s3.rng.get_state(), s1.rng.get_state())
        out["recovery"] = {
            **run_record(c3, w3, n3), "step": s3.step_int,
            "fired": hook.fired,
            "restore_ms": journal_ms(j3, "checkpoint_restore"),
            "bitwise_equal_to_run_1": same_rng and not any(diffs.values()),
            "rng_equal": same_rng,
            "largest_leaf_diff": max(diffs.items(), key=lambda kv: kv[1])}
        print(json.dumps({"phase": "train_cli", "recovery":
                          out["recovery"]}), flush=True)
        goodput3 = out["recovery"]["goodput"]
        if not (hook.fired and s3.step_int == CLI_STEPS
                and goodput3["recoveries"] == 1
                and goodput3["replayed_steps"] == CLI_PREEMPT_AT
                - CLI_PREEMPT_AT // CLI_EVERY * CLI_EVERY) or any(n3.values()):
            fail(f"train_cli: recovery {out['recovery']}")
        if not out["recovery"]["bitwise_equal_to_run_1"]:
            fail(f"train_cli: the recovered run differs from the "
                 f"uninterrupted one (rng equal: {same_rng}; largest leaf "
                 f"difference {out['recovery']['largest_leaf_diff']})")
        # 4. ViT-Tiny through the CLI at full width and batch 1,024
        (s4, f4, c4), n4, w4 = counted(cli.main, [
            "--config=vit_tiny_cifar_flash", "--device=cuda:0",
            f"--train_steps={CLI_VIT_STEPS}", f"--eval_every={CLI_VIT_STEPS}",
            "--log_every=10", f"--checkpoint_dir={d2}",
            f"--checkpoint_every_steps={CLI_VIT_EVERY}", f"--logdir={l2}"])
        depth = 12
        want = {"flash_attention_forward": CLI_VIT_STEPS * 2 * depth
                + CLI_VIT_EVAL_BATCHES * depth,
                "flash_attention_dq": CLI_VIT_STEPS * depth,
                "flash_attention_dkv": CLI_VIT_STEPS * depth}
        losses = [float(row.split(",")[2]) for row in
                  Path(l2, "metrics.csv").read_text().splitlines()[1:]
                  if row.split(",")[1] == "loss"]
        vit_markers = sorted(int(p.name.split(".")[0])
                             for p in Path(d2, "commits").iterdir())
        out["vit"] = {**run_record(c4, w4, n4), "step": s4.step_int,
                      "batch": get_config("vit_tiny_cifar_flash").batch_size,
                      "losses": losses,
                      "test_loss": f4["loss"], "test_acc": f4["accuracy"],
                      "want": want, "markers": vit_markers,
                      "save_dispatch_ms": journal_ms(
                          Path(l2, "events.jsonl"), "span",
                          name="checkpoint"),
                      "commit_ms": journal_ms(Path(l2, "events.jsonl"),
                                              "checkpoint_commit")}
        print(json.dumps({"phase": "train_cli", "vit": out["vit"]}),
              flush=True)
        if {k: v for k, v in n4.items() if v} != want:
            fail(f"train_cli: ViT-Tiny launches {n4} (want {want}, no other "
                 "kernel)")
        if (s4.step_int != CLI_VIT_STEPS or len(losses) != 3
                or not np.isfinite(losses + [f4["loss"]]).all()
                or vit_markers != [0, CLI_VIT_EVERY, CLI_VIT_STEPS]):
            fail(f"train_cli: ViT-Tiny step {s4.step_int}, losses {losses}, "
                 f"markers {vit_markers}")
        # 5. that checkpoint served, with the zoo's height buckets
        engines = []
        real_build = serve_cli.build_zoo_engine
        serve_cli.build_zoo_engine = (
            lambda *a, **k: engines.append(real_build(*a, **k))
            or engines[-1])
        try:
            summary, n5, w5 = counted(serve_cli.main, [
                "--config=vit_tiny_cifar_flash", "--device=cuda:0",
                f"--checkpoint_dir={d2}", "--seq_buckets=auto",
                "--requests=256", "--concurrency=64"])
        finally:
            serve_cli.build_zoo_engine = real_build
        engine = engines[0]
        saved = torch.load(Path(d2, str(CLI_VIT_STEPS), "state.pt"),
                           weights_only=True)["params"]
        same_params = not any(leaf_diffs(engine.params, saved).values())
        cells = engine.cache_stats()["per_cell"]
        masked_runs = sum(n for c, n in cells.items() if c.endswith("/masked"))
        dense_runs = sum(n for c, n in cells.items() if c.endswith("/dense"))
        grid_cells = len(engine.buckets()) * (
            1 + len(engine.seq_grid.heights))
        want5 = {"masked_flash_attention": depth * masked_runs,
                 "flash_attention_forward": depth * dense_runs}
        out["serve"] = {
            "checkpoint_step": summary["checkpoint_step"],
            "restored": summary["restored"], "ok": summary["ok"],
            "errors": summary["errors"], "p99_ms": summary["p99_ms"],
            "wall_s": w5, "params_equal_checkpoint": same_params,
            "masked_batches": masked_runs, "dense_batches": dense_runs,
            "cells": len(cells), "grid_cells": grid_cells,
            "misses": engine.misses, "launches": n5, "want": want5}
        print(json.dumps({"phase": "train_cli", "serve": out["serve"]}),
              flush=True)
        if (summary["checkpoint_step"] != CLI_VIT_STEPS
                or not summary["restored"] or summary["ok"] != 256
                or summary["errors"] or not same_params):
            fail(f"train_cli: serving the ViT checkpoint {out['serve']}")
        if {k: v for k, v in n5.items() if v} != want5 or not masked_runs \
                or not dense_runs:
            fail(f"train_cli: serving launches {n5} (want {want5})")
        if engine.misses != grid_cells:
            fail(f"train_cli: {engine.misses} cells ran for the first time, "
                 f"the prewarmed grid has {grid_cells}")
        # 6. the restored weights under the zoo's mixed-height traffic: the
        # CLI's loadgen sends native-height images (as the reference's
        # does), so above only prewarm ran the masked cells
        out["serve_varlen"] = served_checkpoint_varlen(
            torch, dev, d2, reset_counts, read_counts)
    finally:
        logging.getLogger("dist_mnist_tpu_torch").removeHandler(capture)
        shutil.rmtree(work, ignore_errors=True)
    summary_line = {"phase": "train_cli", **{
        k: {kk: vv for kk, vv in v.items() if kk not in ("losses",)}
        for k, v in out.items() if k != "phase"}}
    print(json.dumps(summary_line), flush=True)
    return out


#: the CUDA body each timed flash row runs
#: the data_parallel phase: steps of the two-rank runs through
#: `cli.launch` (two ranks on the one card), and the limit on the FSDP
#: run's losses against the DP run's (bf16 compute; the global-norm clip
#: sums the slices' squares in another order): 2% of the DP loss, plus
#: the 1e-4 the log's four decimals may round apart
DP_STEPS = 25
DP_VIT_STEPS = 10
DP_FSDP_LOSS_TOL = 0.02
LOG_RESOLUTION = 1e-4
#: LeNet-5's and ResNet-20's param counts: a DP step all-reduces them and
#: the two metrics in one f32 buffer; ResNet-20's 19 batch norms (688
#: channels in all) add four f32 all-reduces each, two sums forward and
#: their cotangents backward
LENET_PARAMS, RESNET_PARAMS = 1_663_370, 273_066
RESNET_BN_LAYERS, RESNET_BN_CHANNELS = 19, 688


def _rank_lines(output: str, rank: int, marker: str) -> list[str]:
    """The text after `marker` on each of rank `rank`'s lines with it."""
    tag = f"[p{rank}] "
    return [line.split(marker, 1)[1].strip()
            for line in output.splitlines()
            if line.startswith(tag) and marker in line]


def _launch_ranks(args: list[str], tag: str, timeout: float = 420.0,
                  n: int = 2, extra: tuple = ()) -> list:
    """`python -m dist_mnist_tpu_torch.cli.launch --num_processes=<n> --
    <args>` from the checkout; per rank: startup line, kernel launches,
    collectives per step, resident bytes, final digest, logged losses,
    steps/s between its first and last rate lines, and the text after
    each marker of `extra`. Fails on a nonzero exit or a missing line."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "dist_mnist_tpu_torch.cli.launch",
         f"--num_processes={n}", "--", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"launch_{tag}.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        fail(f"launch {tag}: exited {proc.returncode}:\n"
             + (proc.stdout + proc.stderr)[-4000:])
    ranks = []
    for r in range(n):
        try:
            ranks.append({
                "startup": _rank_lines(proc.stdout, r,
                                       "distributed init: ")[0],
                "launches": json.loads(_rank_lines(proc.stdout, r,
                                                   "kernel launches: ")[0]),
                "collectives_per_step": json.loads(_rank_lines(
                    proc.stdout, r, "collectives per step: ")[0]),
                "state_bytes": json.loads(_rank_lines(
                    proc.stdout, r, "resident state per rank: ")[0]),
                "digest": _rank_lines(proc.stdout, r,
                                      "final params digest: ")[0],
                "losses": {int(s.split(":")[0]): float(
                    s.split("loss=")[1].split(",")[0])
                    for s in _rank_lines(proc.stdout, r, "INFO: step ")
                    if "loss=" in s},
                "steps_per_sec": _log_rates(proc.stdout, r),
                "done": _rank_lines(proc.stdout, r, "done: ")[0],
                **{marker: _rank_lines(proc.stdout, r, marker)[0]
                   for marker in extra},
            })
        except (IndexError, ValueError) as err:
            fail(f"launch {tag}: rank {r}'s output lacks a line "
                 f"({err}):\n{proc.stdout[-4000:]}")
    ranks[0]["wall_s"] = wall
    return ranks


def data_parallel(torch, dev, reset_counts, read_counts) -> dict:
    """Phase `data_parallel`: ResNet-20 and LeNet-5 (Fashion-MNIST) through
    the bench's config mode on one rank, `resnet20_cifar_fsdp` there
    (benched as DP), then three two-rank runs through `cli.launch` on the
    one card: `lenet5_fashion` (DP), `resnet20_cifar_fsdp` against the
    same run under `--sharding=dp` (its checkpoint restored under DP
    here), `vit_tiny_cifar_flash` (DP, the flash kernels counted per
    rank). Returns the phase's record."""
    from dist_mnist_tpu_torch import bench, optim
    from dist_mnist_tpu_torch.checkpoint import CheckpointManager
    from dist_mnist_tpu_torch.configs import get_config
    from dist_mnist_tpu_torch.data.datasets import load_dataset
    from dist_mnist_tpu_torch.models.registry import get_model
    from dist_mnist_tpu_torch.train import create_train_state
    from dist_mnist_tpu_torch.train.state import params_digest

    out = {"phase": "data_parallel", "bench": {}}
    for name in ("resnet20_cifar", "lenet5_fashion", "resnet20_cifar_fsdp"):
        reset_counts()
        rec = bench.main(["--config", name, "--steps", "100",
                          "--device=cuda:0"])
        torch.cuda.synchronize()
        counts = read_counts()
        extra = rec["extra"]
        losses = extra["chunk_losses"]
        row = {"steps_per_sec": rec["value"], "mfu": extra["mfu"],
               "examples_per_sec": extra["examples_per_sec"],
               "global_batch": extra["global_batch"],
               "chunk_losses": losses, "steps_run": extra["steps_run"],
               "mesh_note": extra["mesh_note"],
               "sharding": extra["sharding"],
               "state_memory_bytes": extra["state_memory_bytes"],
               "launches": counts}
        out["bench"][name] = row
        print(json.dumps({"phase": "data_parallel", "bench": name, **row}),
              flush=True)
        if extra["global_batch"] != 128:
            fail(f"data_parallel {name}: batch {extra['global_batch']}, "
                 "not the per-chip 128")
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            fail(f"data_parallel {name}: chunk losses {losses}")
        if any(counts.values()):
            fail(f"data_parallel {name}: kernels launched on a path that "
                 f"has none (unfused Adam, no attention): {counts}")
    fsdp_note = out["bench"]["resnet20_cifar_fsdp"]
    if "benched as DP" not in fsdp_note["mesh_note"] \
            or fsdp_note["sharding"] != "dp":
        fail(f"data_parallel: resnet20_cifar_fsdp on one rank: "
             f"{fsdp_note['mesh_note']!r}, sharding {fsdp_note['sharding']}")

    runs = {}
    common = ["--mesh=data=2", "--eval_every=0", f"--train_steps={DP_STEPS}"]
    runs["lenet5_fashion"] = _launch_ranks(
        ["--config=lenet5_fashion", "--batch_size=256", "--log_every=10",
         *common], "lenet5_fashion")
    ckpt = {s: ROOT / "chiprun_out" / f"dp_ckpt_{s}" for s in ("fsdp", "dp")}
    for s, d in ckpt.items():
        shutil.rmtree(d, ignore_errors=True)
        runs[f"resnet20_{s}"] = _launch_ranks(
            ["--config=resnet20_cifar_fsdp", f"--sharding={s}",
             "--batch_size=256", "--log_every=5", f"--checkpoint_dir={d}",
             "--checkpoint_every_steps=25", *common], f"resnet20_{s}")
    runs["vit_flash"] = _launch_ranks(
        ["--config=vit_tiny_cifar_flash", "--mesh=data=2",
         "--batch_size=128", "--eval_every=0", "--log_every=5",
         f"--train_steps={DP_VIT_STEPS}"], "vit_flash")
    for name, ranks in runs.items():
        for r, rank in enumerate(ranks):
            print(json.dumps({"phase": "data_parallel", "run": name,
                              "rank": r, **rank}), flush=True)
            if "backend gloo (ranks share a card)" not in rank["startup"]:
                fail(f"data_parallel {name}: rank {r} startup "
                     f"{rank['startup']!r}")
        if ranks[0]["digest"] != ranks[1]["digest"]:
            fail(f"data_parallel {name}: the ranks' final params differ")
        if ranks[0]["losses"] != ranks[1]["losses"]:
            fail(f"data_parallel {name}: the ranks logged other losses")
        losses = list(ranks[0]["losses"].values())
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            fail(f"data_parallel {name}: losses {ranks[0]['losses']}")
    # DP moves one flat buffer a step, every param and the two metrics,
    # and ResNet-20 the synchronized batch norms' sums
    for name, n_params, bn in (
            ("lenet5_fashion", LENET_PARAMS, (0, 0)),
            ("resnet20_dp", RESNET_PARAMS,
             (RESNET_BN_LAYERS, RESNET_BN_CHANNELS))):
        per_step = runs[name][0]["collectives_per_step"]
        want = {"all_reduce_bytes": 4 * (n_params + 2) + 16 * bn[1],
                "all_reduce_calls": 1 + 4 * bn[0]}
        if per_step != want:
            fail(f"data_parallel {name}: collectives per step {per_step}, "
                 f"want {want}")
        if any(runs[name][0]["launches"].values()):
            fail(f"data_parallel {name}: kernels launched: "
                 f"{runs[name][0]['launches']}")
    # FSDP against DP: trajectory, per-rank bytes, checkpoint under DP
    f_run, d_run = runs["resnet20_fsdp"][0], runs["resnet20_dp"][0]
    gap = max((abs(f_run["losses"][s] - d_run["losses"][s])
               - LOG_RESOLUTION) / abs(d_run["losses"][s])
              for s in d_run["losses"])
    resident = {k: r["state_bytes"]["param_bytes"]
                + r["state_bytes"]["opt_state_bytes"]
                for k, r in (("fsdp", f_run), ("dp", d_run))}
    ratio = resident["fsdp"] / resident["dp"]
    cfg = get_config("resnet20_cifar")
    model = get_model("resnet20")
    target = create_train_state(model, optim.build_optimizer(cfg), 0,
                                load_dataset("cifar10", seed=42)
                                .train_images[:1], dev)
    mgr = CheckpointManager(ckpt["fsdp"], async_save=False)
    try:
        restored = mgr.restore(target)
    finally:
        mgr.close()
    restored_digest = params_digest(restored.params)
    out["fsdp"] = {"max_rel_loss_gap_vs_dp": gap,
                   "max_abs_loss_gap_vs_dp": max(
                       abs(f_run["losses"][s] - d_run["losses"][s])
                       for s in d_run["losses"]),
                   "resident_param_opt_bytes": resident,
                   "per_rank_ratio": ratio,
                   "restored_step": restored.step_int,
                   "restored_equals_final": restored_digest
                   == f_run["digest"],
                   "collectives_per_step": {
                       k: runs[f"resnet20_{k}"][0]["collectives_per_step"]
                       for k in ("fsdp", "dp")}}
    print(json.dumps({"phase": "data_parallel", "fsdp": out["fsdp"]}),
          flush=True)
    if gap > DP_FSDP_LOSS_TOL:
        fail(f"data_parallel: FSDP losses {f_run['losses']} vs DP "
             f"{d_run['losses']} (gap {gap})")
    if not 0.45 <= ratio <= 0.55:
        fail(f"data_parallel: FSDP per-rank state {resident['fsdp']} B, "
             f"DP {resident['dp']} B (ratio {ratio})")
    if restored.step_int != DP_STEPS or restored_digest != f_run["digest"]:
        fail(f"data_parallel: the FSDP checkpoint restored under DP at "
             f"step {restored.step_int}, params equal to the run's: "
             f"{restored_digest == f_run['digest']}")
    # the flash ViT: per rank 24 forward, 12 dQ, 12 dK/dV a step, no other
    depth = 12
    want = {"flash_attention_forward": 2 * depth * DP_VIT_STEPS,
            "flash_attention_dq": depth * DP_VIT_STEPS,
            "flash_attention_dkv": depth * DP_VIT_STEPS}
    for r, rank in enumerate(runs["vit_flash"]):
        got = rank["launches"]
        if any(got[k] != n for k, n in want.items()) or any(
                v for k, v in got.items() if k not in want):
            fail(f"data_parallel vit_flash: rank {r} launches {got}, want "
                 f"{want} and no other kernel")
    out["runs"] = {name: [{k: rank[k] for k in (
        "startup", "launches", "collectives_per_step", "state_bytes",
        "losses", "done")} for rank in ranks] for name, ranks in runs.items()}
    out["vit_launches"] = {k: sum(rank["launches"][k]
                                  for rank in runs["vit_flash"])
                           for k in want}
    return out


#: the tensor-parallel phase: causal_tiny (registry defaults: dim 64,
#: depth 2, 4 heads of 16, max_seq 64) served over model = 2, its int8
#: pages of 16 tokens
TP_LM_LAYOUTS = {"int8": dict(cache_layout="paged", kv_quant="int8"),
                 "dense": {}}
TP_SLOTS = 8
TP_LOAD = dict(n_requests=32, concurrency=8, seed=11)
TP_SERVE_REQUESTS = 32
#: the sharded flash entry's check: ViT's B and S, 4 heads of 64, bf16
TP_FLASH_SHAPE = (64, 65, 4, 64)
#: ViT-Tiny through cli.launch: the 16-chip ladder's per-data-rank batch
TP_VIT_STEPS = 10
TP_VIT_RUNS = {"vit_tp": ("vit_tiny_cifar_tp", 1, 2, 128),
               "vit_fsdp_tp": ("vit_tiny_cifar_fsdp_tp", 2, 2, 256)}
#: per-rank params + AdamW slots against DP's, as the rules predict
#: (PERF.md §6, PR 15: the block matrices halved over model, every leaf
#: the FSDP rule also splits halved again)
TP_STATE_RATIO = {"vit_tp": 0.5035633066466305,
                  "vit_fsdp_tp": 0.251781684401826}
TP_STATE_RATIO_TOL = 0.02
#: the CLI's digest of a rank's leaves that no tensor-parallel rule splits
TP_DIGEST = "model-replicated leaves digest: "


def _tp_rank(rank: int, world: int, store: str, out_path: str) -> None:
    """One rank of `tensor_parallel`'s two-rank group on the card (a
    spawned process): the decode engine over model = 2 (int8 pages, then
    a dense cache) under the seeded loadgen, the chief driving and the
    follower following, each rank counting its own launches; then the
    sharded flash entries against the unsharded kernels on the same
    inputs. Writes its record (or its traceback) to `out_path`."""
    import pickle
    import traceback

    import torch

    sys.path.insert(0, str(ROOT))
    from dist_mnist_tpu_torch.cluster import coordination
    from dist_mnist_tpu_torch.cluster.mesh import MeshSpec, make_mesh
    from dist_mnist_tpu_torch.ops.kernels import flash_attention as fa_mod
    from dist_mnist_tpu_torch.ops.kernels import masked_flash as mf_mod
    from dist_mnist_tpu_torch.ops.kernels import paged_attention as pa_mod
    from dist_mnist_tpu_torch.parallel.flash import (
        flash_attention_sharded,
        masked_flash_attention_sharded,
    )
    from dist_mnist_tpu_torch.serve import (
        DecodeScheduler,
        build_decode_engine,
        run_decode_loadgen,
    )

    counters = (pa_mod.paged_attention, mf_mod.masked_flash_attention,
                mf_mod.masked_flash_attention_backward,
                fa_mod.flash_attention_forward, fa_mod.flash_attention_dq,
                fa_mod.flash_attention_dkv)
    plain_calls = {"n": 0}
    plain = pa_mod.paged_attention_reference

    def counted_plain(*args):
        plain_calls["n"] += 1
        return plain(*args)

    def reset():
        plain_calls["n"] = 0
        for fn in counters:
            fn.launches = 0

    def read():
        return {**{fn.__name__: fn.launches for fn in counters},
                "paged_attention_reference_calls": plain_calls["n"]}

    pa_mod.paged_attention_reference = counted_plain
    out: dict = {}
    try:
        coordination.initialize_distributed(
            num_processes=world, process_id=rank,
            init_method=f"file://{store}", timeout_s=300)
        mesh = make_mesh(MeshSpec(data=1, model=world))
        out["startup"] = coordination.startup_line(coordination.context())
        for layout, kw in TP_LM_LAYOUTS.items():
            engine = build_decode_engine(mesh.device, seed=0,
                                         max_slots=TP_SLOTS, mesh=mesh, **kw)
            pool = engine.kv["k"].q if layout == "int8" else engine.kv["k"]
            reset()
            row = {"cache_heads": int(pool.shape[3])}
            if engine.is_follower:
                row["calls"] = engine.follow()
            else:
                try:
                    engine.prewarm()
                    sched = DecodeScheduler(engine)
                    try:
                        res = run_decode_loadgen(sched, keep_streams=True,
                                                 **TP_LOAD)
                    finally:
                        sched.close()
                finally:
                    engine.close()
                row.update(streams=res["streams"], ok=res["ok"])
            torch.cuda.synchronize()
            row.update(launches=read(), decode_steps=engine.decode_steps,
                       rank_kv_bytes=engine.rank_kv_bytes,
                       kv_stats=engine.kv_stats())
            out[layout] = row
        # the sharded flash entries, forward and backward, against the
        # unsharded kernels on the same inputs (those launches uncounted)
        gen = torch.Generator(device=mesh.device).manual_seed(15)
        q, k, v, g = (torch.randn(TP_FLASH_SHAPE, generator=gen,
                                  device=mesh.device).to(torch.bfloat16)
                      for _ in range(4))
        b, s, h, _ = TP_FLASH_SHAPE
        lengths = torch.linspace(2, s, b, device=mesh.device).round().to(
            torch.int32)
        heads = slice(mesh.model_index * h // world,
                      (mesh.model_index + 1) * h // world)
        flash = {}
        for name, sharded, whole in (
                ("flash", lambda a, b_, c: flash_attention_sharded(
                    a, b_, c, mesh=mesh), fa_mod.flash_attention),
                ("masked", lambda a, b_, c: masked_flash_attention_sharded(
                    a, b_, c, lengths, mesh=mesh),
                 lambda a, b_, c: mf_mod.masked_flash_attention(
                     a, b_, c, lengths))):
            res = []
            for i, fn in enumerate((sharded, whole)):
                leaves = [t.clone().requires_grad_() for t in (q, k, v)]
                reset()
                o = fn(*leaves)
                grads = torch.autograd.grad(o, leaves, grad_outputs=g)
                torch.cuda.synchronize()
                if i == 0:
                    launches = read()
                res.append([o.detach()] + list(grads))
            flash[name] = {
                "equal": [bool(torch.equal(x, y)) for x, y in zip(*res)],
                "max_abs_err": max(float((x.float() - y.float()).abs().max())
                                   for x, y in zip(*res)),
                "launches": launches}
        # the lse of this rank's heads against the unsharded call's
        local = [t[:, :, heads].contiguous() for t in (q, k, v)]
        _, lse_local = fa_mod.flash_attention_forward(*local)
        _, lse_whole = fa_mod.flash_attention_forward(q, k, v)
        flash["flash"]["lse_equal"] = bool(torch.equal(
            lse_local, lse_whole[:, heads]))
        _, lse_local = mf_mod.masked_flash_attention_forward(
            *local, lengths)
        _, lse_whole = mf_mod.masked_flash_attention_forward(q, k, v,
                                                             lengths)
        flash["masked"]["lse_equal"] = bool(torch.equal(
            lse_local, lse_whole[:, heads]))
        out["flash"] = flash
        result = {"ok": out}
    except BaseException:  # noqa: BLE001 — handed to the parent
        result = {"error": traceback.format_exc()}
    finally:
        pa_mod.paged_attention_reference = plain
        coordination.shutdown()
    with open(out_path, "wb") as fh:
        pickle.dump(result, fh)


def _tp_engine_one_rank(torch, dev, layout: str) -> dict:
    """The same traffic through the one-rank engine on the card."""
    from dist_mnist_tpu_torch.serve import (
        DecodeScheduler,
        build_decode_engine,
        run_decode_loadgen,
    )

    engine = build_decode_engine(dev, seed=0, max_slots=TP_SLOTS,
                                 **TP_LM_LAYOUTS[layout])
    engine.prewarm()
    sched = DecodeScheduler(engine)
    try:
        res = run_decode_loadgen(sched, keep_streams=True, **TP_LOAD)
    finally:
        sched.close()
    torch.cuda.synchronize()
    return {"streams": res["streams"], "ok": res["ok"],
            "rank_kv_bytes": engine.rank_kv_bytes,
            "decode_steps": engine.decode_steps}


def time_tp_paged(torch, dev, bw: float, f32_peak: float) -> dict:
    """`paged_attention` at the TP decode step's shape (causal_tiny: 9
    rows, heads of 16, pages of 16, the widest table of 4 pages, the
    loadgen's lengths up to 64) on a rank's 2 heads and on all 4, beside
    the plain version, the launch floor and the bound (`graph_ms`)."""
    from dist_mnist_tpu_torch.ops import quant as quant_mod
    from dist_mnist_tpu_torch.ops.kernels.paged_attention import (
        paged_attention,
        paged_attention_cost,
        paged_attention_launch_floor,
        paged_attention_reference,
    )

    rows, d, t, n = TP_SLOTS + 1, 16, 16, 4
    lengths = [33, 47, 21, 58, 40, 64, 29, 51, 1]
    out = {}
    for h in (2, 4):
        gen = torch.Generator().manual_seed(41 + h)
        pages = rows * n + n

        def pool():
            x = torch.randn(pages, t, h, d, generator=gen)
            qz, scale = quant_mod.quantize_kv(x.to(dev))
            return quant_mod.QuantizedArray(qz, scale, "kv_head")

        kp, vp = pool(), pool()
        q = torch.randn(rows, 1, h, d, generator=gen).to(dev)
        table = torch.randperm(pages, generator=gen)[:rows * n].reshape(
            rows, n).to(torch.int32).to(dev)
        lens = torch.tensor(lengths, dtype=torch.int32).to(dev)
        cost = paged_attention_cost(lens.cpu().numpy(), n, t, h, d)
        t_bytes = cost["active_bytes"] / bw * 1e3
        t_ops = cost["flops"] / f32_peak * 1e3
        got = paged_attention(q, kp, vp, table, lens)
        want = paged_attention_reference(q, kp, vp, table, lens)
        out[h] = {
            "kernel_ms": graph_ms(torch, lambda: paged_attention(
                q, kp, vp, table, lens)),
            "plain_ms": graph_ms(torch, lambda: paged_attention_reference(
                q, kp, vp, table, lens)),
            "launch_floor_ms": graph_ms(
                torch, lambda: paged_attention_launch_floor(
                    q, kp, vp, table, lens)),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "max_abs_err": float((got - want).abs().max())}
        print(json.dumps({"phase": "time", "kernel": "paged_attention",
                          "shape": f"tensor-parallel decode step: R={rows},"
                                   f" H={h}, D={d}, T={t}, width {n}",
                          **out[h]}), flush=True)
    return out


def _log_rates(output: str, rank: int) -> float | None:
    """Steps/s of rank `rank` between its first and last
    `StepCounterHook` lines, from their time stamps."""
    import datetime

    marks = []
    for line in output.splitlines():
        if line.startswith(f"[p{rank}] ") and "steps/sec" in line:
            stamp = line[len(f"[p{rank}] "):].split(" ", 2)
            when = datetime.datetime.strptime(
                f"{stamp[0]} {stamp[1]}", "%Y-%m-%d %H:%M:%S,%f")
            step = int(line.split("step ")[1].split(":")[0])
            marks.append((when, step))
    if len(marks) < 2:
        return None
    (t0, s0), (t1, s1) = marks[0], marks[-1]
    return (s1 - s0) / max((t1 - t0).total_seconds(), 1e-9)


def tensor_parallel(torch, dev, reset_counts, read_counts, bw: float,
                    f32_peak: float) -> dict:
    """Phase `tensor_parallel`: (1) two ranks on the card serve causal_tiny
    over model = 2 (int8 pages, then dense) under the seeded loadgen:
    streams bitwise the one-rank engine's, half its KV bytes a rank,
    exactly `depth` `paged_attention` launches a rank per int8 decode
    step on 2 heads and no call of its plain version; (2) `cli.serve
    --decode --mesh=model=2`: every request ok; (3) the same two ranks:
    the sharded flash entries at B = 64, S = 65, 4 heads of 64, bf16,
    out, lse and dQ/dK/dV bitwise the unsharded kernels'; (4) ViT-Tiny
    through `cli.launch`: `vit_tiny_cifar_tp` on 2 ranks (data 1 x model
    2, global batch 128) and `vit_tiny_cifar_fsdp_tp` on 4 (data 2 x
    model 2, 256), finite falling losses, replicated leaves the same bits
    on every rank, per-rank state at the rules' share of DP's, and the
    chief's last checkpoint restored under DP equal to the final params.
    Returns the phase's record."""
    from dist_mnist_tpu_torch import optim
    from dist_mnist_tpu_torch.checkpoint import CheckpointManager
    from dist_mnist_tpu_torch.configs import get_config
    from dist_mnist_tpu_torch.models.registry import get_model
    from dist_mnist_tpu_torch.train import (
        create_train_state,
        state_memory_bytes,
    )
    from dist_mnist_tpu_torch.train.state import params_digest

    out = {"phase": "tensor_parallel"}
    depth = get_model("causal_tiny").depth
    # (1) + (3): the two-rank group, then the one-rank engine
    t0 = time.perf_counter()
    ranks = _rank_group(_tp_rank, "tp")
    out["group_wall_s"] = time.perf_counter() - t0
    chief, follower = ranks
    decode = {}
    for layout in TP_LM_LAYOUTS:
        one = _tp_engine_one_rank(torch, dev, layout)
        rows = [r[layout] for r in ranks]
        rec = {
            "streams_equal": chief[layout]["streams"] == one["streams"],
            "ok": chief[layout]["ok"],
            "rank_kv_bytes": [r["rank_kv_bytes"] for r in rows],
            "one_rank_kv_bytes": one["rank_kv_bytes"],
            "kv_ratio": chief[layout]["rank_kv_bytes"]
            / one["rank_kv_bytes"],
            "cache_heads": [r["cache_heads"] for r in rows],
            "decode_steps": [r["decode_steps"] for r in rows],
            "one_rank_decode_steps": one["decode_steps"],
            "launches": [r["launches"] for r in rows]}
        decode[layout] = rec
        print(json.dumps({"phase": "tensor_parallel", "decode": layout,
                          **rec}), flush=True)
        if not rec["streams_equal"] or rec["ok"] != TP_LOAD["n_requests"]:
            fail(f"tensor_parallel {layout}: streams equal to the one-rank "
                 f"engine's: {rec['streams_equal']}, {rec['ok']} ok")
        if any(b * 2 != one["rank_kv_bytes"] for b in rec["rank_kv_bytes"]) \
                or rec["cache_heads"] != [2, 2]:
            fail(f"tensor_parallel {layout}: KV bytes a rank "
                 f"{rec['rank_kv_bytes']} against one rank's "
                 f"{one['rank_kv_bytes']}, heads {rec['cache_heads']}")
        for r, row in enumerate(rows):
            want = depth * row["decode_steps"] if layout == "int8" else 0
            got = row["launches"]
            if got["paged_attention"] != want or row["decode_steps"] == 0 \
                    or got["paged_attention_reference_calls"] != 0 \
                    or any(v for k, v in got.items()
                           if k != "paged_attention"):
                fail(f"tensor_parallel {layout}: rank {r} launches {got} "
                     f"for {row['decode_steps']} decode steps (want "
                     f"{depth} paged_attention a step on int8 pages, none "
                     "on a dense cache, no other kernel, no plain call)")
    out["decode"] = decode
    flash = {name: [r["flash"][name] for r in ranks]
             for name in ("flash", "masked")}
    print(json.dumps({"phase": "tensor_parallel", "flash": flash,
                      "shape": list(TP_FLASH_SHAPE)}), flush=True)
    want = {"flash": {"flash_attention_forward": 1, "flash_attention_dq": 1,
                      "flash_attention_dkv": 1},
            "masked": {"masked_flash_attention": 1,
                       "masked_flash_attention_backward": 2}}
    for name, rows in flash.items():
        for r, row in enumerate(rows):
            got = {k: v for k, v in row["launches"].items() if v}
            if row["equal"] != [True] * 4 or not row["lse_equal"] \
                    or got != want[name]:
                fail(f"tensor_parallel flash {name}: rank {r} out/dq/dk/dv "
                     f"equal {row['equal']}, lse {row['lse_equal']}, "
                     f"launches {got} (want {want[name]})")
    out["flash"] = flash
    if "backend gloo (ranks share a card)" not in chief["startup"]:
        fail(f"tensor_parallel: startup {chief['startup']!r}")

    # (2) the serving CLI spawns its own two ranks
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "dist_mnist_tpu_torch.cli.serve", "--decode",
         "--mesh=model=2", f"--requests={TP_SERVE_REQUESTS}",
         "--concurrency=8"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    (ROOT / "chiprun_out" / "tp_serve.log").write_text(proc.stdout
                                                       + proc.stderr)
    if proc.returncode != 0:
        fail(f"tensor_parallel cli.serve: exit {proc.returncode}:\n"
             + (proc.stdout + proc.stderr)[-4000:])
    body = "\n".join(line[5:] for line in proc.stdout.splitlines()
                     if line.startswith("[p0] ") and " INFO" not in line
                     and " WARNING" not in line)
    summary = json.loads(body[body.index("{"):])
    serve = {k: summary[k] for k in ("ok", "errors", "n_requests",
                                     "decode_steps", "mesh",
                                     "rank_kv_bytes", "ttft_p99_ms")
             if k in summary}
    serve["wall_s"] = time.perf_counter() - t0
    print(json.dumps({"phase": "tensor_parallel", "cli_serve": serve}),
          flush=True)
    if summary["ok"] != TP_SERVE_REQUESTS \
            or summary.get("mesh") != {"model": 2}:
        fail(f"tensor_parallel cli.serve: {serve}")
    out["cli_serve"] = serve

    # (4) ViT-Tiny: TP on 2 ranks, FSDP x TP on 4
    runs = {}
    for tag, (name, data, model, batch) in TP_VIT_RUNS.items():
        # ViT-Tiny's checkpoints (~64 MB a step) stay out of chiprun_out
        ckpt = Path(tempfile.mkdtemp(prefix=f"tp_ckpt_{tag}_"))
        ranks_out = _launch_ranks(
            [f"--config={name}", f"--mesh=data={data},model={model}",
             f"--batch_size={batch}", "--eval_every=0", "--log_every=5",
             f"--train_steps={TP_VIT_STEPS}", f"--checkpoint_dir={ckpt}",
             f"--checkpoint_every_steps={TP_VIT_STEPS}"], tag,
            n=data * model, timeout=600, extra=(TP_DIGEST,))
        runs[tag] = ranks_out
        cfg = get_config(name)
        vit = get_model(cfg.model, **cfg.model_kwargs)
        target = create_train_state(vit, optim.build_optimizer(cfg), 0,
                                    np.zeros((1, 32, 32, 3), np.uint8), dev)
        dp_bytes = state_memory_bytes(target)
        dp_bytes = dp_bytes["param_bytes"] + dp_bytes["opt_state_bytes"]
        mgr = CheckpointManager(ckpt, async_save=False)
        try:
            restored = mgr.restore(target)
        finally:
            mgr.close()
            shutil.rmtree(ckpt, ignore_errors=True)
        per_rank = [r["state_bytes"]["param_bytes"]
                    + r["state_bytes"]["opt_state_bytes"] for r in ranks_out]
        rec = {"config": name, "mesh": {"data": data, "model": model},
               "global_batch": batch,
               "steps_per_sec": [r["steps_per_sec"] for r in ranks_out],
               "losses": ranks_out[0]["losses"],
               "collectives_per_step": ranks_out[0]["collectives_per_step"],
               "launches": ranks_out[0]["launches"],
               "per_rank_state_bytes": per_rank, "dp_state_bytes": dp_bytes,
               "ratio": per_rank[0] / dp_bytes,
               "restored_step": restored.step_int,
               "restored_equals_final": params_digest(restored.params)
               == ranks_out[0]["digest"],
               "wall_s": ranks_out[0]["wall_s"]}
        # the leaves no tensor-parallel rule splits: the same bits on
        # every rank of a model group (ranks d*model .. d*model+model-1)
        groups = [{r[TP_DIGEST] for r in ranks_out[d * model:(d + 1) * model]}
                  for d in range(data)]
        rec["model_replicated_digests"] = [sorted(g) for g in groups]
        for r, rank in enumerate(ranks_out):
            print(json.dumps({"phase": "tensor_parallel", "run": tag,
                              "rank": r, **{k: v for k, v in rank.items()
                                            if k != "output"}}), flush=True)
        print(json.dumps({"phase": "tensor_parallel", "vit": tag, **rec}),
              flush=True)
        losses = list(rec["losses"].values())
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            fail(f"tensor_parallel {tag}: losses {rec['losses']}")
        for key in ("digest", "losses"):
            if len({json.dumps(r[key], sort_keys=True)
                    for r in ranks_out}) != 1:
                fail(f"tensor_parallel {tag}: the ranks' {key!r} differ")
        if any(len(g) != 1 for g in groups):
            fail(f"tensor_parallel {tag}: model-replicated leaves differ "
                 f"within a model group: {groups}")
        for r, rank in enumerate(ranks_out):
            if "backend gloo (ranks share a card)" not in rank["startup"]:
                fail(f"tensor_parallel {tag}: rank {r} startup "
                     f"{rank['startup']!r}")
        if len(set(per_rank)) != 1 or abs(
                rec["ratio"] - TP_STATE_RATIO[tag]) > TP_STATE_RATIO_TOL:
            fail(f"tensor_parallel {tag}: per-rank state {per_rank} B "
                 f"against DP's {dp_bytes} B, ratio {rec['ratio']} (want "
                 f"{TP_STATE_RATIO[tag]} +- {TP_STATE_RATIO_TOL})")
        if restored.step_int != TP_VIT_STEPS \
                or not rec["restored_equals_final"]:
            fail(f"tensor_parallel {tag}: checkpoint restored under DP at "
                 f"step {restored.step_int}, equal to the final params: "
                 f"{rec['restored_equals_final']}")
        per_step = rec["collectives_per_step"]
        if not per_step.get("tp_all_reduce_calls") \
                or not per_step.get("tp_all_gather_calls") \
                or (data > 1) != bool(per_step.get("reduce_scatter_calls")):
            fail(f"tensor_parallel {tag}: collectives per step {per_step}")
        if any(rec["launches"].values()):
            fail(f"tensor_parallel {tag}: kernels launched on the 'xla' "
                 f"ViT path: {rec['launches']}")
        out[tag] = rec
    out["paged_h2"] = time_tp_paged(torch, dev, bw, f32_peak)
    return out


#: sequence parallelism: the two flash configs, 10 steps each at the 16-chip
#: ladder's 1024 / 8 = 128 a data rank, on data = 1 x seq = 2
SP_STEPS = 10
SP_BATCH = 128
SP_RUNS = {"ring_flash": "vit_tiny_cifar_ring_flash",
           "ulysses_flash": "vit_tiny_cifar_ulysses_flash"}
#: the kernels' calls on the path: a ring block (B, S/seq, H, D) and
#: Ulysses' local attention after the reshard (B, S, H/seq, D; D = 48 takes
#: the D = 64 instantiation)
SP_RING_SHAPE = (128, 32, 3, 64)
SP_ULYSSES_SHAPE = (128, 64, 2, 48)
#: bf16 limits, relative to the largest value: the ring rounds each block's
#: output to bf16 before its f32 merge, so it differs from one call over
#: every key by a rounding of the output; the gradients carry it too
SP_BF16_TOL = 2e-2
#: f32: the "xla" engines against the plain dense attention (out, grads)
SP_F32_TOL = (1e-5, 1e-4)
#: step 1 against one rank's unsharded step: the loss relative, each
#: gradient leaf's relative L2 error (`grad_errors`), as `vit_kernel_vs_plain`
SP_LOSS_TOL, SP_GRAD_TOL = VIT_PLAIN_TOL, VIT_GRAD_TOL
SP_POLICIES = ("dots_no_batch", "save_attn", "dots")
#: the two runs' checkpoints (~64 MB each), kept out of the logs' folder
SP_CKPT = Path(tempfile.gettempdir()) / "dist_mnist_sp_ckpt"


def sp_launches(impl: str, depth: int = 12) -> dict:
    """The flash launches a rank and step of the SP ViT under remat
    `dots_no_batch` (every layer's forward, its recompute, and one
    backward): the ring runs one forward call and one backward per block
    of seq = 2; Ulysses one of each a layer."""
    calls = depth * (2 if impl.startswith("ring") else 1)
    return {"flash_attention_forward": 2 * calls,
            "flash_attention_dq": calls, "flash_attention_dkv": calls}


def sp_bytes(impl: str, params: int, depth: int = 12) -> dict:
    """The `sp_` collectives a rank and step (payload: what the rank
    contributes) at B = 128, 64 tokens, bf16, seq = 2, remat: the ring
    shifts K and V once a layer (no shift after the last block) in the
    forward, its recompute and the backward; Ulysses all-to-alls q, k, v
    and the output the same three times; the pool's [128, 192] f32 sum
    forward, recompute and backward, and one all-reduce of every f32
    gradient."""
    b, s_local = SP_BATCH, 32
    if impl.startswith("ring"):
        block = b * s_local * 3 * 64 * 2
        key, calls = "sp_ring_shift", 3 * 2 * depth
    else:
        block = b * s_local * 4 * 48 * 2
        key, calls = "sp_all_to_all", 3 * 4 * depth
    return {f"{key}_bytes": calls * block, f"{key}_calls": calls,
            "sp_all_reduce_bytes": 3 * b * 192 * 4 + 4 * params,
            "sp_all_reduce_calls": 4}


def _peak(torch, dev, fn):
    """``(fn(), peak allocated bytes while it ran, that peak less the bytes
    allocated when it started)``: the second is the run's own."""
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = fn()
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    return out, peak, peak - base


def sp_kernel_parity(torch, dev) -> dict:
    """The flash kernels at the sequence-parallel path's shapes, against
    their plain versions on the same inputs: `flash_attention_lse` at a
    ring block (B = 128, 32 tokens, 3 heads of 64, bf16; q a strided view
    of the fused projection, K and V the rank's own strided block and a
    shifted contiguous one), forward and backward through its autograd
    Function with a random nonzero lse cotangent; `flash_attention` at
    Ulysses' local call (B = 128, S = 64, 2 heads of 48, bf16). Out and
    q, k, v gradients within `FLASH_TOL` bf16, lse within `LSE_TOL`."""
    from dist_mnist_tpu_torch.ops.kernels import flash_attention as fa

    out = {}
    tol = FLASH_TOL["bfloat16"]
    b, s, h, d = SP_RING_SHAPE
    q, k_own, v_own = _fused_qkv(torch, b, s, h, d, torch.bfloat16, dev,
                                 seed=160)
    _, k_in, v_in = (t.contiguous() for t in _fused_qkv(
        torch, b, s, h, d, torch.bfloat16, dev, seed=161))
    gen = torch.Generator().manual_seed(162)
    w_out = torch.randn(b, s, h, d, generator=gen).to(dev, torch.bfloat16)
    w_lse = torch.randn(b, h, s, generator=gen).to(dev)
    for label, k, v in (("own block", k_own, v_own),
                        ("shifted block", k_in, v_in)):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        o, lse = fa.flash_attention_lse(*leaves)
        grads = torch.autograd.grad((o, lse), leaves,
                                    grad_outputs=(w_out, w_lse))
        with torch.no_grad():
            r_out, r_lse = fa.flash_attention_forward_reference(q, k, v)
            want = fa.flash_attention_backward_reference(
                q, k, v, w_out, r_lse, fa.attention_delta(r_out, w_out,
                                                          w_lse))
        torch.cuda.synchronize()
        errs = grad_errs(grads, want)
        row = {"out": rel_err(o, r_out), "lse": rel_err(lse, r_lse),
               "grads": errs}
        out[f"ring lse {label}"] = row
        print(json.dumps({"phase": "sequence_parallel", "kernel_parity":
                          f"flash_attention_lse, ring {label}, nonzero dlse",
                          "shape": list(SP_RING_SHAPE), "dtype": "bfloat16",
                          "tol": {"out": tol[0], "lse": LSE_TOL,
                                  "grads": tol[1]}, **row}), flush=True)
        if row["out"][1] > tol[0] or row["lse"][1] > LSE_TOL \
                or max(e[1] for e in errs) > tol[1]:
            fail(f"sequence_parallel: flash_attention_lse at the ring's "
                 f"{label}: {row}")
    b, s, h, d = SP_ULYSSES_SHAPE
    gen = torch.Generator().manual_seed(163)
    q, k, v, g = (torch.randn(b, s, h, d, generator=gen).to(dev,
                                                           torch.bfloat16)
                  for _ in range(4))
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    o = fa.flash_attention(*leaves)
    grads = torch.autograd.grad(o, leaves, grad_outputs=g)
    with torch.no_grad():
        r_out, r_lse = fa.flash_attention_forward_reference(q, k, v)
        want = fa.flash_attention_backward_reference(
            q, k, v, g, r_lse, fa.attention_delta(r_out, g))
    torch.cuda.synchronize()
    errs = grad_errs(grads, want)
    row = {"out": rel_err(o, r_out), "grads": errs,
           "padded_head_dim": fa.padded_head_dim(d)}
    out["ulysses d48"] = row
    print(json.dumps({"phase": "sequence_parallel", "kernel_parity":
                      "flash_attention at Ulysses' D = 48",
                      "shape": list(SP_ULYSSES_SHAPE), "dtype": "bfloat16",
                      "tol": {"out": tol[0], "grads": tol[1]}, **row}),
          flush=True)
    if row["out"][1] > tol[0] or max(e[1] for e in errs) > tol[1]:
        fail(f"sequence_parallel: flash_attention at D = 48: {row}")
    return out


def _sp_attention(torch, mesh) -> dict:
    """Ring and Ulysses attention on this rank's tokens of seeded full
    inputs (the same on both ranks): the flash engine in bf16 against one
    `flash_attention` call over the whole sequence, the "xla" engine in
    f32 against the plain dense attention; output and q, k, v gradients
    of this rank's tokens."""
    from dist_mnist_tpu_torch.ops import nn
    from dist_mnist_tpu_torch.ops.kernels import flash_attention as fa
    from dist_mnist_tpu_torch.parallel.ring_attention import (
        ring_self_attention,
    )
    from dist_mnist_tpu_torch.parallel.ulysses import ulysses_self_attention

    out = {}
    for name, fn, (b, s, h, d) in (
            ("ring", ring_self_attention, (128, 64, 3, 64)),
            ("ulysses", ulysses_self_attention, (128, 64, 4, 48))):
        gen = torch.Generator(device=mesh.device).manual_seed(170)
        full = [torch.randn(b, s, h, d, generator=gen, device=mesh.device)
                for _ in range(4)]
        tok = slice(mesh.seq_index * s // 2, (mesh.seq_index + 1) * s // 2)
        for impl, dtype, whole in (
                ("flash", torch.bfloat16, fa.flash_attention),
                ("xla", torch.float32, nn.dot_product_attention)):
            q, k, v, g = (t.to(dtype) for t in full)
            local = [t[:, tok].clone().requires_grad_() for t in (q, k, v)]
            o = fn(*local, mesh, impl=impl)
            grads = torch.autograd.grad(o, local, grad_outputs=g[:, tok])
            ref = [t.clone().requires_grad_() for t in (q, k, v)]
            o_ref = whole(*ref)
            want = torch.autograd.grad(o_ref, ref, grad_outputs=g)
            torch.cuda.synchronize()
            out[f"{name}/{impl}"] = {
                "out": rel_err(o, o_ref[:, tok]),
                "grads": [rel_err(a, w[:, tok]) for a, w in zip(grads, want)]}
    return out


def _sp_rank(rank: int, world: int, store: str, out_path: str) -> None:
    """One rank of `sequence_parallel`'s two-rank group on the card (data
    = 1 x seq = 2): the attention parity, each flash config's first step
    against one rank's unsharded step on the same params and batch, one
    `ring_flash` step under each remat policy, and the two configs through
    the training CLI's `run_config` for `SP_STEPS` steps with a
    checkpoint at the last. Writes its record (or its traceback) to
    `out_path`."""
    import dataclasses
    import pickle
    import traceback

    import torch

    sys.path.insert(0, str(ROOT))
    from dist_mnist_tpu_torch import optim
    from dist_mnist_tpu_torch.cli.train import run_config
    from dist_mnist_tpu_torch.cluster import coordination
    from dist_mnist_tpu_torch.cluster.mesh import MeshSpec, activate, make_mesh
    from dist_mnist_tpu_torch.configs import get_config
    from dist_mnist_tpu_torch.hooks import Hook
    from dist_mnist_tpu_torch.models.registry import get_model
    from dist_mnist_tpu_torch.ops import losses
    from dist_mnist_tpu_torch.ops.kernels import (
        launch_counts,
        reset_launch_counts,
    )
    from dist_mnist_tpu_torch.parallel.collectives import sum_over_axis
    from dist_mnist_tpu_torch.parallel.sharding import shard_train_state
    from dist_mnist_tpu_torch.train import create_train_state, make_train_step
    from dist_mnist_tpu_torch.train.state import params_digest
    from dist_mnist_tpu_torch.train.step import loss_and_grads
    from dist_mnist_tpu_torch.utils.tree import flatten_with_path

    class Losses(Hook):
        """Each step's loss and the time it was read."""

        def __init__(self):
            self.rows = []

        def after_step(self, step, state, outputs):
            self.rows.append((step, float(outputs["loss"]),
                              time.perf_counter()))

    def flat(tree):
        return {"/".join(map(str, p)): x.float()
                for p, x in flatten_with_path(tree)}

    out: dict = {}
    try:
        coordination.initialize_distributed(
            num_processes=world, process_id=rank,
            init_method=f"file://{store}", timeout_s=300)
        mesh = make_mesh(MeshSpec(data=1, seq=world))
        dev = mesh.device
        out["startup"] = coordination.startup_line(coordination.context())
        t0 = time.perf_counter()
        out["attention"] = _sp_attention(torch, mesh)
        gen = torch.Generator().manual_seed(171)
        batch = {"image": torch.randint(0, 256, (SP_BATCH, 32, 32, 3),
                                        generator=gen, dtype=torch.uint8
                                        ).to(dev),
                 "label": torch.randint(0, 10, (SP_BATCH,), generator=gen,
                                        dtype=torch.int32).to(dev)}
        out["first_step"], out["remat"] = {}, {}
        for impl, name in SP_RUNS.items():
            cfg = get_config(name)
            model = get_model(cfg.model, **cfg.model_kwargs)
            opt = optim.build_optimizer(cfg)
            state = create_train_state(model, opt, 0,
                                       np.zeros((1, 32, 32, 3), np.uint8),
                                       dev)
            mask = model.dropout_masks(
                torch.Generator(device=dev).manual_seed(172),
                batch["image"])
            kw = dict(dropout_mask=mask, remat=True)
            with activate(mesh):
                loss, _, _, grads = loss_and_grads(
                    model, losses.softmax_cross_entropy, state.params, {},
                    batch, **kw)
            grads = sum_over_axis(grads, mesh, "seq")
            one_loss, _, _, one_grads = loss_and_grads(
                model, losses.softmax_cross_entropy, state.params, {},
                batch, **kw)
            torch.cuda.synchronize()
            out["first_step"][impl] = {
                "loss": float(loss), "one_rank_loss": float(one_loss),
                "grad_errors": grad_errors(flat(grads), flat(one_grads))}
            del grads, one_grads
            if impl == "ring_flash":
                for policy in SP_POLICIES:
                    step = make_train_step(model, opt, mesh=mesh, remat=True,
                                           remat_policy=policy)
                    placed = shard_train_state(state, mesh)
                    before = dict(mesh.stats)
                    reset_launch_counts()
                    metrics, peak, own = _peak(torch, dev, lambda: step(
                        placed, batch, dropout_mask=mask)[1])
                    out["remat"][policy] = {
                        "loss": float(metrics["loss"]),
                        "launches": launch_counts(),
                        "sp": {k: v - before.get(k, 0)
                               for k, v in mesh.stats.items()
                               if k.startswith("sp_")},
                        "peak_bytes": peak, "step_peak_bytes": own}
                    del placed, metrics
            del state, mask
        del batch
        out["checks_wall_s"] = time.perf_counter() - t0
        out["runs"] = {}
        for impl, name in SP_RUNS.items():
            cfg = dataclasses.replace(
                get_config(name), batch_size=SP_BATCH,
                train_steps=SP_STEPS, eval_every=0, log_every=5)
            hook = Losses()
            ckpt = SP_CKPT / impl
            t0 = time.perf_counter()
            (state, _, ctx), peak, own = _peak(torch, dev, lambda: run_config(
                cfg, device=dev, checkpoint_dir=str(ckpt),
                checkpoint_every_steps=SP_STEPS, extra_hooks=[hook]))
            wall = time.perf_counter() - t0
            (s0, _, t_first), (s1, _, t_last) = hook.rows[0], hook.rows[-1]
            out["runs"][impl] = {
                "step": state.step_int, "losses": [r[1] for r in hook.rows],
                "steps_per_sec": (s1 - s0) / max(t_last - t_first, 1e-9),
                "launches": ctx["launches"],
                "collectives_per_step": ctx["collectives_per_step"],
                "digest": params_digest(state.params),
                "params": sum(x.numel() for _, x in
                              flatten_with_path(state.params)),
                "peak_bytes": peak, "run_peak_bytes": own,
                "mesh": dict(ctx["mesh"].shape), "wall_s": wall,
                "checkpoint_dir": str(ckpt)}
            del state, ctx
        result = {"ok": out}
    except BaseException:  # noqa: BLE001 — handed to the parent
        result = {"error": traceback.format_exc()}
    finally:
        coordination.shutdown()
    with open(out_path, "wb") as fh:
        pickle.dump(result, fh)


def _rank_group(target, tag: str, world: int = 2,
                timeout: float = 400.0) -> list:
    """`target(rank, world, store, out_path)` on `world` spawned processes
    sharing the card; each rank's record, rank 0's first. Fails on an
    error, a hang or a missing record, and leaves no process behind."""
    import multiprocessing as mp
    import pickle

    tmp = ROOT / "chiprun_out" / f"{tag}_group"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    store = str(tmp / "store")
    outs = [str(tmp / f"rank{r}.pkl") for r in range(world)]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, world, store, outs[r]))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
        for p in procs:
            p.join(timeout=30)
    phase = {"tp": "tensor_parallel", "sp": "sequence_parallel",
             "mp": "model_parallel", "native": "native",
             "ms": "multislice", "ms8": "multislice", "zoo": "zoo_sharded",
             "zoo4": "zoo_sharded"}[tag]
    if hung:
        fail(f"{phase}: {len(hung)} of {world} ranks still running after "
             f"{timeout}s")
    records = []
    for r, path in enumerate(outs):
        if not Path(path).exists():
            fail(f"{phase}: rank {r} left no record (exit code "
                 f"{procs[r].exitcode})")
        with open(path, "rb") as fh:
            res = pickle.load(fh)
        if "error" in res:
            fail(f"{phase}: rank {r} raised:\n{res['error']}")
        records.append(res["ok"])
    return records


def _one_rank_run(torch, dev, name: str) -> dict:
    """`name` through `run_config` on one rank at the same per-data-rank
    batch (the ring and Ulysses fall back to the flash kernels over the
    whole sequence): steps/s and peak allocated bytes."""
    import dataclasses

    from dist_mnist_tpu_torch.cli.train import run_config
    from dist_mnist_tpu_torch.cluster.mesh import MeshSpec
    from dist_mnist_tpu_torch.configs import get_config
    from dist_mnist_tpu_torch.hooks import Hook

    marks = []

    class Mark(Hook):
        def after_step(self, step, state, outputs):
            marks.append((step, float(outputs["loss"]), time.perf_counter()))

    cfg = dataclasses.replace(get_config(name), batch_size=SP_BATCH,
                              train_steps=SP_STEPS, eval_every=0,
                              log_every=5, mesh=MeshSpec(data=1))
    (_, _, ctx), peak, own = _peak(torch, dev, lambda: run_config(
        cfg, device=dev, extra_hooks=[Mark()]))
    (s0, _, t0), (s1, _, t1) = marks[0], marks[-1]
    return {"steps_per_sec": (s1 - s0) / max(t1 - t0, 1e-9),
            "peak_bytes": peak, "run_peak_bytes": own,
            "launches": ctx["launches"]}


def sequence_parallel(torch, dev) -> dict:
    """Phase `sequence_parallel`: (1) the flash kernels at the path's
    shapes against their plain versions (`sp_kernel_parity`); then two
    spawned ranks on the card (gloo, data = 1 x seq = 2, ViT-Tiny at full
    width, 64 tokens, batch 128): (2) ring and Ulysses attention on each
    rank's tokens, flash in bf16 against one flash call over the whole
    sequence and "xla" in f32 against the plain dense attention, within
    `SP_BF16_TOL` and `SP_F32_TOL`; (3) `ring_flash` and `ulysses_flash`
    step 1 within `SP_LOSS_TOL` / `SP_GRAD_TOL` of one rank's unsharded
    step, then `SP_STEPS` steps each through `run_config` with the
    launch counters set to 0 just before the loop and read just after:
    finite falling losses, the same on both ranks, the same final params,
    exactly `sp_launches` a rank and step and no other kernel (an exact
    count also shows no call took a plain version), the `sp_` collectives
    a step exactly `sp_bytes`, the chief's checkpoint restored here on
    one rank bit for bit; steps/s and peak allocated bytes a rank against
    one rank at the same batch; (4) one `ring_flash` step under each of
    `SP_POLICIES`: the same loss, each one's flash-forward launches, `sp_`
    bytes and peak bytes. Returns the phase's record."""
    from dist_mnist_tpu_torch import optim
    from dist_mnist_tpu_torch.checkpoint import CheckpointManager
    from dist_mnist_tpu_torch.configs import get_config
    from dist_mnist_tpu_torch.data.datasets import load_dataset
    from dist_mnist_tpu_torch.models.registry import get_model
    from dist_mnist_tpu_torch.train import create_train_state
    from dist_mnist_tpu_torch.train.state import params_digest

    t_phase = time.perf_counter()
    out = {"phase": "sequence_parallel",
           "kernel_parity": sp_kernel_parity(torch, dev)}
    shutil.rmtree(SP_CKPT, ignore_errors=True)
    for name in SP_RUNS.values():  # the twin is cached before the ranks
        cfg = get_config(name)    # read it
        load_dataset(cfg.dataset, seed=cfg.seed)
    ranks = _rank_group(_sp_rank, "sp")
    out["group_wall_s"] = time.perf_counter() - t_phase
    for r, rank in enumerate(ranks):
        if "backend gloo (ranks share a card)" not in rank["startup"]:
            fail(f"sequence_parallel: rank {r} startup {rank['startup']!r}")
        for key, row in rank["attention"].items():
            impl = key.split("/")[1]
            tol = ((SP_BF16_TOL, SP_BF16_TOL) if impl == "flash"
                   else SP_F32_TOL)
            print(json.dumps({"phase": "sequence_parallel", "rank": r,
                              "attention": key, "tol": tol, **row}),
                  flush=True)
            if row["out"][1] > tol[0] or max(e[1] for e in row["grads"]) \
                    > tol[1]:
                fail(f"sequence_parallel: rank {r} {key} against one rank: "
                     f"{row}")
        for impl, row in rank["first_step"].items():
            loss_err = abs(row["loss"] - row["one_rank_loss"]) / abs(
                row["one_rank_loss"])
            worst = max(row["grad_errors"].items(), key=lambda kv: kv[1])
            print(json.dumps({"phase": "sequence_parallel", "rank": r,
                              "first_step": impl, "loss": row["loss"],
                              "one_rank_loss": row["one_rank_loss"],
                              "loss_rel_err": loss_err,
                              "worst_grad_leaf": worst,
                              "tol": [SP_LOSS_TOL, SP_GRAD_TOL]}),
                  flush=True)
            if loss_err > SP_LOSS_TOL or worst[1] > SP_GRAD_TOL:
                fail(f"sequence_parallel: rank {r} {impl} step 1 against "
                     f"one rank: loss {loss_err}, worst leaf {worst}")
    out["attention"] = [r["attention"] for r in ranks]
    out["first_step"] = [r["first_step"] for r in ranks]

    # (3) the two configs: gates on both ranks' runs
    out["runs"] = {}
    for impl, name in SP_RUNS.items():
        rows = [r["runs"][impl] for r in ranks]
        one = _one_rank_run(torch, dev, name)
        cfg = get_config(name)
        model = get_model(cfg.model, **cfg.model_kwargs)
        target = create_train_state(model, optim.build_optimizer(cfg), 0,
                                    np.zeros((1, 32, 32, 3), np.uint8), dev)
        mgr = CheckpointManager(rows[0]["checkpoint_dir"], async_save=False)
        try:
            restored = mgr.restore(target)
        finally:
            mgr.close()
            shutil.rmtree(rows[0]["checkpoint_dir"], ignore_errors=True)
        want_launches = {k: v * SP_STEPS for k, v in
                         sp_launches(impl).items()}
        want_bytes = sp_bytes(impl, rows[0]["params"])
        rec = {"config": name, "mesh": rows[0]["mesh"],
               "global_batch": SP_BATCH,
               "steps_per_sec": [r["steps_per_sec"] for r in rows],
               "one_rank_steps_per_sec": one["steps_per_sec"],
               "peak_bytes": [r["peak_bytes"] for r in rows],
               "run_peak_bytes": [r["run_peak_bytes"] for r in rows],
               "one_rank_peak_bytes": one["peak_bytes"],
               "one_rank_run_peak_bytes": one["run_peak_bytes"],
               "run_peak_ratio": rows[0]["run_peak_bytes"]
               / one["run_peak_bytes"],
               "losses": rows[0]["losses"],
               "launches": [r["launches"] for r in rows],
               "predicted_launches": want_launches,
               "collectives_per_step": rows[0]["collectives_per_step"],
               "predicted_collectives": want_bytes,
               "restored_step": restored.step_int,
               "restored_equals_final": params_digest(restored.params)
               == rows[0]["digest"],
               "wall_s": [r["wall_s"] for r in rows]}
        out["runs"][impl] = rec
        print(json.dumps({"phase": "sequence_parallel", "run": impl,
                          **rec}), flush=True)
        losses = rec["losses"]
        if len(losses) != SP_STEPS or not (
                np.isfinite(losses).all() and losses[-1] < losses[0]):
            fail(f"sequence_parallel {impl}: losses {losses}")
        if rows[1]["losses"] != losses or rows[1]["digest"] \
                != rows[0]["digest"]:
            fail(f"sequence_parallel {impl}: the ranks' losses or final "
                 "params differ")
        for r, row in enumerate(rows):
            got = {k: v for k, v in row["launches"].items() if v}
            if got != want_launches:
                fail(f"sequence_parallel {impl}: rank {r} launches {got} "
                     f"for {SP_STEPS} steps (want {want_launches})")
            per_step = {k: v for k, v in row["collectives_per_step"].items()
                        if k.startswith("sp_") and v}
            if per_step != want_bytes or any(
                    v for k, v in row["collectives_per_step"].items()
                    if not k.startswith("sp_")):
                fail(f"sequence_parallel {impl}: rank {r} collectives a "
                     f"step {row['collectives_per_step']} (want "
                     f"{want_bytes})")
        if restored.step_int != SP_STEPS or not rec["restored_equals_final"]:
            fail(f"sequence_parallel {impl}: checkpoint restored on one rank "
                 f"at step {restored.step_int}, equal to the final params: "
                 f"{rec['restored_equals_final']}")

    # (4) the remat policies
    remat = [r["remat"] for r in ranks]
    out["remat"] = remat
    print(json.dumps({"phase": "sequence_parallel", "remat": remat}),
          flush=True)
    for r, row in enumerate(remat):
        if len({row[p]["loss"] for p in SP_POLICIES}) != 1:
            fail(f"sequence_parallel: rank {r} remat losses differ: "
                 f"{ {p: row[p]['loss'] for p in SP_POLICIES} }")
    out["wall_s"] = time.perf_counter() - t_phase
    print(json.dumps({"phase": "sequence_parallel",
                      "wall_s": out["wall_s"]}), flush=True)
    return out


#: model parallelism: the two configs, `MP_STEPS` steps each at the
#: 16-chip ladder's 1024 / 4 = 256 a data rank, data cut to 1: expert
#: parallelism on data = 1 x model = 4, the block pipeline on data = 1 x
#: pipe = 4, each through `cli.launch` on four ranks sharing the card
MP_STEPS = 5
MP_BATCH = 256
MP_RANKS = 4
MP_RUNS = {"moe": ("vit_tiny_cifar_moe", "model=4"),
           "pp": ("vit_tiny_cifar_pp", "pipe=4")}
#: ViT-Tiny's widths on the path: dim 192, the MLP's 768, 64 tokens (mean
#: pool: the MoE config) or 65 (CLS: the pipeline config), depth 12, and
#: the pipeline's 8 microbatches
MP_DIM, MP_HIDDEN, MP_DEPTH, MP_MICROBATCHES = 192, 768, 12, 8
#: EP's check at the layer: each rank's MoE output against the dense
#: oracle on its shard, relative to the largest value (bf16 outputs of
#: f32 sums taken in another order: one bf16 ulp); the drop fraction the
#: mean of the shards'
MP_EP_TOL = 1e-2
MP_DROP_TOL = 1e-6
#: the collective matmul in bf16 against `torch.matmul` on the gathered
#: operands, relative to the largest value: the all-gather form sums each
#: output once (one ulp); the reduce-scatter form adds four bf16-rounded
#: partial sums (up to four ulps)
MP_CMM_TOL = {"allgather_matmul": 1e-2, "matmul_reducescatter": 2e-2}
#: the pipeline's first step against the plain stack on one rank:
#: `vit_kernel_vs_plain`'s limits (bf16 sums over microbatches of 32 rows
#: against one of 256)
MP_LOSS_TOL, MP_GRAD_TOL = VIT_PLAIN_TOL, VIT_GRAD_TOL
#: the runs' checkpoints (~64 MB each), kept out of the logs' folder
MP_CKPT = Path(tempfile.gettempdir()) / "dist_mnist_mp_ckpt"


def mp_shapes() -> dict:
    """The path's token counts: a data rank's T = 256 x 64 tokens, each
    model rank's shard of T / 4, and the capacity C of an expert on a
    shard (`parallel/moe.capacity_of`: ceil(4096 / 4) x 1 x 1.25 =
    1,280)."""
    from dist_mnist_tpu_torch.parallel.moe import capacity_of

    t = MP_BATCH * 64
    shard = t // MP_RANKS
    return {"tokens": t, "shard": shard,
            "capacity": capacity_of(shard, MP_RANKS, 1, 1.25)}


def ep_bytes(depth: int = MP_DEPTH) -> dict:
    """The `ep_` collectives a rank and step of `vit_tiny_cifar_moe` on
    data = 1 x model = 4 at batch 256, bf16, remat `dots_no_batch` (the
    forward's collectives run again in the recompute), per MoE layer:
    the dispatch and return all-to-alls of the f32 ``[E, C, D]`` buffer
    in the forward, the recompute and the backward; the bf16 output
    gathered over model (forward, recompute) and the tokens' bf16
    cotangents gathered (backward), each rank's 4,096 x 192; the expert
    stacks' f32 cotangents gathered (each rank's expert: w1, b1, w2, b2);
    the packed routing statistics (3E + 1 f32) all-reduced over model
    (forward, recompute) and the gate's f32 cotangent ``[D, E]`` (the
    backward). Nothing over data (one data rank)."""
    s = mp_shapes()
    e, d, h = MP_RANKS, MP_DIM, MP_HIDDEN
    expert = d * h + h + h * d + d
    return {
        "ep_all_to_all_bytes": depth * 6 * e * s["capacity"] * d * 4,
        "ep_all_to_all_calls": depth * 6,
        "ep_all_gather_bytes": depth * (3 * s["shard"] * d * 2
                                        + expert * 4),
        "ep_all_gather_calls": depth * 4,
        "ep_all_reduce_bytes": depth * (2 * (3 * e + 1) * 4 + d * e * 4),
        "ep_all_reduce_calls": depth * 3}


def pp_bytes(params: int) -> dict:
    """The `pp_` collectives a rank and step of `vit_tiny_cifar_pp` on
    data = 1 x pipe = 4 at batch 256 (8 microbatches of 32), 65 tokens,
    bf16, remat: a microbatch's activation ``[32, 65, 192]`` shifted one
    stage on every tick but the last (M + S - 2 = 10 shifts) in the
    forward, the recompute and the backward; the last stage's ``[8, 32,
    65, 192]`` outputs broadcast (forward, recompute) and their cotangent
    all-reduced once (backward); and the `params` f32 gradients summed
    over the pipe ranks once."""
    act = (MP_BATCH // MP_MICROBATCHES) * 65 * MP_DIM * 2
    shifts = MP_MICROBATCHES + MP_RANKS - 2
    return {"pp_ring_shift_bytes": 3 * shifts * act,
            "pp_ring_shift_calls": 3 * shifts,
            "pp_broadcast_bytes": 2 * MP_MICROBATCHES * act,
            "pp_broadcast_calls": 2,
            "pp_all_reduce_bytes": MP_MICROBATCHES * act + 4 * params,
            "pp_all_reduce_calls": 2}


def _mp_ep_layer(torch, mesh, dev) -> dict:
    """One MoE layer at the path's shape on this rank: seeded tokens
    ``[16384, 192]`` bf16 (the same on every rank) through
    `moe_ffn_adaptive` on data = 1 x model = 4, against `moe_ffn_dense`
    on each of the four token shards."""
    from dist_mnist_tpu_torch.cluster.mesh import activate
    from dist_mnist_tpu_torch.parallel import moe

    s = mp_shapes()
    params = {k: v.to(dev) for k, v in moe.init_moe(
        torch.Generator().manual_seed(180), MP_DIM, MP_HIDDEN,
        MP_RANKS).items()}
    gen = torch.Generator(device=dev).manual_seed(181)
    x = torch.randn(s["tokens"], MP_DIM, generator=gen, device=dev).to(
        torch.bfloat16)
    with activate(mesh), torch.no_grad():
        out, _, stats = moe.moe_ffn_adaptive(params, x)
    with torch.no_grad():
        dense = [moe.moe_ffn_dense(params, x[i * s["shard"]:(i + 1)
                                             * s["shard"]])
                 for i in range(MP_RANKS)]
    torch.cuda.synchronize(dev)
    i = mesh.model_index
    mine = slice(i * s["shard"], (i + 1) * s["shard"])
    return {"out": rel_err(out[mine], dense[i][0]),
            "drop_fraction": float(stats["drop_fraction"]),
            "dense_drop_fractions": [float(d[2]["drop_fraction"])
                                     for d in dense],
            "expert_load": stats["expert_load"].tolist(),
            "ep_engaged": float(stats["ep_engaged"]),
            "capacity": s["capacity"]}


def _mp_collective_matmul(torch, mesh, dev) -> dict:
    """`allgather_matmul` and `matmul_reducescatter` over model = 4 at
    ViT-Tiny's MLP shapes (the mlp_in ``[16384, 192] @ [192, 768]`` and
    mlp_out ``[16384, 768] @ [768, 192]`` products, bf16), against
    `torch.matmul` of the whole operands."""
    from dist_mnist_tpu_torch.parallel.collective_matmul import (
        allgather_matmul,
        matmul_reducescatter,
    )

    n, i = mesh.model, mesh.model_index
    gen = torch.Generator(device=dev).manual_seed(182)
    t = mp_shapes()["tokens"]

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(
            torch.bfloat16)

    x, w = rand(t, MP_DIM), rand(MP_DIM, MP_HIDDEN) / MP_DIM ** 0.5
    rows, cols = t // n, MP_HIDDEN // n
    got = allgather_matmul(x[i * rows:(i + 1) * rows],
                           w[:, i * cols:(i + 1) * cols], mesh)
    want = torch.matmul(x, w)[:, i * cols:(i + 1) * cols]
    x2, w2 = rand(t, MP_HIDDEN), rand(MP_HIDDEN, MP_DIM) / MP_HIDDEN ** 0.5
    k = MP_HIDDEN // n
    got2 = matmul_reducescatter(x2[:, i * k:(i + 1) * k],
                                w2[i * k:(i + 1) * k], mesh)
    want2 = torch.matmul(x2, w2)[i * rows:(i + 1) * rows]
    torch.cuda.synchronize(dev)
    return {"allgather_matmul": rel_err(got, want),
            "matmul_reducescatter": rel_err(got2, want2)}


def _mp_pp_first_step(torch, mesh, dev) -> dict:
    """`vit_tiny_cifar_pp` at full width: one remat forward and backward
    of a seeded batch of 256 with seeded dropout masks through the
    pipeline on data = 1 x pipe = 4 (the gradients summed over pipe, the
    step's rule), against the plain stacked blocks on this one rank on
    the same params, batch and masks."""
    from dist_mnist_tpu_torch import optim
    from dist_mnist_tpu_torch.cluster.mesh import activate
    from dist_mnist_tpu_torch.configs import get_config
    from dist_mnist_tpu_torch.models.registry import get_model
    from dist_mnist_tpu_torch.ops import losses
    from dist_mnist_tpu_torch.parallel.collectives import sum_over_axis
    from dist_mnist_tpu_torch.train import create_train_state
    from dist_mnist_tpu_torch.train.step import loss_and_grads
    from dist_mnist_tpu_torch.utils.tree import flatten_with_path

    cfg = get_config("vit_tiny_cifar_pp")
    model = get_model(cfg.model, **cfg.model_kwargs)
    state = create_train_state(model, optim.build_optimizer(cfg), 0,
                               np.zeros((1, 32, 32, 3), np.uint8), dev)
    gen = torch.Generator().manual_seed(183)
    batch = {"image": torch.randint(0, 256, (MP_BATCH, 32, 32, 3),
                                    generator=gen, dtype=torch.uint8
                                    ).to(dev),
             "label": torch.randint(0, 10, (MP_BATCH,), generator=gen,
                                    dtype=torch.int32).to(dev)}
    mask = model.dropout_masks(torch.Generator(device=dev).manual_seed(184),
                               batch["image"])
    kw = dict(dropout_mask=mask, remat=True)
    with activate(mesh):
        loss, _, _, grads = loss_and_grads(
            model, losses.softmax_cross_entropy, state.params, {}, batch,
            **kw)
    grads = sum_over_axis(grads, mesh, "pipe")
    one_loss, _, _, one_grads = loss_and_grads(
        model, losses.softmax_cross_entropy, state.params, {}, batch, **kw)
    torch.cuda.synchronize(dev)

    def flat(tree):
        return {"/".join(map(str, p)): t.float()
                for p, t in flatten_with_path(tree)}

    return {"loss": float(loss), "one_rank_loss": float(one_loss),
            "grad_errors": grad_errors(flat(grads), flat(one_grads))}


def _mp_rank(rank: int, world: int, store: str, out_path: str) -> None:
    """One rank of `model_parallel`'s four-rank group on the card: the MoE
    layer and the collective matmul on data = 1 x model = 4, then the
    pipeline's first step on data = 1 x pipe = 4. Writes its record (or
    its traceback) to `out_path`."""
    import pickle
    import traceback

    import torch

    sys.path.insert(0, str(ROOT))
    from dist_mnist_tpu_torch.cluster import coordination
    from dist_mnist_tpu_torch.cluster.mesh import MeshSpec, make_mesh

    out: dict = {}
    try:
        coordination.initialize_distributed(
            num_processes=world, process_id=rank,
            init_method=f"file://{store}", timeout_s=300)
        mesh = make_mesh(MeshSpec(data=1, model=world))
        dev = mesh.device
        out["startup"] = coordination.startup_line(coordination.context())
        t0 = time.perf_counter()
        out["ep_layer"] = _mp_ep_layer(torch, mesh, dev)
        out["cmm"] = _mp_collective_matmul(torch, mesh, dev)
        out["pp_first_step"] = _mp_pp_first_step(
            torch, make_mesh(MeshSpec(data=1, pipe=world)), dev)
        out["wall_s"] = time.perf_counter() - t0
        result = {"ok": out}
    except BaseException:  # noqa: BLE001 — handed to the parent
        result = {"error": traceback.format_exc()}
    finally:
        coordination.shutdown()
    with open(out_path, "wb") as fh:
        pickle.dump(result, fh)


def _mp_one_rank(torch, dev, name: str) -> dict:
    """`name` through `run_config` on one rank at the same batch (the MoE
    layers all experts local, the blocks the plain stack): steps/s and
    the run's own peak allocated bytes."""
    import dataclasses

    from dist_mnist_tpu_torch.cli.train import run_config
    from dist_mnist_tpu_torch.cluster.mesh import MeshSpec
    from dist_mnist_tpu_torch.configs import get_config
    from dist_mnist_tpu_torch.hooks import Hook

    marks = []

    class Mark(Hook):
        def after_step(self, step, state, outputs):
            marks.append((step, time.perf_counter()))

    cfg = dataclasses.replace(get_config(name), batch_size=MP_BATCH,
                              train_steps=MP_STEPS, eval_every=0,
                              log_every=MP_STEPS, mesh=MeshSpec(data=1))
    (_, _, ctx), peak, own = _peak(torch, dev, lambda: run_config(
        cfg, device=dev, extra_hooks=[Mark()]))
    (s0, t0), (s1, t1) = marks[0], marks[-1]
    return {"steps_per_sec": (s1 - s0) / max(t1 - t0, 1e-9),
            "peak_bytes": peak, "run_peak_bytes": own,
            "launches": ctx["launches"]}


def _hist_lines(output: str, key: str) -> list[str]:
    """The chief's `SummaryHook` histogram lines of `key`, one a step."""
    return [line.split("[hist] ", 1)[1] for line in output.splitlines()
            if line.startswith("[p0] ") and "[hist] " in line
            and f" {key}:" in line]


def model_parallel(torch, dev) -> dict:
    """Phase `model_parallel`: (1) four spawned ranks on the card (gloo):
    one MoE layer at the path's shape (16,384 tokens of 192, 4 experts of
    768, capacity 1,280 a shard) through `moe_ffn_adaptive` on data = 1 x
    model = 4, each rank's output within `MP_EP_TOL` of `moe_ffn_dense`
    on its shard, the drop fraction the shards' mean, ep_engaged 1; the
    collective matmul at the MLP's shapes within `MP_CMM_TOL` of
    `torch.matmul`; the pipeline's first step of `vit_tiny_cifar_pp` at
    batch 256 within `MP_LOSS_TOL` / `MP_GRAD_TOL` of the plain stack on
    one rank; (2) `vit_tiny_cifar_moe` (model = 4) and `vit_tiny_cifar_pp`
    (pipe = 4) through `cli.launch` on four ranks, `MP_STEPS` steps at
    batch 256 with a checkpoint at the last, the launch counters set to 0
    just before each rank's loop and read just after: finite falling
    losses, the same on every rank, the same final params, every kernel
    counter 0, the `ep_` / `pp_` collectives a step exactly `ep_bytes` /
    `pp_bytes` and nothing else, ep_engaged 1 at every step, the chief's
    checkpoint restored on one rank bit for bit; the drop fraction and
    expert load a step, steps/s and peak allocated bytes a rank against
    one rank at the same batch. Returns the phase's record."""
    from dist_mnist_tpu_torch import optim
    from dist_mnist_tpu_torch.checkpoint import CheckpointManager
    from dist_mnist_tpu_torch.configs import get_config
    from dist_mnist_tpu_torch.models.registry import get_model
    from dist_mnist_tpu_torch.train import create_train_state
    from dist_mnist_tpu_torch.train.state import params_digest
    from dist_mnist_tpu_torch.utils.tree import leaves

    t_phase = time.perf_counter()
    out = {"phase": "model_parallel"}
    ranks = _rank_group(_mp_rank, "mp", world=MP_RANKS)
    out["group_wall_s"] = time.perf_counter() - t_phase
    for r, rank in enumerate(ranks):
        if "backend gloo (ranks share a card)" not in rank["startup"]:
            fail(f"model_parallel: rank {r} startup {rank['startup']!r}")
        ep = rank["ep_layer"]
        mean_drop = float(np.mean(ep["dense_drop_fractions"]))
        print(json.dumps({"phase": "model_parallel", "rank": r,
                          "ep_layer": ep, "tol": MP_EP_TOL,
                          "dense_mean_drop_fraction": mean_drop}),
              flush=True)
        if ep["out"][1] > MP_EP_TOL or ep["ep_engaged"] != 1.0 \
                or abs(ep["drop_fraction"] - mean_drop) > MP_DROP_TOL \
                or ep["capacity"] != mp_shapes()["capacity"]:
            fail(f"model_parallel: rank {r} EP layer against the dense "
                 f"oracle on its shard: {ep} (mean drop {mean_drop})")
        print(json.dumps({"phase": "model_parallel", "rank": r,
                          "collective_matmul": rank["cmm"],
                          "tol": MP_CMM_TOL}), flush=True)
        for name, err in rank["cmm"].items():
            if err[1] > MP_CMM_TOL[name]:
                fail(f"model_parallel: rank {r} {name} against "
                     f"torch.matmul: {err}")
        row = rank["pp_first_step"]
        loss_err = abs(row["loss"] - row["one_rank_loss"]) / abs(
            row["one_rank_loss"])
        worst = max(row["grad_errors"].items(), key=lambda kv: kv[1])
        print(json.dumps({"phase": "model_parallel", "rank": r,
                          "pp_first_step": {
                              "loss": row["loss"],
                              "one_rank_loss": row["one_rank_loss"],
                              "loss_rel_err": loss_err,
                              "worst_grad_leaf": worst},
                          "tol": [MP_LOSS_TOL, MP_GRAD_TOL]}), flush=True)
        if loss_err > MP_LOSS_TOL or worst[1] > MP_GRAD_TOL:
            fail(f"model_parallel: rank {r} pipeline step 1 against the "
                 f"plain stack: loss {loss_err}, worst leaf {worst}")
    out["group"] = ranks

    # (2) the two configs through cli.launch
    out["runs"] = {}
    for tag, (name, axis) in MP_RUNS.items():
        ckpt = MP_CKPT / tag
        shutil.rmtree(ckpt, ignore_errors=True)
        rows = _launch_ranks(
            [f"--config={name}", f"--mesh={axis}",
             f"--batch_size={MP_BATCH}", f"--train_steps={MP_STEPS}",
             "--eval_every=0", "--log_every=1", f"--checkpoint_dir={ckpt}",
             f"--checkpoint_every_steps={MP_STEPS}"], f"mp_{tag}",
            timeout=420, n=MP_RANKS,
            extra=("peak allocated bytes: ",))
        output = (ROOT / "chiprun_out" / f"launch_mp_{tag}.log").read_text()
        one = _mp_one_rank(torch, dev, name)
        cfg = get_config(name)
        model = get_model(cfg.model, **cfg.model_kwargs)
        target = create_train_state(model, optim.build_optimizer(cfg), 0,
                                    np.zeros((1, 32, 32, 3), np.uint8), dev)
        n_params = sum(t.numel() for t in leaves(target.params))
        mgr = CheckpointManager(ckpt, async_save=False)
        try:
            restored = mgr.restore(target)
        finally:
            mgr.close()
            shutil.rmtree(ckpt, ignore_errors=True)
        want = ep_bytes() if tag == "moe" else pp_bytes(n_params)
        per_step = rows[0]["collectives_per_step"]
        metrics = {
            "moe_drop_fraction": [
                float(s.split("moe_drop_fraction=")[1].split(",")[0])
                for s in _rank_lines(output, 0, "INFO: step ")
                if "moe_drop_fraction=" in s],
            "moe_ep_engaged": [
                float(s.split("moe_ep_engaged=")[1].split(",")[0])
                for s in _rank_lines(output, 0, "INFO: step ")
                if "moe_ep_engaged=" in s],
            "moe_expert_load": _hist_lines(output, "moe_expert_load")}
        rank_peaks = [int(r["peak allocated bytes: "]) for r in rows]
        rec = {"config": name, "mesh": axis, "global_batch": MP_BATCH,
               "steps_per_sec": [r["steps_per_sec"] for r in rows],
               "one_rank_steps_per_sec": one["steps_per_sec"],
               "peak_bytes": rank_peaks,
               "one_rank_run_peak_bytes": one["run_peak_bytes"],
               "peak_ratio": rank_peaks[0] / one["run_peak_bytes"],
               "losses": rows[0]["losses"],
               "launches": [r["launches"] for r in rows],
               "one_rank_launches": one["launches"],
               "collectives_per_step": per_step,
               "predicted_collectives": want,
               "restored_step": restored.step_int,
               "restored_equals_final": params_digest(restored.params)
               == rows[0]["digest"],
               "wall_s": rows[0]["wall_s"], **({"per_step": metrics}
                                               if tag == "moe" else {})}
        out["runs"][tag] = rec
        print(json.dumps({"phase": "model_parallel", "run": tag, **rec}),
              flush=True)
        losses = list(rec["losses"].values())
        if len(losses) != MP_STEPS or not (
                np.isfinite(losses).all() and losses[-1] < losses[0]):
            fail(f"model_parallel {tag}: losses {rec['losses']}")
        for key in ("digest", "losses"):
            if len({json.dumps(r[key], sort_keys=True) for r in rows}) != 1:
                fail(f"model_parallel {tag}: the ranks' {key!r} differ")
        for r, row in enumerate(rows):
            if "backend gloo (ranks share a card)" not in row["startup"]:
                fail(f"model_parallel {tag}: rank {r} startup "
                     f"{row['startup']!r}")
            if any(row["launches"].values()):
                fail(f"model_parallel {tag}: rank {r} launched kernels "
                     f"{row['launches']} (the path runs none)")
            got = {k: v for k, v in row["collectives_per_step"].items()
                   if v}
            if got != want:
                fail(f"model_parallel {tag}: rank {r} collectives a step "
                     f"{got} (want {want})")
        if tag == "moe" and (metrics["moe_ep_engaged"] != [1.0] * MP_STEPS
                             or len(metrics["moe_drop_fraction"])
                             != MP_STEPS):
            fail(f"model_parallel moe: per-step metrics {metrics}")
        if restored.step_int != MP_STEPS \
                or not rec["restored_equals_final"]:
            fail(f"model_parallel {tag}: checkpoint restored on one rank at "
                 f"step {restored.step_int}, equal to the final params: "
                 f"{rec['restored_equals_final']}")
    out["wall_s"] = time.perf_counter() - t_phase
    print(json.dumps({"phase": "model_parallel", "wall_s": out["wall_s"]}),
          flush=True)
    return out


#: the `native` phase: LeNet-5 steps through `cli.train` on each input
#: path, the checkpoint cadence and the step at which the recovery run is
#: preempted, and the steps of the two-rank slice check
NATIVE_STEPS, NATIVE_EVERY, NATIVE_PREEMPT_AT = 200, 100, 130
NATIVE_SLICE_STEPS = 5
#: the parameter-server demo on the card: workers, steps, and the
#: reference test's accuracy floors
PS_WORKERS, PS_STEPS = 2, 200
PS_FLOORS = {"sync": 0.8, "async": 0.6}
#: `multislice`: lenet5_fashion's steps at data = 4 over two fake slices;
#: vit_tiny_cifar_pp's steps and batch a data rank at data 2 x pipe 4 over
#: four, and its loss limit against the row-major mesh
MS_FASHION_STEPS = 5
MS_PP_STEPS, MS_PP_BATCH = 2, 64
MS_PP_TOL = 1e-2
#: a small CIFAR-10 twin (2,048 train / 256 test images) for the runs
#: that evaluate or train a ViT a few steps in these phases
SMALL_CIFAR = Path(tempfile.gettempdir()) / "dist_mnist_small_cifar"
#: `zoo_sharded`: the tp serve's traffic, the fsdp_tp serve's, the
#: cross-strategy restore's logit limit, and the rules' share of a
#: replicated rank's bytes under FSDP x TP (PR 15's measured state share)
ZS_REQUESTS, ZS_CONCURRENCY = 64, 32
ZS_FSDP_TP_REQUESTS = 64
ZS_RESTORE_TOL = 2e-4
ZS_FSDP_TP_SHARE, ZS_SHARE_TOL = 0.25178, 0.02
ZS_CKPT = Path(tempfile.gettempdir()) / "dist_mnist_zs_ckpt"


def _small_cifar() -> str:
    """`SMALL_CIFAR`, written once."""
    from dist_mnist_tpu_torch.data import datasets

    if not (SMALL_CIFAR / "cifar10_synth.npz").exists():
        datasets._write_synth_cache(SMALL_CIFAR, "cifar10", datasets._synth(
            "cifar10", 2048, 256, 0))
    return str(SMALL_CIFAR)


def _rank_init(torch, rank: int, world: int, store: str):
    """Join the group of a spawned rank on the card, with cuDNN
    deterministic and TF32 off (bitwise comparisons across processes)."""
    sys.path.insert(0, str(ROOT))
    from dist_mnist_tpu_torch.cluster import coordination

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    coordination.initialize_distributed(
        num_processes=world, process_id=rank,
        init_method=f"file://{store}", timeout_s=300)
    return coordination


def _run_rank_body(body, rank: int, world: int, store: str,
                   out_path: str) -> None:
    """`body(torch, coordination)` on a spawned rank; its record (or its
    traceback) pickled to `out_path`."""
    import pickle
    import traceback

    import torch

    coordination = None
    try:
        coordination = _rank_init(torch, rank, world, store)
        out = body(torch, coordination)
        out["startup"] = coordination.startup_line(coordination.context())
        result = {"ok": out}
    except BaseException:  # noqa: BLE001 — handed to the parent
        result = {"error": traceback.format_exc()}
    finally:
        if coordination is not None:
            coordination.shutdown()
    with open(out_path, "wb") as fh:
        pickle.dump(result, fh)


def _native_rank(rank: int, world: int, store: str, out_path: str) -> None:
    """One rank of `native`'s two-rank group: its slices of the first
    `NATIVE_SLICE_STEPS` batches of LeNet-5's native stream at data = 2."""
    def body(torch, coordination):
        from dist_mnist_tpu_torch.cluster.mesh import MeshSpec, make_mesh
        from dist_mnist_tpu_torch.configs import get_config
        from dist_mnist_tpu_torch.data.datasets import load_dataset
        from dist_mnist_tpu_torch.data.native import NativeBatcher

        cfg = get_config("lenet5_mnist")
        mesh = make_mesh(MeshSpec(data=world))
        nb = NativeBatcher(load_dataset(cfg.dataset, seed=cfg.seed),
                           cfg.batch_size, mesh, seed=cfg.seed)
        try:
            rows = [nb.next_local() for _ in range(NATIVE_SLICE_STEPS)]
        finally:
            nb.close()
        return {"data": mesh.rank, "rows": rows}

    _run_rank_body(body, rank, world, store, out_path)


def native(torch, dev) -> dict:
    """Phase `native`: (1) both C++ libraries built from the port's
    sources with g++ (`build/torch_native/`); (2) `lenet5_mnist` through
    `cli.train`'s `run_config` for `NATIVE_STEPS` steps with
    `--input_pipeline=native`, then `python` (prefetch depth 2, the CLI's
    default): steps/s and the loop's feed wait, figures and no gate; (3)
    the native run preempted at step `NATIVE_PREEMPT_AT` and recovered
    from its step-`NATIVE_EVERY` checkpoint through the batcher's
    `at_step`: its params and optimizer state the straight run's bit for
    bit (cuDNN deterministic); (4) two spawned ranks at data = 2: their
    rows of each of `NATIVE_SLICE_STEPS` global batches, joined, the
    one-rank stream's rows; (5) `run_demo` sync and async on the card
    (`PS_WORKERS` workers, `PS_STEPS` steps, the synthetic MNIST twin):
    test accuracy above `PS_FLOORS`, with steps/s, stale drops and
    per-worker applies. Returns the phase's record."""
    from torch.backends import cudnn

    from dist_mnist_tpu_torch.cli.train import run_config
    from dist_mnist_tpu_torch.configs import get_config
    from dist_mnist_tpu_torch.data.datasets import load_dataset
    from dist_mnist_tpu_torch.data.native import NativeBatcher, build_library
    from dist_mnist_tpu_torch.hooks import Hook
    from dist_mnist_tpu_torch.parallel.ps_demo import build_library as build_ps
    from dist_mnist_tpu_torch.parallel.ps_demo import run_demo
    from dist_mnist_tpu_torch.train.loop import PreemptionError
    from dist_mnist_tpu_torch.utils.tree import flatten_with_path

    t_phase = time.perf_counter()
    out = {"phase": "native"}
    t0 = time.perf_counter()
    libs = {"loader": build_library(force=True),
            "ps_server": build_ps(force=True)}
    out["build_s"] = time.perf_counter() - t0
    out["libraries"] = {k: str(v.relative_to(ROOT)) for k, v in libs.items()}
    print(json.dumps(out), flush=True)

    class Mark(Hook):
        def __init__(self):
            self.marks = []

        def after_step(self, step, state, outputs):
            self.marks.append((step, time.perf_counter()))

    class PreemptOnce(Hook):
        def __init__(self, at):
            self.at, self.fired = at, False

        def after_step(self, step, state, outputs):
            if step == self.at and not self.fired:
                self.fired = True
                raise PreemptionError(f"injected at step {step}")

    cfg = get_config("lenet5_mnist", train_steps=NATIVE_STEPS, eval_every=0,
                     log_every=NATIVE_STEPS)
    prev = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        runs, states = {}, {}
        for pipeline in ("native", "python"):
            mark = Mark()
            state, _, ctx = run_config(cfg, device=dev,
                                       input_pipeline=pipeline,
                                       prefetch_depth=2, extra_hooks=[mark])
            torch.cuda.synchronize()
            (s0, t0), (s1, t1) = mark.marks[0], mark.marks[-1]
            runs[pipeline] = {
                "steps_per_sec": (s1 - s0) / max(t1 - t0, 1e-9),
                "feed_wait_s": ctx["loop"].feed_wait_s,
                "prefetch": ctx["prefetch"], "elapsed_s": ctx["elapsed"],
                "batcher": type(getattr(ctx["loop"].batches, "inner",
                                        ctx["loop"].batches)).__name__}
            states[pipeline] = state
        ckpt = Path(tempfile.gettempdir()) / "dist_mnist_native_ckpt"
        shutil.rmtree(ckpt, ignore_errors=True)
        hook = PreemptOnce(NATIVE_PREEMPT_AT)
        recovered, _, ctx = run_config(
            cfg, device=dev, input_pipeline="native", prefetch_depth=2,
            checkpoint_dir=str(ckpt), checkpoint_every_steps=NATIVE_EVERY,
            max_recoveries=1, extra_hooks=[hook])
        shutil.rmtree(ckpt, ignore_errors=True)
    finally:
        cudnn.deterministic, cudnn.benchmark = prev
    straight = states["native"]
    same = all(torch.equal(x, y) for tree in ("params", "opt_state")
               for (_, x), (_, y) in zip(
                   flatten_with_path(getattr(recovered, tree)),
                   flatten_with_path(getattr(straight, tree))))
    out.update(runs=runs, recovery={
        "preempted_at": NATIVE_PREEMPT_AT, "fired": hook.fired,
        "recoveries": ctx["loop"].goodput.snapshot()["recoveries"],
        "step": recovered.step_int, "bitwise_equal_to_straight": same})
    print(json.dumps({"phase": "native", "runs": runs,
                      "recovery": out["recovery"]}), flush=True)
    if runs["native"]["batcher"] != "NativeBatcher":
        fail(f"native: the native run's batches came from "
             f"{runs['native']['batcher']}")
    if not (hook.fired and same and recovered.step_int == NATIVE_STEPS):
        fail(f"native: the recovered run {out['recovery']} is not the "
             "straight run bit for bit")

    ranks = _rank_group(_native_rank, "native", world=2, timeout=240)
    one = NativeBatcher(load_dataset(cfg.dataset, seed=cfg.seed),
                        cfg.batch_size, None, seed=cfg.seed)
    try:
        whole = [one.next_local() for _ in range(NATIVE_SLICE_STEPS)]
    finally:
        one.close()
    by_data = {r["data"]: r["rows"] for r in ranks}
    joined = all(
        np.array_equal(np.concatenate([by_data[0][i][0], by_data[1][i][0]]),
                       img)
        and np.array_equal(np.concatenate([by_data[0][i][1],
                                           by_data[1][i][1]]), lab)
        and by_data[0][i][2] == by_data[1][i][2] == step
        for i, (img, lab, step) in enumerate(whole))
    out["two_ranks"] = {"startup": [r["startup"] for r in ranks],
                        "rows_per_rank": int(by_data[0][0][1].shape[0]),
                        "joined_equals_one_rank": joined}
    print(json.dumps({"phase": "native", "two_ranks": out["two_ranks"]}),
          flush=True)
    if not joined or sorted(by_data) != [0, 1]:
        fail("native: the two data ranks' rows, joined, are not the "
             "one-rank stream's")

    out["ps_demo"] = {}
    for mode in ("sync", "async"):
        rec = run_demo(mode=mode, num_workers=PS_WORKERS,
                       train_steps=PS_STEPS, device=dev)
        out["ps_demo"][mode] = rec
        print(json.dumps({"phase": "native", "ps_demo": rec,
                          "floor": PS_FLOORS[mode]}), flush=True)
        if rec["test_accuracy"] <= PS_FLOORS[mode] \
                or rec["global_step"] < PS_STEPS:
            fail(f"native: ps demo {mode} {rec} (floor {PS_FLOORS[mode]})")
    out["wall_s"] = time.perf_counter() - t_phase
    print(json.dumps({"phase": "native", "wall_s": out["wall_s"]}),
          flush=True)
    return out


def ms_expected_grid(shape: tuple, n_slices: int) -> np.ndarray:
    """The rank at each (d, m, s, p) that `mesh_utils.
    create_hybrid_device_mesh` gives over `n_slices` contiguous blocks of
    ranks, from `hybrid_mesh_shapes`' ICI and DCN shapes: a coordinate's
    slice is its DCN block in row-major order, its place in the slice its
    row-major ICI offset (written here apart from the port's layout)."""
    from dist_mnist_tpu_torch.cluster.mesh import hybrid_mesh_shapes

    ici, dcn = hybrid_mesh_shapes(shape, n_slices)
    grid = np.empty(shape, dtype=np.int64)
    per = int(np.prod(ici))
    for idx in np.ndindex(*shape):
        outer = [i // c for i, c in zip(idx, ici)]
        inner = [i % c for i, c in zip(idx, ici)]
        grid[idx] = (np.ravel_multi_index(outer, dcn) * per
                     + np.ravel_multi_index(inner, ici))
    return grid


def _ms_layout(torch, mesh) -> dict:
    """This rank's coordinates and each wide axis's group ranks."""
    from dist_mnist_tpu_torch.cluster.mesh import AXES

    return {"coords": [mesh.rank, mesh.model_index, mesh.seq_index,
                       mesh.pipe_index],
            "groups": {axis: torch.distributed.get_process_group_ranks(
                mesh.axis_group(axis)) for axis in AXES
                if mesh.axis_group(axis) is not None}}


def _ms_rank(rank: int, world: int, store: str, out_path: str) -> None:
    """One rank of `multislice`'s groups: on four ranks `lenet5_fashion`
    at data = 4, on eight `vit_tiny_cifar_pp` at data 2 x pipe 4, each
    through `run_config` on the fake-slice mesh and on the row-major one:
    the losses a step, the final params digest, the sliced mesh's layout
    and steps/s."""
    def body(torch, coordination):
        import dataclasses

        from dist_mnist_tpu_torch.cli.train import run_config
        from dist_mnist_tpu_torch.cluster.mesh import (
            MeshSpec,
            make_mesh,
            with_fake_slices,
        )
        from dist_mnist_tpu_torch.configs import get_config
        from dist_mnist_tpu_torch.hooks import Hook
        from dist_mnist_tpu_torch.parallel.sharding import unshard_state
        from dist_mnist_tpu_torch.train.state import params_digest

        class Mark(Hook):
            def __init__(self):
                self.marks = []

            def after_step(self, step, state, outputs):
                self.marks.append((step, float(outputs["loss"]),
                                   time.perf_counter()))

        if world == 4:
            spec, slices = MeshSpec(data=4), 2
            cfg = get_config("lenet5_fashion", train_steps=MS_FASHION_STEPS,
                             eval_every=0, log_every=MS_FASHION_STEPS)
            data_dir = None
        else:
            spec, slices = MeshSpec(data=2, pipe=4), 4
            cfg = dataclasses.replace(
                get_config("vit_tiny_cifar_pp"), train_steps=MS_PP_STEPS,
                batch_size=2 * MS_PP_BATCH, eval_every=0,
                log_every=MS_PP_STEPS, mesh=spec)
            data_dir = str(SMALL_CIFAR)
        out = {}
        for layout in ("sliced", "row_major"):
            tags = (with_fake_slices(range(world), slices)
                    if layout == "sliced" else None)
            mesh = make_mesh(spec, slices=tags)
            mark = Mark()
            state, _, _ = run_config(cfg, device=mesh.device, mesh=mesh,
                                     data_dir=data_dir, extra_hooks=[mark])
            (s0, _, t0), (s1, _, t1) = mark.marks[0], mark.marks[-1]
            out[layout] = {
                "losses": [loss for _, loss, _ in mark.marks],
                "digest": params_digest(unshard_state(state).params),
                "grid": mesh.grid.tolist(), **_ms_layout(torch, mesh),
                "steps_per_sec": (s1 - s0) / max(t1 - t0, 1e-9)}
        return out

    _run_rank_body(body, rank, world, store, out_path)


def _ms_check(ranks: list, shape: tuple, n_slices: int, tag: str) -> dict:
    """Gate each rank's coordinates and axis groups on the sliced mesh
    against `ms_expected_grid`; the grid's record."""
    from dist_mnist_tpu_torch.cluster.mesh import AXES

    want = ms_expected_grid(shape, n_slices)
    for r, rank in enumerate(ranks):
        got = rank["sliced"]
        d, m, s, p = got["coords"]
        coords = tuple(int(i) for i in np.argwhere(want == r)[0])
        groups = {}
        for i, axis in enumerate(AXES):
            if shape[i] > 1:
                line = list(coords)
                members = []
                for k in range(shape[i]):
                    line[i] = k
                    members.append(int(want[tuple(line)]))
                groups[axis] = sorted(members)
        if (d, m, s, p) != coords or got["groups"] != groups \
                or np.asarray(got["grid"]).tolist() != want.tolist():
            fail(f"multislice {tag}: rank {r} at {(d, m, s, p)} with groups "
                 f"{got['groups']} (want {coords}, {groups})")
    row_major = np.arange(want.size).reshape(shape)
    return {"grid": want.reshape(shape[0], -1).tolist(),
            "layouts_coincide": bool(np.array_equal(want, row_major))}


def multislice(torch, dev) -> dict:
    """Phase `multislice`: gloo ranks sharing the card, `make_mesh(...,
    slices=with_fake_slices(...))`. (1) four ranks, `lenet5_fashion` at
    data = 4 over two fake slices (the DCN factor on data) for
    `MS_FASHION_STEPS` steps: each rank's coordinates and groups the
    hybrid layout's, and losses and final params the row-major mesh's bit
    for bit (the two layouts coincide here; printed); (2) eight ranks,
    `vit_tiny_cifar_pp` at full width, data 2 x pipe 4 over four fake
    slices (slice k = pipe k, not row-major), `MS_PP_STEPS` steps at
    `MS_PP_BATCH` a data rank on a small CIFAR-10 twin: the layout gated
    as in (1), the losses within `MS_PP_TOL` of the row-major mesh's.
    Returns the phase's record."""
    t_phase = time.perf_counter()
    out = {"phase": "multislice"}
    four = _rank_group(_ms_rank, "ms", world=4, timeout=300)
    out["fashion"] = _ms_check(four, (4, 1, 1, 1), 2, "fashion")
    same = all(r["sliced"]["losses"] == r["row_major"]["losses"]
               and r["sliced"]["digest"] == r["row_major"]["digest"]
               for r in four) and len({r["sliced"]["digest"]
                                       for r in four}) == 1
    out["fashion"].update(
        losses=four[0]["sliced"]["losses"], bitwise_equal_to_row_major=same,
        steps_per_sec=[r["sliced"]["steps_per_sec"] for r in four],
        row_major_steps_per_sec=[r["row_major"]["steps_per_sec"]
                                 for r in four],
        wall_s=time.perf_counter() - t_phase)
    print(json.dumps({"phase": "multislice", "fashion": out["fashion"]}),
          flush=True)
    if not same or len(four[0]["sliced"]["losses"]) != MS_FASHION_STEPS:
        fail(f"multislice fashion: the sliced mesh's run is not the "
             f"row-major one's bit for bit: {out['fashion']}")
    _small_cifar()
    t0 = time.perf_counter()
    eight = _rank_group(_ms_rank, "ms8", world=8, timeout=420)
    out["pp"] = _ms_check(eight, (2, 1, 1, 4), 4, "pp")
    got, want = eight[0]["sliced"]["losses"], eight[0]["row_major"]["losses"]
    errs = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    out["pp"].update(
        losses=got, row_major_losses=want, loss_rel_err=errs, tol=MS_PP_TOL,
        steps_per_sec=[r["sliced"]["steps_per_sec"] for r in eight],
        row_major_steps_per_sec=[r["row_major"]["steps_per_sec"]
                                 for r in eight],
        wall_s=time.perf_counter() - t0)
    print(json.dumps({"phase": "multislice", "pp": out["pp"]}), flush=True)
    if out["pp"]["layouts_coincide"]:
        fail("multislice pp: the hybrid layout should differ from row-major")
    if len(got) != MS_PP_STEPS or not np.isfinite(got).all() \
            or max(errs) > MS_PP_TOL \
            or len({json.dumps(r["sliced"]["losses"]) for r in eight}) != 1:
        fail(f"multislice pp: losses {got} against row-major {want} "
             f"(limit {MS_PP_TOL}), or the ranks' losses differ")
    out["wall_s"] = time.perf_counter() - t_phase
    print(json.dumps({"phase": "multislice", "wall_s": out["wall_s"]}),
          flush=True)
    return out


def _zs_fixed_native(seed: int = 12) -> list:
    """Two fixed batches of 32 native-height CIFAR images."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(32, 32, 32, 3), dtype=np.uint8)
            for _ in range(2)]


def _zs_f32_config(name: str):
    import dataclasses

    import torch

    from dist_mnist_tpu_torch.configs import get_config

    cfg = get_config(name)
    return dataclasses.replace(cfg, model_kwargs={
        **cfg.model_kwargs, "compute_dtype": torch.float32})


def _zs_rank(rank: int, world: int, store: str, out_path: str) -> None:
    """One rank of `zoo_sharded`'s groups, through `cli.serve`'s
    classifier mode (`serve_classifier`, what `cli.serve --mesh` runs on
    each rank): on two ranks `vit_tiny_cifar_flash` under
    `--serve_rules=tp` with the zoo grid and the mixed-height loadgen
    (launch counters zeroed just before, read just after), then the fixed
    zoo batches through the same placement; on four
    `vit_tiny_cifar_fsdp_tp` over data 2 x model 2, then the `dp`
    checkpoint restored under fsdp_tp (f32 compute) and the fixed native
    batches."""
    def body(torch, coordination):
        from dist_mnist_tpu_torch.cli import serve as serve_cli
        from dist_mnist_tpu_torch.cluster.mesh import MeshSpec, make_mesh
        from dist_mnist_tpu_torch.ops.kernels import (
            launch_counts,
            reset_launch_counts,
        )
        from dist_mnist_tpu_torch.serve import (
            build_zoo_engine,
            load_for_serving,
            run_longctx_loadgen,
        )

        out = {}
        if world == 2:
            mesh = make_mesh(MeshSpec(data=1, model=2))
            args = serve_cli.build_parser().parse_args([
                "--config=vit_tiny_cifar_flash", "--serve_rules=tp",
                "--seq_buckets=auto", "--max_batch=32",
                f"--requests={ZS_REQUESTS}",
                f"--concurrency={ZS_CONCURRENCY}"])
            reset_launch_counts()
            out["summary"] = serve_cli.serve_classifier(
                args, mesh.device, mesh, loadgen=run_longctx_loadgen)
            torch.cuda.synchronize()
            out["launches"] = launch_counts()
            bundle = load_for_serving("vit_tiny_cifar_flash", mesh.device,
                                      mesh=mesh, sharding_rules="tp")
            engine = build_zoo_engine(bundle, mesh.device,
                                      model_name="vit_tiny", max_bucket=32,
                                      seq_buckets="auto")
            batches = zoo_fixed_batches(engine.seq_grid)
        else:
            mesh = make_mesh(MeshSpec(data=2, model=2))
            args = serve_cli.build_parser().parse_args([
                "--config=vit_tiny_cifar_fsdp_tp", "--max_batch=32",
                f"--requests={ZS_FSDP_TP_REQUESTS}", "--concurrency=16"])
            out["summary"] = serve_cli.serve_classifier(args, mesh.device,
                                                        mesh)
            bundle = load_for_serving(
                _zs_f32_config("vit_tiny_cifar_fsdp_tp"), mesh.device,
                checkpoint_dir=str(ZS_CKPT), mesh=mesh,
                sharding_rules="fsdp_tp")
            engine = build_zoo_engine(bundle, mesh.device,
                                      model_name="vit_tiny", max_bucket=32)
            out["restored"] = bundle.restored
            batches = [("native", x, None) for x in _zs_fixed_native()]
        out["bytes"] = engine.state_bytes_per_device()
        if engine.is_follower:
            engine.follow()
        else:
            try:
                out["fixed"] = [engine.predict(x, heights=r)
                                for _, x, r in batches]
            finally:
                engine.close()
        return out

    _run_rank_body(body, rank, world, store, out_path)


def zoo_sharded(torch, dev) -> dict:
    """Phase `zoo_sharded`: the zoo's sharded placement on ranks sharing
    the card. (1) `vit_tiny_cifar_flash` (bf16, full width) served by two
    ranks under `--serve_rules=tp` through `cli.serve`'s classifier mode
    with the zoo grid and `run_longctx_loadgen`'s mixed heights
    (`ZS_REQUESTS` requests): every request ok; each rank's launches, from
    0 just before, exactly 12 `flash_attention_forward` a dense batch the
    chief's engine ran and 12 `masked_flash_attention` a masked one, no
    other kernel (the follower runs the chief's cells); the fixed zoo
    batches within `ZOO_LOGIT_TOL` of the largest logit of the one-rank
    "xla" engine on the same seeded weights. (2) `vit_tiny_cifar_fsdp_tp`
    served by four ranks (data 2 x model 2, xla attention): every request
    ok; each rank's resident bytes `ZS_FSDP_TP_SHARE` +- `ZS_SHARE_TOL`
    of the one-rank engine's; a checkpoint trained by `cli.train`'s
    `run_config` under dp and served under fsdp_tp (f32 compute, TF32
    off) gives the unsharded engine's logits within `ZS_RESTORE_TOL` of
    the largest. Prints p50/p99 and the bytes a rank. Returns the
    phase's record."""
    import dataclasses

    from dist_mnist_tpu_torch.cli.train import run_config
    from dist_mnist_tpu_torch.cluster.mesh import MeshSpec
    from dist_mnist_tpu_torch.configs import get_config
    from dist_mnist_tpu_torch.serve import build_zoo_engine, load_for_serving

    t_phase = time.perf_counter()
    out = {"phase": "zoo_sharded"}
    two = _rank_group(_zs_rank, "zoo", world=2, timeout=300)
    summary = two[0]["summary"]
    cells = summary["cells"]
    dense = sum(n for c, n in cells.items() if c.endswith("/dense"))
    masked = sum(n for c, n in cells.items() if c.endswith("/masked"))
    want = {"flash_attention_forward": 12 * dense,
            "masked_flash_attention": 12 * masked}
    launches = [{k: v for k, v in r["launches"].items() if v} for r in two]
    plain = build_zoo_engine(load_for_serving("vit_tiny_cifar", dev), dev,
                             model_name="vit_tiny", max_bucket=32,
                             seq_buckets="auto")
    batches = zoo_fixed_batches(plain.seq_grid)
    ref = [plain.predict(x, heights=r) for _, x, r in batches]
    diffs = rel_logit_diffs(two[0]["fixed"], ref)
    out["tp"] = {
        "ok": summary["ok"], "n_requests": summary["n_requests"],
        "p50_ms": summary["p50_ms"], "p99_ms": summary["p99_ms"],
        "seq_bucket_counts": summary.get("seq_bucket_counts"),
        "dense_batches": dense, "masked_batches": masked, "want": want,
        "launches": launches, "bytes": [r["bytes"] for r in two],
        "one_rank_bytes": plain.state_bytes_per_device(),
        "max_rel_logit_diff_vs_xla": max(diffs), "tol": ZOO_LOGIT_TOL,
        "wall_s": time.perf_counter() - t_phase}
    print(json.dumps({"phase": "zoo_sharded", "tp": out["tp"]}), flush=True)
    if summary["ok"] != ZS_REQUESTS:
        fail(f"zoo_sharded tp: {summary['ok']} of {ZS_REQUESTS} ok")
    if any(got != want for got in launches) or not dense or not masked:
        fail(f"zoo_sharded tp: launches {launches} a rank (want {want})")
    if max(diffs) > ZOO_LOGIT_TOL:
        fail(f"zoo_sharded tp: fixed-batch logits {diffs} of the largest "
             f"from the one-rank xla engine's (limit {ZOO_LOGIT_TOL})")

    t0 = time.perf_counter()
    shutil.rmtree(ZS_CKPT, ignore_errors=True)
    cfg = dataclasses.replace(
        get_config("vit_tiny_cifar_fsdp_tp"), sharding_rules="dp",
        mesh=MeshSpec(data=1), batch_size=64, train_steps=2, eval_every=0)
    run_config(cfg, device=dev, data_dir=_small_cifar(),
               checkpoint_dir=str(ZS_CKPT), checkpoint_every_steps=2)
    four = _rank_group(_zs_rank, "zoo4", world=4, timeout=300)
    f32 = _zs_f32_config("vit_tiny_cifar_fsdp_tp")
    whole = build_zoo_engine(load_for_serving(f32, dev,
                                              checkpoint_dir=str(ZS_CKPT)),
                             dev, model_name="vit_tiny", max_bucket=32)
    shutil.rmtree(ZS_CKPT, ignore_errors=True)
    ref = [whole.predict(x) for x in _zs_fixed_native()]
    restore_diffs = rel_logit_diffs(four[0]["fixed"], ref)
    replicated = whole.state_bytes_per_device()["total_bytes"]
    shares = [r["bytes"]["total_bytes"] / replicated for r in four]
    summary = four[0]["summary"]
    out["fsdp_tp"] = {
        "ok": summary["ok"], "n_requests": summary["n_requests"],
        "p50_ms": summary["p50_ms"], "p99_ms": summary["p99_ms"],
        "bytes": [r["bytes"] for r in four], "one_rank_bytes": replicated,
        "shares": shares, "share_want": ZS_FSDP_TP_SHARE,
        "share_tol": ZS_SHARE_TOL, "restored": [r["restored"] for r in four],
        "restore_rel_logit_diff": restore_diffs, "tol": ZS_RESTORE_TOL,
        "wall_s": time.perf_counter() - t0}
    print(json.dumps({"phase": "zoo_sharded", "fsdp_tp": out["fsdp_tp"]}),
          flush=True)
    if summary["ok"] != ZS_FSDP_TP_REQUESTS:
        fail(f"zoo_sharded fsdp_tp: {summary['ok']} of "
             f"{ZS_FSDP_TP_REQUESTS} ok")
    if any(abs(s - ZS_FSDP_TP_SHARE) > ZS_SHARE_TOL for s in shares):
        fail(f"zoo_sharded fsdp_tp: resident shares {shares} (want "
             f"{ZS_FSDP_TP_SHARE} +- {ZS_SHARE_TOL})")
    if not all(out["fsdp_tp"]["restored"]) \
            or max(restore_diffs) > ZS_RESTORE_TOL:
        fail(f"zoo_sharded fsdp_tp: the dp checkpoint under fsdp_tp gives "
             f"{restore_diffs} of the largest logit from the unsharded "
             f"engine's (limit {ZS_RESTORE_TOL})")
    out["wall_s"] = time.perf_counter() - t_phase
    print(json.dumps({"phase": "zoo_sharded", "wall_s": out["wall_s"]}),
          flush=True)
    return out


FLASH_BODIES = {
    "flash_attention_forward": "flash_fwd_mma_onepass (bf16, S <= 128; "
                               "flash_fwd_mma_tiled above)",
    "flash_attention_backward": "flash_dq_mma + flash_dkv_mma (bf16, tensor "
                                "cores, f32 operands split hi/lo)",
    "masked_flash_attention_backward": "flash_dq_mma + flash_dkv_mma with "
                                       "lengths (bf16)",
    "flash_attention_forward_f32": "flash_fwd_f32 (f32, CUDA cores, "
                                   "register-tiled QK^T and PV)",
    "flash_attention_backward_f32": "flash_dq_f32 + flash_dkv_f32 (f32, "
                                    "CUDA cores, register-tiled)",
    "masked_flash_attention_backward_f32": "flash_dq_f32 + flash_dkv_f32 "
                                           "with lengths (f32)",
}


def time_flash_kernels(torch, dev, bw: float, peaks: dict) -> dict:
    """The three new kernels at the ViT path's shape (B = 64, S = 65, H =
    3, D = 64, bf16, q/k/v the strided views of the fused projection),
    beside their plain versions and `F.scaled_dot_product_attention` on
    [B, H, S, D] copies (forward alone, and forward + backward through
    autograd, where the backward row's library time is the difference),
    each timed by `graph_ms`. The masked backward runs at the same shape
    with lengths 2 .. 65; its yardstick is SDPA with the boolean prefix
    mask. Bounds (`flash_attention_cost`): the bytes each call must move
    over the memory rate, against the products the function needs, each
    over the peak its operands' type sets: QK^T, PV and dO V^T on bf16
    operands at the bf16 tensor-core peak, dV = P^T dO, dQ = dS K and dK
    = dS^T Q (an f32 operand) at the f32 peak. `design_bound_ms` is the
    same bound for the products the kernels themselves run
    (`backward_design_flops`: for bf16, QK^T and dO V^T in each of the dQ
    and dK/dV kernels, and the three f32-operand products twice each as
    bf16 hi and lo halves, all at the bf16 peak). The f32 route's forward,
    backward and masked backward (the register-tiled CUDA-core kernels)
    are timed at the same shape in f32 beside their plain versions and
    SDPA in f32 (with the prefix mask for the masked row)."""
    import torch.nn.functional as F

    from dist_mnist_tpu_torch.ops.kernels import flash_attention as fa
    from dist_mnist_tpu_torch.ops.kernels.masked_flash import (
        masked_flash_attention_backward,
        masked_flash_attention_forward,
    )

    b, s, h, d = VIT_B, VIT_S, VIT_H, VIT_D
    q, k, v = _fused_qkv(torch, b, s, h, d, torch.bfloat16, dev, seed=80)
    do = torch.randn(b, s, h, d, generator=torch.Generator().manual_seed(81)
                     ).to(dev, torch.bfloat16)
    out, lse = fa.flash_attention_forward(q, k, v)
    delta = fa.attention_delta(out, do)
    qt, kt, vt, dot = (t.transpose(1, 2).contiguous().requires_grad_()
                       for t in (q, k, v, do))
    cost = fa.flash_attention_cost(b, s, h, d, torch.bfloat16)

    def ops_ms(flops):
        return sum(n / peaks[t] * 1e3 for t, n in flops.items())

    def bound(nbytes, flops, design_flops):
        t_bytes = nbytes / bw * 1e3
        t_ops = ops_ms(flops)
        return {"bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bound_bytes": nbytes, "bound_flops": flops,
                "design_bound_ms": max(t_bytes, ops_ms(design_flops)),
                "design_flops": design_flops}

    def sdpa_fwd_bwd(mask=None, operands=None):
        qq, kk, vv, dd = operands or (qt, kt, vt, dot)
        o = F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask)
        torch.autograd.grad(o, (qq, kk, vv), dd.detach())

    def kernel_bwd():
        fa.flash_attention_dq(q, k, v, do, lse, delta)
        fa.flash_attention_dkv(q, k, v, do, lse, delta)

    with torch.no_grad():
        lib_fwd = graph_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt))
    # a capture holds the autograd backward as well as the forward
    lib_fwd_bwd = graph_ms(torch, sdpa_fwd_bwd, calls=20)
    rows = {
        "flash_attention_forward": {
            "kernel_ms": graph_ms(torch, lambda: fa.flash_attention_forward(
                q, k, v)),
            "plain_ms": graph_ms(
                torch, lambda: fa.flash_attention_forward_reference(q, k, v)),
            "library": "F.scaled_dot_product_attention (forward)",
            "library_ms": lib_fwd,
            **bound(cost["fwd_bytes"], cost["fwd_flops"],
                    cost["fwd_flops"])},
        "flash_attention_backward": {
            "kernel_ms": graph_ms(torch, kernel_bwd),
            "kernel_dq_ms": graph_ms(torch, lambda: fa.flash_attention_dq(
                q, k, v, do, lse, delta)),
            "kernel_dkv_ms": graph_ms(torch, lambda: fa.flash_attention_dkv(
                q, k, v, do, lse, delta)),
            "plain_ms": graph_ms(
                torch, lambda: fa.flash_attention_backward_reference(
                    q, k, v, do, lse, delta)),
            "library": "F.scaled_dot_product_attention forward + backward "
                       "through autograd, minus its forward",
            "library_fwd_bwd_ms": lib_fwd_bwd,
            "library_ms": lib_fwd_bwd - lib_fwd,
            **bound(cost["bwd_bytes"], cost["bwd_flops"],
                    cost["bwd_split_flops"])},
    }
    lens = torch.arange(2, b + 2, dtype=torch.int32, device=dev)
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    m_out, m_lse = masked_flash_attention_forward(qc, kc, vc, lens)
    m_delta = fa.attention_delta(m_out, do)
    mask = (torch.arange(s, device=dev)[None, :]
            < lens[:, None])[:, None, None, :]
    keys = float(lens.sum())  # the keys the rows attend, all told

    def masked_bytes(el):
        # q and dO, the K and V rows before each length, lse, delta and the
        # lengths in; dq, dk and dv (zeros past the lengths) out
        return (2 * b * s * h * d * el + 2 * keys * h * d * el
                + 2 * b * h * s * 4 + 4 * b + 3 * b * s * h * d * el)

    m_bytes = masked_bytes(2)  # bf16
    m_flops = fa.attention_flops_by_type(s * h * d * keys, torch.bfloat16,
                                         2, 3)
    m_lib = graph_ms(torch, lambda: sdpa_fwd_bwd(mask), calls=20)
    with torch.no_grad():
        m_lib_fwd = graph_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask))
    rows["masked_flash_attention_backward"] = {
        "kernel_ms": graph_ms(torch, lambda: masked_flash_attention_backward(
            qc, kc, vc, lens, do, m_lse, m_delta)),
        "plain_ms": graph_ms(
            torch, lambda: fa.flash_attention_backward_reference(
                qc, kc, vc, do, m_lse, m_delta, lens)),
        "library": "F.scaled_dot_product_attention(attn_mask=prefix) forward "
                   "+ backward through autograd, minus its forward",
        "library_fwd_bwd_ms": m_lib,
        "library_ms": m_lib - m_lib_fwd,
        "lengths": "2..65",
        **bound(m_bytes, m_flops, fa.backward_design_flops(
            s * h * d * keys, torch.bfloat16))}

    # the f32 route (flash_fwd_f32, flash_dq_f32 + flash_dkv_f32)
    q32, k32, v32 = _fused_qkv(torch, b, s, h, d, torch.float32, dev,
                               seed=80)
    do32 = do.float()
    out32, lse32 = fa.flash_attention_forward(q32, k32, v32)
    delta32 = fa.attention_delta(out32, do32)
    ops32 = tuple(t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q32, k32, v32, do32))
    cost32 = fa.flash_attention_cost(b, s, h, d, torch.float32)
    with torch.no_grad():
        lib32_fwd = graph_ms(torch, lambda: F.scaled_dot_product_attention(
            *ops32[:3]))
    lib32_fwd_bwd = graph_ms(torch, lambda: sdpa_fwd_bwd(operands=ops32),
                             calls=20)
    rows["flash_attention_forward_f32"] = {
        "kernel_ms": graph_ms(torch, lambda: fa.flash_attention_forward(
            q32, k32, v32)),
        "plain_ms": graph_ms(torch, lambda: fa.flash_attention_forward_reference(
            q32, k32, v32)),
        "library": "F.scaled_dot_product_attention (forward), f32",
        "library_ms": lib32_fwd,
        **bound(cost32["fwd_bytes"], cost32["fwd_flops"],
                cost32["fwd_flops"])}
    rows["flash_attention_backward_f32"] = {
        "kernel_ms": graph_ms(torch, lambda: (
            fa.flash_attention_dq(q32, k32, v32, do32, lse32, delta32),
            fa.flash_attention_dkv(q32, k32, v32, do32, lse32, delta32))),
        "plain_ms": graph_ms(
            torch, lambda: fa.flash_attention_backward_reference(
                q32, k32, v32, do32, lse32, delta32)),
        "library": "F.scaled_dot_product_attention forward + backward "
                   "through autograd, minus its forward, f32",
        "library_fwd_bwd_ms": lib32_fwd_bwd,
        "library_ms": lib32_fwd_bwd - lib32_fwd,
        **bound(cost32["bwd_bytes"], cost32["bwd_flops"],
                cost32["bwd_split_flops"])}
    # the f32 masked backward at the same lengths, beside SDPA f32 with the
    # prefix mask
    qc32, kc32, vc32 = (t.contiguous() for t in (q32, k32, v32))
    m_out32, m_lse32 = masked_flash_attention_forward(qc32, kc32, vc32, lens)
    m_delta32 = fa.attention_delta(m_out32, do32)
    m32_lib = graph_ms(torch, lambda: sdpa_fwd_bwd(mask, ops32), calls=20)
    with torch.no_grad():
        m32_lib_fwd = graph_ms(torch, lambda: F.scaled_dot_product_attention(
            *ops32[:3], attn_mask=mask))
    rows["masked_flash_attention_backward_f32"] = {
        "kernel_ms": graph_ms(torch, lambda: masked_flash_attention_backward(
            qc32, kc32, vc32, lens, do32, m_lse32, m_delta32)),
        "plain_ms": graph_ms(
            torch, lambda: fa.flash_attention_backward_reference(
                qc32, kc32, vc32, do32, m_lse32, m_delta32, lens)),
        "library": "F.scaled_dot_product_attention(attn_mask=prefix) forward "
                   "+ backward through autograd, minus its forward, f32",
        "library_fwd_bwd_ms": m32_lib,
        "library_ms": m32_lib - m32_lib_fwd,
        "lengths": "2..65",
        **bound(masked_bytes(4), fa.attention_flops_by_type(
            s * h * d * keys, torch.float32, 2, 3), fa.backward_design_flops(
                s * h * d * keys, torch.float32))}
    for name, row in rows.items():
        print(json.dumps({"phase": "time", "kernel": name, "b": b, "s": s,
                          "h": h, "d": d, "dtype": "float32"
                          if name.endswith("_f32") else "bfloat16",
                          "body": FLASH_BODIES[name], **row}), flush=True)
    return rows


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke.py runs on an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    try:
        import dist_mnist_tpu_torch
    except ImportError as err:
        fail(f"the port's package is not beside chip_smoke.py ({err})")
    if Path(dist_mnist_tpu_torch.__file__).resolve().parent.parent != ROOT:
        fail(f"imported {dist_mnist_tpu_torch.__file__}, not the checkout's")

    from dist_mnist_tpu_torch.ops import quant as quant_mod
    from dist_mnist_tpu_torch.ops.kernels import build
    from dist_mnist_tpu_torch.ops.kernels.fused_adam import (
        adam_leaf_plan,
        fused_adam_clip_wd_update,
        fused_adam_update,
    )
    from dist_mnist_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_dkv,
        flash_attention_dq,
        flash_attention_forward,
    )
    from dist_mnist_tpu_torch.ops.kernels.masked_flash import (
        masked_flash_attention,
        masked_flash_attention_backward,
        masked_forward_body,
    )
    from dist_mnist_tpu_torch.ops.kernels.paged_attention import (
        paged_attention,
    )
    from dist_mnist_tpu_torch.ops.kernels.quant_matmul import (
        quant_matmul,
        quant_matmul_cost,
        quant_matmul_reference,
    )
    from dist_mnist_tpu_torch import bench, optim
    from dist_mnist_tpu_torch.bench import run_headline
    from dist_mnist_tpu_torch.cli import serve as serve_cli
    from dist_mnist_tpu_torch.data.datasets import load_dataset
    from dist_mnist_tpu_torch.data.pipeline import DeviceDataset
    from dist_mnist_tpu_torch.models.registry import get_model
    from dist_mnist_tpu_torch.train import (
        create_train_state,
        evaluate,
        make_eval_step,
        make_fused_train_step,
        state_memory_bytes,
    )
    from dist_mnist_tpu_torch.serve import (
        InferenceEngine,
        load_for_serving,
        make_images,
    )

    # -- 1. the card ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    gpu = smi.stdout.strip().splitlines()[0].strip()
    print(gpu, flush=True)
    kind = torch.cuda.get_device_name(0)
    bw, peaks = _CARD_RATES["pcie" if "PCIe" in kind else "sxm"]
    # the plain versions' f32 products in full f32, as the kernel sums
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    build.build_all(["quant_matmul", "fused_adam", "paged_attention",
                     "masked_flash_attention", "flash_attention"])
    print(json.dumps({"phase": "build",
                      "seconds": time.perf_counter() - t0}), flush=True)
    for src, log in build.build_logs.items():
        print(f"--- nvcc {src}.cu ---\n{log.strip()}", flush=True)

    # -- 3. kernel vs plain version at the path's shapes ---------------------
    operands, worst = qmm_parity(torch, dev)
    split_k_repeat(torch, dev)

    # both fused-Adam kernels against their plain versions: LeNet-5's leaf
    # sizes and sizes that leave a tail after the float4 loads
    adam_worst = adam_parity(torch, dev)
    # both decode kernels at the decode path's shapes, and their bits
    decode_worst = decode_kernel_parity(torch, dev)
    decode_repeat(torch, dev)
    # the flash kernels at ViT's shapes, and the masked backward
    flash_worst = flash_parity(torch, dev)

    counters = (quant_matmul, fused_adam_update, fused_adam_clip_wd_update,
                paged_attention, masked_flash_attention,
                flash_attention_forward, flash_attention_dq,
                flash_attention_dkv, masked_flash_attention_backward)

    def reset_counts():
        for fn in counters:
            fn.launches = 0

    def read_counts() -> dict:
        return {fn.__name__: fn.launches for fn in counters}

    # -- 4. the served path, through the serving CLI's entry point ----------
    reset_counts()
    summary = serve_cli.main([
        "--config=lenet5_mnist", "--quant=int8", "--device=cuda:0",
        "--max_batch=64", "--requests=512", "--concurrency=64"])
    serve_counts = read_counts()
    launches = serve_counts["quant_matmul"]
    print(json.dumps({"phase": "serve", "quant_matmul_launches": launches,
                      **{k: summary[k] for k in (
                          "ok", "errors", "p50_ms", "p99_ms", "n_batches",
                          "mean_batch_size", "cache")}}), flush=True)
    n_runs = summary["cache"]["hits"] + summary["cache"]["misses"]
    if summary["ok"] != 512 or summary["errors"] != 0:
        fail(f"serve: {summary['ok']}/512 ok, {summary['errors']} errors")
    if launches != 2 * n_runs or launches == 0:
        fail(f"serve: {launches} quant_matmul launches for {n_runs} "
             "LeNet-5 batches (want 2 per batch: fc1, fc2)")
    # the same seeded weights again, for one fixed batch: kernel vs plain.
    # Quantized on the card, their int8 leaves must equal the CPU's bit for
    # bit (the CPU's are pinned to the JAX package's by the CPU tests).
    bundle = load_for_serving("lenet5_mnist", dev, quant="int8")
    on_cpu = load_for_serving("lenet5_mnist", "cpu", quant="int8")
    for layer, leaves in on_cpu.params.items():
        got, want = bundle.params[layer]["w"], leaves["w"]
        same_scale = torch.equal(got.scale.cpu().view(torch.int32),
                                 want.scale.view(torch.int32))
        if not (same_scale and torch.equal(got.q.cpu(), want.q)):
            fail(f"int8 {layer}/w quantized on the card differs from "
                 "the CPU's")
    engine = InferenceEngine(
        bundle.model, bundle.params, bundle.model_state, device=dev,
        image_shape=bundle.image_shape, max_bucket=64)
    images = make_images(bundle.image_shape, seed=123, n=64)
    served = engine.predict(images)
    quant_mod.quant_matmul = quant_matmul_reference
    try:
        plain = engine.predict(images)
    finally:
        quant_mod.quant_matmul = quant_matmul
    diff = float(np.max(np.abs(served - plain)))
    agree = float(np.mean(served.argmax(-1) == plain.argmax(-1)))
    print(json.dumps({"phase": "served_logits", "shape": list(served.shape),
                      "max_abs_diff_vs_plain": diff, "top1_agreement": agree,
                      "max_abs_logit": float(np.max(np.abs(plain)))}),
          flush=True)
    if served.shape != (64, 10) or not np.isfinite(served).all():
        fail(f"served logits: shape {served.shape} or non-finite values")
    if diff > 0.04 or agree < 0.98:
        fail(f"served logits vs plain path: max abs {diff}, top-1 {agree}")

    # where one served batch of 64 spends its time: host clock per predict
    # (ends on the logits' .cpu()), then device time by kernel name from
    # torch.profiler over the same predicts
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        engine.predict(images)
    wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            engine.predict(images)
    print(json.dumps({"phase": "profile", "batch": 64,
                      **profile_fields(torch, prof, reps, wall_ms)}),
          flush=True)
    # the MLP (the CLI's default config) served int8: the f32 route
    mlp = mlp_serve(torch, dev, reset_counts, read_counts)

    # -- 5. the training path, through the port's headline bench ------------
    # one launch per step over every LeNet-5 leaf (a table holds them all)
    adam_per_step = len(adam_leaf_plan(list(LENET_LEAVES.values())).tables)
    dataset = load_dataset("mnist", seed=0)
    dd = DeviceDataset(dataset, dev)
    reset_counts()
    t0 = time.perf_counter()
    run = run_headline(dev, optim.adam(1e-3, fused=True), dataset=dataset,
                       race_rounds=2, timed_steps=700)
    torch.cuda.synchronize()
    train_wall = time.perf_counter() - t0
    train_counts = read_counts()
    final_eval = evaluate(make_eval_step(get_model("lenet5")), run.state,
                          dataset.test_images, dataset.test_labels,
                          batch_size=10_000)
    extra = run.record["extra"]
    print(json.dumps({
        "phase": "train", "launches": train_counts, "steps": run.steps,
        "wall_s": train_wall, "steps_per_sec": run.record["value"],
        "examples_per_sec": extra["examples_per_sec"], "mfu": extra["mfu"],
        "first_chunk_loss": run.first_loss, "final_chunk_loss": run.final_loss,
        "race_test_acc": extra["accuracy_race"]["final_test_acc"],
        "wall_to_99pct_acc_secs": extra["accuracy_race"][
            "wall_to_99pct_acc_secs"],
        "final_test_acc": final_eval["accuracy"],
        "synthetic_data": run.record["synthetic_data"],
        "state_memory_bytes": state_memory_bytes(run.state),
        "dataset_bytes_on_card": dd.nbytes()}),
          flush=True)
    print(json.dumps(run.record), flush=True)
    if train_counts["fused_adam_update"] != adam_per_step * run.steps:
        fail(f"train: {train_counts['fused_adam_update']} fused_adam_update "
             f"launches for {run.steps} steps (want {adam_per_step} per step, "
             "one over all of LeNet-5's leaves)")
    if not (np.isfinite(run.final_loss) and run.final_loss < run.first_loss):
        fail(f"train: loss {run.first_loss} -> {run.final_loss}")
    if final_eval["accuracy"] < 0.97:
        fail(f"train: test accuracy {final_eval['accuracy']} < 0.97")

    # -- 6. trajectories: kernel against plain from one initial state -------
    traj = {}
    for label, make_plain, make_fused, counter in (
            ("adam", lambda: optim.adam(1e-3),
             lambda: optim.adam(1e-3, fused=True), fused_adam_update),
            ("clip_adamw", lambda: optim.chain(
                optim.clip_by_global_norm(0.5),
                optim.adamw(1e-3, weight_decay=0.01)),
             lambda: optim.fused_adamw(1e-3, weight_decay=0.01,
                                       clip_norm=0.5),
             fused_adam_clip_wd_update)):
        plain_losses, plain_acc = trajectory(torch, dev, dataset, dd,
                                             make_plain())
        reset_counts()
        fused_losses, fused_acc = trajectory(torch, dev, dataset, dd,
                                             make_fused())
        counts = read_counts()
        traj[label] = counts[counter.__name__]
        loss_gap = abs(fused_losses[-1] - plain_losses[-1]) / abs(
            plain_losses[-1])
        print(json.dumps({
            "phase": "trajectory", "optimizer": label,
            "steps": len(fused_losses), "launches": counts,
            "max_step_loss_diff": float(np.max(np.abs(fused_losses
                                                      - plain_losses))),
            "bitwise_equal_losses": bool(np.array_equal(fused_losses,
                                                        plain_losses)),
            "final_loss_plain": float(plain_losses[-1]),
            "final_loss_kernel": float(fused_losses[-1]),
            "test_acc_plain": plain_acc, "test_acc_kernel": fused_acc}),
              flush=True)
        if counts[counter.__name__] != adam_per_step * len(fused_losses):
            fail(f"trajectory {label}: {counts[counter.__name__]} "
                 f"{counter.__name__} launches for {len(fused_losses)} steps")
        if not np.isfinite(fused_losses).all() or loss_gap > 0.01:
            fail(f"trajectory {label}: final loss {fused_losses[-1]} vs "
                 f"plain {plain_losses[-1]}")
        if abs(fused_acc - plain_acc) > 0.005:
            fail(f"trajectory {label}: test accuracy {fused_acc} vs plain "
                 f"{plain_acc}")

    # -- 7. where one training step's time goes ------------------------------
    model = get_model("lenet5")
    opt = optim.adam(1e-3, fused=True)
    state = create_train_state(model, opt, 0, dataset.train_images[:1], dev)
    step = make_fused_train_step(model, opt, dd, 200)
    for _ in range(10):  # allocator and cuDNN warm-up
        state, out = step(state)
    torch.cuda.synchronize()
    reps = 50
    t0 = time.perf_counter()
    for _ in range(reps):
        state, out = step(state)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            state, out = step(state)
        torch.cuda.synchronize()
    print(json.dumps({"phase": "train_profile", "batch": 200,
                      **profile_fields(torch, prof, reps, wall_ms)}),
          flush=True)

    # -- 8. decode serving: the bench's entry point, flash, contract ---------
    reset_counts()
    records = bench.main(["--serve", "--decode", "--device=cuda:0",
                          "--requests=64", "--concurrency=16"])
    torch.cuda.synchronize()
    decode_counts = read_counts()
    int8_steps = records[2]["extra"]["int8_decode_steps"]
    depth = bench.CAPACITY_GEOM["depth"]
    print(json.dumps({"phase": "decode_serve", "launches": decode_counts,
                      "int8_decode_steps": int8_steps,
                      "metrics": {r["metric"]: r["value"] for r in records}}),
          flush=True)
    if decode_counts["paged_attention"] != depth * int8_steps \
            or int8_steps == 0:
        fail(f"decode_serve: {decode_counts['paged_attention']} "
             f"paged_attention launches for {int8_steps} int8 decode steps "
             f"(want {depth} per step)")
    others = {k: v for k, v in decode_counts.items() if k != "paged_attention"}
    if any(others.values()):
        fail(f"decode_serve: other kernels launched on the decode path: "
             f"{others}")
    flash = decode_flash(torch, dev, reset_counts, read_counts)
    decode_contract(torch, dev)
    decode_profile(torch, dev)

    # -- 9. ViT-Tiny training, through the bench's config mode --------------
    reset_counts()
    t0 = time.perf_counter()
    vit = bench.main(["--config", "vit_tiny_cifar_flash", "--steps", "100",
                      "--device=cuda:0"])
    torch.cuda.synchronize()
    vit_wall = time.perf_counter() - t0
    vit_counts = read_counts()
    vit_steps = vit["extra"]["steps_run"]
    chunk_losses = vit["extra"]["chunk_losses"]
    depth = 12
    want = {"flash_attention_forward": 2 * depth * vit_steps,
            "flash_attention_dq": depth * vit_steps,
            "flash_attention_dkv": depth * vit_steps}
    print(json.dumps({
        "phase": "vit_train", "launches": vit_counts, "steps": vit_steps,
        "launches_per_step": {k: vit_counts[k] / vit_steps for k in want},
        "wall_s": vit_wall, "steps_per_sec": vit["value"],
        "examples_per_sec": vit["extra"]["examples_per_sec"],
        "mfu": vit["extra"]["mfu"], "chunk_losses": chunk_losses,
        "synthetic_data": vit["synthetic_data"]}), flush=True)
    for name, n in want.items():
        if vit_counts[name] != n:
            fail(f"vit_train: {vit_counts[name]} {name} launches for "
                 f"{vit_steps} steps (want {n // vit_steps} per step)")
    others = {k: v for k, v in vit_counts.items() if k not in want and v}
    if others:
        fail(f"vit_train: other kernels launched on the ViT path: {others}")
    if not (np.isfinite(chunk_losses).all()
            and chunk_losses[-1] < chunk_losses[0]):
        fail(f"vit_train: chunk losses {chunk_losses}")
    cifar = load_dataset("cifar10", seed=42)  # the bench's cached twin
    vit_kernel_vs_plain(torch, dev, cifar)
    vit_profile(torch, dev, cifar)
    # the masked forward at Sq > 1 on a real model: a sub-native bucket
    vit_masked = vit_masked_forward(torch, dev, reset_counts, read_counts)

    # -- 10. the classifier serving benches, and the zoo's flash grid -------
    serve_counts = serve_benches(torch, dev, reset_counts, read_counts)
    zoo = zoo_flash_serve(torch, dev, reset_counts, read_counts)

    # -- 11. the training CLI, its checkpoints, and serving one -------------
    cli_run = train_cli(torch, dev, reset_counts, read_counts)
    cli_vit, cli_serve = cli_run["vit"]["launches"], cli_run["serve"][
        "launches"]

    # -- 12. data parallelism: benches, two ranks on the one card ----------
    dp = data_parallel(torch, dev, reset_counts, read_counts)
    # -- 12b. tensor parallelism: decode and the flash entry on two ranks,
    # TP and FSDP x TP ViT-Tiny through cli.launch -------------------------
    tp = tensor_parallel(torch, dev, reset_counts, read_counts, bw,
                         peaks["float32"])
    # -- 12c. sequence parallelism: ring and Ulysses on two ranks --------
    sp = sequence_parallel(torch, dev)
    # -- 12d. model parallelism: EP and the pipeline on four ranks --------
    model_parallel(torch, dev)
    # -- 12e. the native layer: the C++ loader through cli.train, the PS
    # demo ------------------------------------------------------------------
    native(torch, dev)
    # -- 12f. the multislice rank layout over fake slices -------------------
    multislice(torch, dev)
    # -- 12g. the zoo's sharded placement (tp, fsdp_tp) ----------------------
    zs = zoo_sharded(torch, dev)

    # -- 13. timing at the paths' shapes -------------------------------------
    timed = {}
    for (label, m), (x, qa) in operands.items():
        w_deq = quant_mod.dequantize(qa, x.dtype)  # the library's operand
        row = {"kernel_ms": graph_ms(torch, lambda: quant_matmul(
                   x, qa.q, qa.scale)),
               "plain_ms": graph_ms(torch, lambda: quant_matmul_reference(
                   x, qa.q, qa.scale)),
               "library_ms": graph_ms(torch, lambda: torch.matmul(x, w_deq))}
        cost = quant_matmul_cost(tuple(x.shape), tuple(qa.shape), x.dtype)
        t_bytes = cost["hbm_bytes"] / bw * 1e3
        peak = peaks[str(x.dtype).removeprefix("torch.")]
        t_ops = cost["flops"] / peak * 1e3
        row.update(bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        timed[(label, m)] = row
        print(json.dumps({"phase": "time", "shape": label, "m": m,
                          "dtype": str(x.dtype), **row}), flush=True)
    adam_timed = time_adam(torch, dev, state, bw, peaks["float32"])
    decode_timed = time_decode_kernels(torch, dev, bw, peaks["float32"],
                                       peaks["bfloat16"])
    flash_timed = time_flash_kernels(torch, dev, bw, peaks)

    # -- 14. result ----------------------------------------------------------
    head = timed[("lenet5/fc1", 64)]
    adam_rows = []
    for name, launches_on_path, src_line in (
            ("fused_adam_update", train_counts["fused_adam_update"], 26),
            ("fused_adam_clip_wd_update", traj["clip_adamw"], 72)):
        row = adam_timed[(name, "step")]
        adam_rows.append({
            "name": name,
            "route": "cuda",
            "source": "dist_mnist_tpu_torch/csrc/fused_adam.cu",
            "replaces": f"dist_mnist_tpu/ops/pallas/fused_adam.py:{src_line}",
            "launches": launches_on_path,
            "max_abs_err": adam_worst[name]["abs"],
            "max_rel_err": adam_worst[name]["rel"],
            "shape": "LeNet-5's 8 leaves, one update step "
                     "(1,663,370 f32 elements)",
            "ms": row["kernel_ms"],
            "kernel_ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": None,  # no torch call computes this function
            "yardstick": {"call": row["yardstick"],
                          "ms": row["yardstick_ms"]},
            "fc1_w_ms": adam_timed[(name, "fc1/w")]["kernel_ms"],
        })
    decode_rows = []
    for name, key, long_key, src, src_line, launches_on_path, body, shape in (
            ("paged_attention", ("paged_attention", 2),
             ("paged_attention", 128, "len4096"), "paged_attention",
             "paged_attention.py:65", decode_counts["paged_attention"],
             "paged_attn_kernel (one warp per (row, head), two slices of "
             "tokens in flight ahead of the arithmetic, a softmax per lane "
             "merged by fixed butterflies)",
             "one decode step: R=9, H=8, D=16, T=32, table width 2, "
             f"lengths {DEC_LENGTHS}, int8 pages, f32 q"),
            ("masked_flash_attention", ("masked_flash_attention", DEC_SEQ),
             ("masked_flash_attention", DEC_SEQ, "len4096"),
             "masked_flash_attention", "flash_attention.py:527",
             flash["launches"]["masked_flash_attention"],
             f"{masked_forward_body(1, DEC_SEQ, torch.float32)} (Sq = 1: one "
             "warp per (b, h))",
             f"one decode step: B=9, Sq=1, Sk={DEC_SEQ}, H=8, D=16, "
             f"lengths {DEC_LENGTHS}, f32")):
        row, long_row = decode_timed[key], decode_timed[long_key]
        decode_rows.append({
            "name": name,
            "route": "cuda",
            "source": f"dist_mnist_tpu_torch/csrc/{src}.cu",
            "replaces": f"dist_mnist_tpu/ops/pallas/{src_line}",
            "body": body,
            "launches": launches_on_path,
            "max_abs_err": decode_worst[name],
            "shape": shape,
            "ms": row["kernel_ms"],
            "kernel_ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "launch_floor_ms": row["launch_floor_ms"],
            "library_ms": row["library_ms"],
            **({"composite": row["composite"],
                "composite_ms": row["composite_ms"]}
               if "composite" in row else {}),
            "len4096_kernel_ms": long_row["kernel_ms"],
            "len4096_bound_ms": long_row["bound_ms"],
            "len4096_library_or_composite_ms": long_row.get(
                "composite_ms", long_row["library_ms"]),
        })
    # the Sq > 1 route: the flash forward's kernels with the lengths
    sq_row = decode_timed[(f"masked_flash_attention_sq{VIT_MASK_S}",
                           "torch.bfloat16")]
    masked_sq_row = {
        "name": "masked_flash_attention_sq_gt1",
        "route": "cuda",
        "source": "dist_mnist_tpu_torch/csrc/flash_attention.cu",
        "replaces": "dist_mnist_tpu/ops/pallas/flash_attention.py:527",
        "body": f"{masked_forward_body(65, 65, torch.bfloat16)} (bf16, Sk <= "
                f"128), {masked_forward_body(300, 300, torch.bfloat16)} "
                f"(bf16 above), {masked_forward_body(65, 65, torch.float32)}"
                " (f32), with per-row lengths and the streamed rule",
        "launches": vit_masked["launches"]["masked_flash_attention"],
        "path": "vit_masked_forward: one ViT-Tiny eval forward at full "
                "width, B=64, the height-16 bucket (S=33), bf16",
        "launches_zoo_flash_serve":
            zoo["launches"]["masked_flash_attention"],
        "launches_train_cli": cli_serve["masked_flash_attention"],
        "max_abs_err": decode_worst["masked_flash_attention_sq_gt1"],
        "shape": f"B={VIT_B}, Sq=Sk={VIT_MASK_S}, H={VIT_H}, D={VIT_D}, "
                 "bf16, the bucket's lengths 25 and 33 (vit_masked_forward's)",
        "ms": sq_row["kernel_ms"],
        **{k: sq_row[k] for k in ("kernel_ms", "plain_ms", "bound_ms",
                                  "bound_by", "launch_floor_ms",
                                  "library_ms")},
    }
    for s_len in (VIT_MASK_S, 65, 300):
        for dtype in ("torch.bfloat16", "torch.float32"):
            row = decode_timed[(f"masked_flash_attention_sq{s_len}", dtype)]
            tag = f"sq{s_len}_" + dtype.removeprefix("torch.")
            masked_sq_row.update({f"{tag}_{k}": row[k] for k in (
                "kernel_ms", "plain_ms", "bound_ms", "launch_floor_ms",
                "library_ms")})
    vit_shape = (f"ViT-Tiny training: B={VIT_B}, S={VIT_S}, H={VIT_H}, "
                 f"D={VIT_D}, bf16, strided q/k/v of the fused projection")
    flash_rows = []
    for name, src_line, launches_on_path, shape in (
            ("flash_attention_forward", "flash_attention.py:288",
             vit_counts["flash_attention_forward"], vit_shape),
            ("flash_attention_backward", "flash_attention.py:350",
             vit_counts["flash_attention_dq"]
             + vit_counts["flash_attention_dkv"], vit_shape),
            ("masked_flash_attention_backward", "flash_attention.py:726", 0,
             f"B={VIT_B}, S={VIT_S}, H={VIT_H}, D={VIT_D}, bf16, lengths "
             "2..65")):
        row = flash_timed[name]
        f32_row = flash_timed.get(name + "_f32")
        flash_rows.append({
            "name": name,
            "route": "cuda",
            "source": "dist_mnist_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"dist_mnist_tpu/ops/pallas/{src_line}",
            "body": FLASH_BODIES[name] + (
                f"; the f32 route: {FLASH_BODIES[name + '_f32']}"
                if f32_row else ""),
            "launches": launches_on_path,
            "max_abs_err": flash_worst[name],
            "shape": shape,
            "ms": row["kernel_ms"],
            "kernel_ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "design_bound_ms": row["design_bound_ms"],
            "library_ms": row["library_ms"],
            "library": row["library"],
            **({"f32_kernel_ms": f32_row["kernel_ms"],
                "f32_plain_ms": f32_row["plain_ms"],
                "f32_bound_ms": f32_row["bound_ms"],
                "f32_library_ms": f32_row["library_ms"]} if f32_row else {}),
        })
    tp_int8 = tp["decode"]["int8"]["launches"]
    decode_rows[0].update(
        launches_tensor_parallel=[r["paged_attention"] for r in tp_int8],
        tensor_parallel_decode_steps=tp["decode"]["int8"]["decode_steps"],
        **{f"tp_h{h}_{k}": row[k] for h, row in tp["paged_h2"].items()
           for k in ("kernel_ms", "plain_ms", "bound_ms", "launch_floor_ms",
                     "max_abs_err")})
    tp_flash = tp["flash"]["flash"]
    flash_rows[0]["launches_tensor_parallel"] = [
        r["launches"]["flash_attention_forward"] for r in tp_flash]
    flash_rows[1]["launches_tensor_parallel"] = [
        r["launches"]["flash_attention_dq"]
        + r["launches"]["flash_attention_dkv"] for r in tp_flash]
    flash_rows[2]["launches_tensor_parallel"] = [
        r["launches"]["masked_flash_attention_backward"]
        for r in tp["flash"]["masked"]]
    masked_sq_row["launches_tensor_parallel"] = [
        r["launches"]["masked_flash_attention"]
        for r in tp["flash"]["masked"]]
    for impl, run in sp["runs"].items():
        flash_rows[0][f"launches_sequence_parallel_{impl}"] = [
            r["flash_attention_forward"] for r in run["launches"]]
        flash_rows[1][f"launches_sequence_parallel_{impl}"] = [
            r["flash_attention_dq"] + r["flash_attention_dkv"]
            for r in run["launches"]]
    flash_rows[0]["sequence_parallel_shapes"] = (
        f"ring_flash: flash_attention_lse on B={SP_RING_SHAPE[0]}, "
        f"S={SP_RING_SHAPE[1]}, H={SP_RING_SHAPE[2]}, D={SP_RING_SHAPE[3]}"
        f", bf16; ulysses_flash: B={SP_ULYSSES_SHAPE[0]}, "
        f"S={SP_ULYSSES_SHAPE[1]}, H={SP_ULYSSES_SHAPE[2]}, "
        f"D={SP_ULYSSES_SHAPE[3]} (the D = 64 instantiation), bf16")
    flash_rows[0]["launches_zoo_flash_serve"] = \
        zoo["launches"]["flash_attention_forward"]
    flash_rows[0]["launches_zoo_sharded"] = [
        r.get("flash_attention_forward", 0) for r in zs["tp"]["launches"]]
    masked_sq_row["launches_zoo_sharded"] = [
        r.get("masked_flash_attention", 0) for r in zs["tp"]["launches"]]
    flash_rows[0]["launches_data_parallel"] = dp["vit_launches"][
        "flash_attention_forward"]
    flash_rows[1]["launches_data_parallel"] = (
        dp["vit_launches"]["flash_attention_dq"]
        + dp["vit_launches"]["flash_attention_dkv"])
    flash_rows[2]["launches_data_parallel"] = 0
    flash_rows[0]["launches_train_cli"] = (
        cli_vit["flash_attention_forward"]
        + cli_serve["flash_attention_forward"])
    flash_rows[1].update(launches_dq=vit_counts["flash_attention_dq"],
                         launches_dkv=vit_counts["flash_attention_dkv"],
                         launches_train_cli=cli_vit["flash_attention_dq"]
                         + cli_vit["flash_attention_dkv"])
    flash_rows[2]["path"] = ("none: no training path takes a token mask; "
                             "held against its plain version in "
                             "flash_parity")
    mlp_hid = {m: timed[("mlp/hid", m)] for m in (1, 64)}
    print(json.dumps({"kernels": [{
        "name": "quant_matmul",
        "route": "cuda",
        "source": "dist_mnist_tpu_torch/csrc/quant_matmul.cu",
        "replaces": "dist_mnist_tpu/ops/pallas/quant_matmul.py:50",
        "body": "qmm_bf16_splitk_kernel (tensor-core split-K; the f32 "
                "route: qmm_f32_splitk_kernel, CUDA-core split-K)",
        "launches": launches,
        "max_abs_err": worst["abs"],
        "max_rel_err": worst["rel"],
        "shape": "lenet5/fc1 [64,3136]x[3136,512] bf16",
        "ms": head["kernel_ms"],
        "kernel_ms": head["kernel_ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "f32_shape": "mlp/hid [M,784]x[784,100] f32, M in {1, 64}",
        "f32_launches_mlp_serve": mlp["quant_matmul_f32_launches"],
        "f32_launches_serve_quant":
            serve_counts["serve_quant"]["quant_matmul"],
        **{f"f32_{key}_m{m}": row[key] for m, row in mlp_hid.items()
           for key in ("kernel_ms", "plain_ms", "library_ms", "bound_ms")},
    }, *adam_rows, *decode_rows, masked_sq_row, *flash_rows], "gpu": gpu}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
