"""Autoregressive decode serving: prefill/decode split, a KV cache on the
device, continuous batching (port of the reference `serve/decode.py`).

`DecodeEngine` owns the device state:

- The KV cache lives on the device between steps and is updated IN PLACE
  by every prefill and decode step (models/causal_lm.py).
- Shapes come from the `serve/zoo.DecodeGrid`: prefill runs at an
  (admit bucket, prompt bucket) cell, decode at the full slot capacity
  plus a scratch row, so admission and eviction between steps never
  change a shape. A request's prompt bucket depends on ITS OWN length
  only, which keeps token streams identical between scheduling modes.
- **Paged KV cache** (``cache_layout="paged"`` models): a page POOL plus
  a host-owned int32 page table ``[rows, pages_per_slot]`` and a free
  list. Pages are pinned at admission (`try_reserve`) and reclaimed at
  eviction (`release_slot`); unallocated table entries alias the
  reserved scratch pages (written only by rows whose output is
  discarded, never read by live rows). Each decode step takes the
  smallest ``("decode", p)`` page bucket covering the live prefix and
  reads a device copy of the table's first p columns, made from a fresh
  host buffer and cached per width until an alloc or free dirties it, so
  host-side bookkeeping after a dispatch never touches the in-flight
  step's table.

**Tensor parallelism** (an engine given a `cluster.mesh.Mesh` whose
model axis is wider than one): each rank of the model group holds the
KV cache's ``heads / M`` heads (`CausalLMTiny.init_cache(mesh=)`) and
runs every prefill and decode call on them under the mesh
(`models/causal_lm.py`'s TP branches); `kv_stats` reports the whole
cache, as the reference's, and `rank_kv_bytes` this rank's share. A
stated departure: the reference drives every device from one process,
the port runs a process per device. The model group's first rank (the
chief) owns the scheduler, the page table and the loadgen; for every
prefill or decode call it broadcasts the call's host inputs (the cell,
tokens, positions or lengths, slots, the page table) over the model
group's host group, and the other ranks (`follow`) run the same call on
their heads, in the chief's order, until `close` on the chief sends the
stop message. A follower that raises leaves its loop and its process,
which fails the chief's next collective, so nothing waits for it.

What the reference has and this port does not: the reference compiles
every grid cell through a `CompiledModelCache` and gates on zero
recompiles during traffic (`stats()["misses"]`,
`recompiles_during_traffic`). Eager PyTorch compiles nothing, so those
are gone; the grid still fixes every shape, and `prewarm` runs each cell
once so first-use costs (the kernels' build, cuBLAS handles, the
allocator) fall before traffic. A CUDA graph per cell is later work, as
are the journal events (`kv_page_alloc`, `decode_admit`, ...).

`DecodeScheduler` — **continuous batching** over the engine's slots (one
daemon thread, name prefix ``DecodeScheduler``): between any two decode
steps it admits queued requests into free slots (prefill), evicts
finished sequences, and never drains the in-flight batch to make room.
Request classes map onto decode SLOs (serve/router.DECODE_SLO_TARGETS):
`latency_sensitive` requests jump the admission queue, `best_effort`
fill the remaining slots. ``mode="static"`` is the measured baseline:
admit a batch, decode until EVERY member finishes, only then admit
again — same shapes, same per-request streams, worse tail TTFT.
``runahead=1`` (the default) overlaps host scheduling with the device
step in continuous mode: dispatch the step without syncing
(`decode_async`), do the admission bookkeeping and page allocation while
the card computes, then harvest the token ids (`decode_harvest`) and
prefill the admitted batch. Overlap moves WHEN a request is admitted, by
at most one step, never the tokens it produces.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import threading
import time
from collections import deque
from concurrent.futures import Future

import numpy as np
import torch

from dist_mnist_tpu_torch.cluster.mesh import MODEL_AXIS, activate
from dist_mnist_tpu_torch.serve.admission import (
    QueueFullError,
    ShuttingDownError,
)
from dist_mnist_tpu_torch.serve.engine import _nbytes
from dist_mnist_tpu_torch.serve.metrics import DecodeMetrics
from dist_mnist_tpu_torch.serve.router import (
    BEST_EFFORT,
    LATENCY_SENSITIVE,
    REQUEST_CLASSES,
)
from dist_mnist_tpu_torch.utils.device import resolve_device
from dist_mnist_tpu_torch.utils.tree import leaves, tree_map

log = logging.getLogger(__name__)

#: scheduler idle poll (waiting for the first/next request), as
#: serve/batcher.py
_IDLE_POLL_SECS = 0.05

_SCHED_IDS = itertools.count()


class DecodeEngine:
    """Prefill/decode steps on one device + the KV cache they share; with
    a tensor-parallel `mesh`, this rank's heads of them (module
    docstring).

    Single-owner: the in-place cache makes concurrent callers
    meaningless; the scheduler thread is its one caller (the chief's,
    under TP; a follower's caller is `follow`)."""

    def __init__(self, model, params, device=None, *, grid=None,
                 max_slots: int = 8, num_pages: int | None = None,
                 mesh=None):
        from dist_mnist_tpu_torch.serve.zoo import default_decode_grid

        self.model = model
        self.mesh = mesh if mesh is not None and mesh.model > 1 else None
        self.device = resolve_device(device)
        self.grid = grid if grid is not None else default_decode_grid(
            model, max_slots=max_slots)
        self.max_slots = self.grid.max_slots
        self.max_seq = int(model.max_seq)
        if self.grid.max_seq != self.max_seq:
            raise ValueError(f"grid max_seq {self.grid.max_seq} != model "
                             f"max_seq {self.max_seq}")
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.layout = getattr(model, "cache_layout", "dense")
        self.kv_quant = getattr(model, "kv_quant", "none")
        self.page_tokens = (int(model.kv_page_tokens)
                            if self.layout == "paged" else 0)
        if self.layout == "paged":
            if not self.grid.decode_page_buckets:
                raise ValueError(
                    "paged model needs a grid with decode_page_buckets "
                    "(serve/zoo.default_decode_grid derives them)")
            if self.grid.decode_page_buckets[-1] != model.pages_per_slot:
                raise ValueError(
                    f"widest decode page bucket "
                    f"{self.grid.decode_page_buckets[-1]} != "
                    f"pages_per_slot {model.pages_per_slot}")
            self.kv = model.init_cache(self.grid.rows, num_pages=num_pages,
                                       device=self.device, mesh=self.mesh)
        else:
            if self.grid.decode_page_buckets:
                raise ValueError("dense model with paged decode buckets")
            self.kv = model.init_cache(self.grid.rows, device=self.device,
                                       mesh=self.mesh)
        #: this rank's KV allocation (under TP its heads' share)
        self.rank_kv_bytes = sum(_nbytes(t) for t in leaves(self.kv))
        self._params_bytes = sum(_nbytes(t) for t in leaves(self.params))
        # the whole cache's, as the reference counts it
        self._kv_bytes = self.rank_kv_bytes * self.model_ranks
        #: decode steps issued, prewarm included: each launches one
        #: attention kernel per layer on the int8-paged and flash layouts
        self.decode_steps = 0
        self._served = False
        self._closed = False
        if self.layout == "paged":
            pps = int(model.pages_per_slot)
            self.num_pages = int(leaves(self.kv)[0].shape[1])
            if self.num_pages < 2 * pps:
                raise ValueError(
                    f"num_pages {self.num_pages} < {2 * pps}: the pool "
                    "needs the scratch stripe plus at least one full slot")
            self._page_bytes = self._kv_bytes // self.num_pages
            # the LAST pages_per_slot page ids are the permanent scratch
            # stripe: the scratch row's table points at them forever, and
            # every unallocated table entry aliases them
            self._scratch_pages = np.arange(self.num_pages - pps,
                                            self.num_pages, dtype=np.int32)
            self._free_pages = list(range(self.num_pages - pps))
            self._slot_pages: dict = {}
            self._page_table = np.tile(self._scratch_pages,
                                       (self.grid.rows, 1))
            self._table_device: dict = {}
            self._peak_pinned = 0

    @property
    def model_ranks(self) -> int:
        """Ranks the heads split over (1 without TP)."""
        return 1 if self.mesh is None else self.mesh.model

    @property
    def is_follower(self) -> bool:
        """A TP rank other than its model group's chief."""
        return self.mesh is not None and self.mesh.model_index != 0

    def resident_bytes_per_device(self) -> int:
        """Params plus the resident KV bytes (dense: the allocation;
        paged: the scratch stripe and the pinned pages) over the model
        ranks: the reference's per-device budget floor (its
        `set_base_bytes`)."""
        if self.layout != "paged":
            kv = self._kv_bytes
        else:
            kv = self._page_bytes * (len(self._scratch_pages)
                                     + self._pinned())
        return (self._params_bytes + kv) // self.model_ranks

    # -- the follower protocol (tensor parallelism) -------------------------

    def _broadcast(self, msg=None):
        """The chief's `msg` on every rank of the model group."""
        box = [msg]
        torch.distributed.broadcast_object_list(
            box, src=self.mesh.model_chief,
            group=self.mesh.host_groups[MODEL_AXIS])
        return box[0]

    def _announce(self, op: str, *args) -> None:
        """Chief: tell the followers which call comes next, with its host
        inputs and the page table as it stands."""
        if self.mesh is None:
            return
        if self.is_follower:
            raise RuntimeError("a follower engine runs only the chief's "
                               "calls (follow)")
        table = self._page_table.copy() if self.layout == "paged" else None
        self._broadcast((op, *args, table))

    def follow(self) -> int:
        """Follower: run the chief's prefill and decode calls on this
        rank's heads until the chief's `close`; returns the calls run. An
        error propagates: this rank's exit fails the chief's next
        collective."""
        if not self.is_follower:
            raise RuntimeError("follow() runs on a TP rank other than the "
                               "model group's chief")
        calls = 0
        while True:
            op, *args = self._broadcast()
            if op == "stop":
                return calls
            table = args.pop()
            if table is not None and not np.array_equal(table,
                                                        self._page_table):
                self._page_table = table
                self._table_device.clear()
            if op == "prefill":
                self._exec_prefill(*args)
            elif op == "decode":
                self._exec_decode(*args)
            else:
                raise RuntimeError(f"unknown follower call {op!r}")
            calls += 1

    def close(self) -> None:
        """Chief under TP: send the followers the stop message. No-op
        otherwise; idempotent."""
        if self.mesh is None or self.is_follower or self._closed:
            return
        self._closed = True
        self._broadcast(("stop",))

    # -- paged-cache page management (host-owned; no-ops for dense) ---------

    def _device_table(self, width: int) -> torch.Tensor:
        """The page table's first `width` columns on the device, cached
        until an alloc/free dirties it. The copy is made from a fresh host
        buffer and waits for the transfer, so later host-side edits of
        the numpy table never reach a step already dispatched."""
        tab = self._table_device.get(width)
        if tab is None:
            host = torch.from_numpy(self._page_table[:, :width].copy())
            tab = host.to(self.device)
            self._table_device[width] = tab
        return tab

    def try_reserve(self, slot: int, total_len: int) -> bool:
        """Pin the pages `slot` needs for a prompt + full generation of
        `total_len` tokens; False when the free pool can't cover it (the
        scheduler defers the admission). Dense layout: always True."""
        if self.layout != "paged":
            return True
        n = -(-int(total_len) // self.page_tokens)
        if n > self._page_table.shape[1]:
            raise ValueError(f"{total_len} tokens need {n} pages > "
                             f"pages_per_slot {self._page_table.shape[1]}")
        if len(self._free_pages) < n:
            return False
        pages = [self._free_pages.pop(0) for _ in range(n)]
        self._page_table[slot, :n] = pages
        self._slot_pages[slot] = pages
        self._table_device.clear()
        self._peak_pinned = max(self._peak_pinned, self._pinned())
        return True

    def release_slot(self, slot: int) -> None:
        """Reclaim a finished slot's pages and re-alias its table row to
        the scratch stripe. Idempotent; no-op for dense."""
        if self.layout != "paged":
            return
        pages = self._slot_pages.pop(slot, None)
        if not pages:
            return
        self._free_pages.extend(pages)
        self._page_table[slot] = self._scratch_pages
        self._table_device.clear()

    def reset_pages(self) -> None:
        """Reclaim EVERY slot's pages (the scheduler's crash recovery)."""
        if self.layout != "paged":
            return
        for slot in list(self._slot_pages):
            self.release_slot(slot)

    def _pinned(self) -> int:
        return sum(len(p) for p in self._slot_pages.values())

    def kv_stats(self) -> dict:
        """Residency counters: pages and bytes pinned vs the pool. Dense
        reports its whole allocation as pinned — that IS its residency."""
        if self.layout != "paged":
            return {"layout": "dense", "kv_quant": self.kv_quant,
                    "page_tokens": 0, "kv_pages_total": 0,
                    "kv_pages_pinned": 0,
                    "kv_bytes_pinned": self._kv_bytes,
                    "kv_bytes_peak": self._kv_bytes,
                    "kv_bytes_pool": self._kv_bytes}
        pinned = self._pinned()
        scratch = len(self._scratch_pages)
        return {"layout": "paged", "kv_quant": self.kv_quant,
                "page_tokens": self.page_tokens,
                "kv_pages_total": self.num_pages,
                "kv_pages_pinned": pinned,
                "kv_bytes_pinned": self._page_bytes * pinned,
                # high-water residency incl. the scratch stripe: what the
                # bench's <= 0.35x-dense gate is held against
                "kv_bytes_peak": self._page_bytes
                * (scratch + self._peak_pinned),
                "kv_bytes_pool": self._page_bytes * self.num_pages}

    # -- execution ----------------------------------------------------------

    def prewarm(self) -> int:
        """Run every grid cell once before traffic, so the kernels' build
        and the library handles are paid here; returns the cells run.

        Prefill cells write only the scratch row (or scratch pages), but a
        decode cell writes position 0 of every row, so this refuses to
        run once the engine has served a request."""
        if self._served:
            raise RuntimeError("prewarm runs before traffic: a decode "
                               "cell writes every row of the cache")
        rows = self.grid.rows
        scratch = self.max_slots
        for cell in self.grid.cells():
            if cell[0] == "prefill":
                _, n_b, s_b = cell
                self._run_prefill(np.zeros((n_b, s_b), np.int32),
                                  np.full((n_b,), scratch, np.int32),
                                  np.ones((n_b,), np.int32))
            else:
                zeros = np.zeros(rows, np.int32)
                width = cell[1] if len(cell) > 1 else None
                self.decode_harvest(self._run_decode(zeros, zeros, width))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return len(self.grid.cells())

    def _run_prefill(self, tokens, slots, lengths) -> torch.Tensor:
        self._announce("prefill", tokens, slots, lengths)
        return self._exec_prefill(tokens, slots, lengths)

    def _exec_prefill(self, tokens, slots, lengths) -> torch.Tensor:
        dev = self.device
        table = (self._device_table(self._page_table.shape[1])
                 if self.layout == "paged" else None)
        with torch.no_grad(), activate(self.mesh):
            last, _ = self.model.prefill(
                self.params, self.kv, torch.from_numpy(tokens).to(dev),
                torch.from_numpy(slots).to(dev),
                torch.from_numpy(lengths).to(dev), page_table=table)
            return torch.argmax(last, dim=-1).to(torch.int32)

    def prefill(self, prompts: list, slot_ids: list) -> np.ndarray:
        """Land `prompts[i]` (1-D int32 arrays) in cache slot
        `slot_ids[i]` and return each prompt's FIRST generated token
        ``[len(prompts)]`` int32. Requests are grouped by their own
        prompt bucket, each group chunked to the admit buckets; padding
        rows prefill a length-1 dummy into the scratch row."""
        self._served = True
        out = np.zeros(len(prompts), np.int32)
        groups: dict = {}
        for i, p in enumerate(prompts):
            groups.setdefault(self.grid.prompt_bucket_for(len(p)),
                              []).append(i)
        max_admit = self.grid.admit_buckets[-1]
        scratch = self.max_slots
        for s_b, idxs in sorted(groups.items()):
            for at in range(0, len(idxs), max_admit):
                chunk = idxs[at:at + max_admit]
                n_b = self.grid.admit_bucket_for(len(chunk))
                tokens = np.zeros((n_b, s_b), np.int32)
                slots = np.full((n_b,), scratch, np.int32)
                lengths = np.ones((n_b,), np.int32)
                for row, i in enumerate(chunk):
                    tokens[row, :len(prompts[i])] = prompts[i]
                    slots[row] = slot_ids[i]
                    lengths[row] = len(prompts[i])
                # one sync per admission: the scheduler needs the first
                # tokens on the host
                first = self._run_prefill(tokens, slots, lengths).cpu()
                for row, i in enumerate(chunk):
                    out[i] = int(first[row])
        return out

    def _run_decode(self, tokens, positions,
                    width: int | None) -> torch.Tensor:
        """One decode step; `width` is the page-table bucket (paged)."""
        self._announce("decode", tokens, positions, width)
        return self._exec_decode(tokens, positions, width)

    def _exec_decode(self, tokens, positions,
                     width: int | None) -> torch.Tensor:
        dev = self.device
        table = self._device_table(width) if width is not None else None
        with torch.no_grad(), activate(self.mesh):
            logits, _ = self.model.decode_step(
                self.params, self.kv, torch.from_numpy(tokens).to(dev),
                torch.from_numpy(positions).to(dev), page_table=table)
            # greedy argmax on the device: the host reads token ids only
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        self.decode_steps += 1
        return nxt

    def decode_async(self, tokens, positions) -> torch.Tensor:
        """Dispatch one decode step WITHOUT waiting for it: returns the
        next-token vector on the device. Pair with `decode_harvest`; the
        scheduler's runahead runs host bookkeeping in between. Paged
        engines take the smallest page bucket covering the live prefix
        (host arithmetic over positions the caller already holds)."""
        self._served = True
        tokens = np.array(tokens, np.int32)  # copies: the caller mutates
        positions = np.array(positions, np.int32)
        width = None
        if self.layout == "paged":
            needed = -(-(int(positions.max()) + 1) // self.page_tokens)
            width = self.grid.decode_page_bucket_for(needed)
        return self._run_decode(tokens, positions, width)

    def decode_harvest(self, nxt: torch.Tensor) -> np.ndarray:
        """Wait for a `decode_async` result and return host token ids."""
        return nxt.cpu().numpy()

    def decode(self, tokens, positions) -> np.ndarray:
        """One step for every slot row: each row's latest token at its
        position in, next-token ids ``[rows]`` int32 out. Idle rows
        compute garbage that their next prefill overwrites."""
        return self.decode_harvest(self.decode_async(tokens, positions))


@dataclasses.dataclass
class DecodeResult:
    """One finished request: the greedy token stream plus its timeline.
    `token_times` are monotonic stamps, one per token —
    ``token_times[0] - t_submit`` is the TTFT."""

    tokens: list
    ttft_ms: float
    latency_ms: float
    token_times: list
    request_class: str
    prompt_len: int


class _Request:
    __slots__ = ("prompt", "max_new_tokens", "request_class", "future",
                 "t_submit", "tokens", "token_times", "slot")

    def __init__(self, prompt, max_new_tokens, request_class):
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.request_class = request_class
        self.future: Future = Future()
        self.t_submit = time.monotonic()
        self.tokens: list = []
        self.token_times: list = []
        self.slot: int | None = None


class DecodeScheduler:
    """Slot-allocating batcher over a `DecodeEngine` (one daemon thread).

    ``mode="continuous"``: between steps, free slots are refilled from the
    queue (latency_sensitive first) and finished sequences evicted.
    ``mode="static"``: admission only when NO sequence is in flight. Both
    run the same shapes in the same per-request order, so streams are
    identical — scheduling changes WHEN a request runs, never WHAT it
    computes."""

    def __init__(self, engine: DecodeEngine, *, mode: str = "continuous",
                 max_queue: int = 256, metrics: DecodeMetrics | None = None,
                 runahead: int = 1):
        if mode not in ("continuous", "static"):
            raise ValueError(f"unknown mode {mode!r}; "
                             "use 'continuous' | 'static'")
        if runahead not in (0, 1):
            raise ValueError("runahead must be 0 (serial) or 1 (overlap "
                             "host scheduling with the device step)")
        self.engine = engine
        self.mode = mode
        self.runahead = runahead
        self.max_queue = max_queue
        self.metrics = metrics if metrics is not None else DecodeMetrics()
        self._lock = threading.Lock()
        self._work = threading.Event()
        self._stop = threading.Event()
        self._closed = False
        self._pending = {c: deque() for c in REQUEST_CLASSES}
        self._free = list(range(engine.max_slots))
        self._active: dict = {}
        rows = engine.grid.rows
        self._tokens = np.zeros(rows, np.int32)
        self._positions = np.zeros(rows, np.int32)
        #: admission order as (submit_seq, request_class)
        self.admit_log: list = []
        self._seq = itertools.count()
        self._thread = threading.Thread(
            target=self._loop,
            name=f"DecodeScheduler-{next(_SCHED_IDS)}", daemon=True)
        self._thread.start()

    # -- client surface -----------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, *,
               request_class: str = BEST_EFFORT) -> Future:
        """Enqueue one request; the Future resolves to a `DecodeResult`."""
        if request_class not in REQUEST_CLASSES:
            raise ValueError(f"unknown request class {request_class!r}")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        vocab = self.engine.model.vocab_size
        if prompt.min() < 0 or prompt.max() >= vocab:
            raise ValueError(f"prompt tokens must be in [0, vocab_size="
                             f"{vocab})")
        if prompt.size + max_new_tokens > self.engine.max_seq:
            raise ValueError(
                f"prompt {prompt.size} + max_new_tokens {max_new_tokens} "
                f"> max_seq {self.engine.max_seq}")
        req = _Request(prompt, int(max_new_tokens), request_class)
        with self._lock:
            if self._closed:
                self.metrics.record_rejected("shutdown")
                raise ShuttingDownError("decode scheduler is shutting down")
            depth = sum(len(q) for q in self._pending.values())
            if depth >= self.max_queue:
                self.metrics.record_rejected("queue_full")
                raise QueueFullError(f"decode queue full ({self.max_queue})")
            self._pending[request_class].append((next(self._seq), req))
            self.metrics.record_submitted(request_class)
        self._work.set()
        return req.future

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return sum(len(q) for q in self._pending.values())

    @property
    def active_count(self) -> int:
        with self._lock:
            return len(self._active)

    @property
    def free_slots(self) -> int:
        with self._lock:
            return len(self._free)

    def drain(self, timeout: float = 30.0) -> bool:
        """Stop admitting, let everything queued/in flight finish, then
        shut the thread down. False on timeout (close still runs)."""
        with self._lock:
            self._closed = True
        deadline = time.monotonic() + timeout
        ok = True
        while time.monotonic() < deadline:
            with self._lock:
                empty = (not self._active
                         and not any(self._pending.values()))
            if empty:
                break
            time.sleep(0.005)
        else:
            ok = False
        self.close()
        return ok

    def close(self) -> None:
        """Reject new submissions, stop the loop, join the thread, fail
        every unfinished future with ShuttingDownError. Idempotent."""
        with self._lock:
            self._closed = True
        self._stop.set()
        self._work.set()
        if self._thread.is_alive():
            self._thread.join(timeout=30.0)
        orphans = []
        with self._lock:
            for q in self._pending.values():
                orphans.extend(req for _, req in q)
                q.clear()
            orphans.extend(self._active.values())
            self._active.clear()
            self.engine.reset_pages()
        for req in orphans:
            if not req.future.done():
                req.future.set_exception(
                    ShuttingDownError("decode scheduler closed"))
                self.metrics.record_failed()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- scheduler loop -----------------------------------------------------

    def _take_admissions(self) -> list:
        """Pop (request, slot) assignments under the lock: the LS queue
        before BE, one free slot each. Paged engines also pin the slot's
        pages; a request whose pages don't fit stays at the HEAD of its
        queue until evictions reclaim enough of the pool."""
        out = []
        with self._lock:
            while self._free:
                for cls in (LATENCY_SENSITIVE, BEST_EFFORT):
                    if self._pending[cls]:
                        seq, req = self._pending[cls][0]
                        total = int(req.prompt.size) + req.max_new_tokens
                        if not self.engine.try_reserve(self._free[0], total):
                            return out
                        self._pending[cls].popleft()
                        req.slot = self._free.pop(0)
                        self.admit_log.append((seq, cls))
                        out.append(req)
                        break
                else:
                    break
        return out

    def _admit(self, reqs: list) -> None:
        first = self.engine.prefill([r.prompt for r in reqs],
                                    [r.slot for r in reqs])
        now = time.monotonic()
        finished = []
        with self._lock:
            for r, tok in zip(reqs, first):
                r.tokens.append(int(tok))
                r.token_times.append(now)
                self.metrics.record_admitted((now - r.t_submit) * 1e3,
                                             r.request_class)
                self._active[r.slot] = r
                self._tokens[r.slot] = int(tok)
                self._positions[r.slot] = r.prompt.size
                if len(r.tokens) >= r.max_new_tokens:
                    finished.append(r)
            for r in finished:
                self._finish_locked(r, now)

    def _finish_locked(self, r, now: float) -> None:
        slot = r.slot
        self._active.pop(slot, None)
        self.engine.release_slot(slot)
        self._free.append(slot)
        self._tokens[slot] = 0
        self._positions[slot] = 0
        latency_ms = (now - r.t_submit) * 1e3
        wall = max(now - r.t_submit, 1e-9)
        self.metrics.record_completed(latency_ms, len(r.tokens),
                                      len(r.tokens) / wall)
        r.future.set_result(DecodeResult(
            tokens=list(r.tokens),
            ttft_ms=(r.token_times[0] - r.t_submit) * 1e3,
            latency_ms=latency_ms,
            token_times=list(r.token_times),
            request_class=r.request_class,
            prompt_len=int(r.prompt.size)))

    def _harvest(self, nxt_dev) -> None:
        nxt = self.engine.decode_harvest(nxt_dev)
        now = time.monotonic()
        with self._lock:
            self.metrics.record_step(len(self._active))
            finished = []
            for slot in sorted(self._active):
                r = self._active[slot]
                tok = int(nxt[slot])
                r.tokens.append(tok)
                r.token_times.append(now)
                self._positions[slot] += 1
                self._tokens[slot] = tok
                if len(r.tokens) >= r.max_new_tokens:
                    finished.append(r)
            for r in finished:
                self._finish_locked(r, now)

    def _loop(self) -> None:
        overlap = self.runahead > 0
        while not self._stop.is_set():
            try:
                if not self._active or (self.mode == "continuous"
                                        and not overlap):
                    reqs = self._take_admissions()
                    if reqs:
                        self._admit(reqs)
                if self._active:
                    nxt_dev = self.engine.decode_async(self._tokens,
                                                       self._positions)
                    reqs = []
                    if overlap and self.mode == "continuous":
                        # host/device overlap: admission bookkeeping and
                        # page allocation run while the step computes;
                        # the admitted batch prefills after the harvest
                        reqs = self._take_admissions()
                    self._harvest(nxt_dev)
                    if reqs:
                        self._admit(reqs)
                    continue
            except Exception:  # keep serving: fail the in-flight batch
                log.exception("decode scheduler step failed")
                with self._lock:
                    broken = list(self._active.values())
                    self._active.clear()
                    self.engine.reset_pages()
                    self._free = list(range(self.engine.max_slots))
                for r in broken:
                    if not r.future.done():
                        r.future.set_exception(
                            RuntimeError("decode step failed"))
                        self.metrics.record_failed()
                continue
            with self._lock:
                idle = not any(self._pending.values())
            if idle:
                self._work.wait(_IDLE_POLL_SECS)
                self._work.clear()
