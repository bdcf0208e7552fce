"""Tiny causal autoregressive transformer — the decode-serving workload
(port of the reference `models/causal_lm.py`).

Pre-LN blocks with learned positions and the `ops/nn` attention params.
Two forward surfaces over one set of weights: `apply`/`prefill` run
whole sequences under a triangular mask (prefill also lands every
position's K/V in a cache), and `decode_step` runs ONE new token per row
against the cache. Both share `_attend`.

Cache layouts (``cache_layout``):

- ``"dense"``: ``[depth, rows, max_seq, heads, head_dim]``, one stripe per
  row.
- ``"paged"``: a page POOL ``[depth, pages, page_tokens, heads,
  head_dim]`` plus a caller-owned int32 page table ``[rows, n]``: row r's
  positions ``[j*T, (j+1)*T)`` live in pool page ``table[r, j]``. Float
  pools decode at the FULL table width: the gather rebuilds the dense
  ``[rows, max_seq, H, D]`` view exactly and the same `_attend` runs on
  it, so paged-float logits equal the dense ones bit for bit. With
  ``kv_quant="int8"`` the pools are `ops/quant.QuantizedArray` nodes
  (int8 plus per-token-per-head f32 scales, `quantize_kv`), quantized as
  they are written and read by the hand-written `paged_attention` kernel
  at a truncated table width (`ops/kernels/paged_attention.py`); that
  path is held by token agreement, not bits.

``attention_impl="flash"`` runs the dense decode step's attention on the
hand-written `masked_flash_attention` kernel (lengths ``pos + 1``: the
decode mask is exactly a key prefix, so key blocks past each row's
frontier are skipped); prefill and the full forward keep `_attend`.

Differences from the reference, all forced by eager PyTorch:

- The cache is updated IN PLACE (JAX returns a new, donated one);
  `prefill`/`decode_step` still return it, for the same call shape.
- Duplicate scatter indices: padding rows of a prefill all point at the
  scratch row (dense) or the scratch pages (paged), and idle decode rows
  of a paged step all write page ``table[r, 0]`` of the scratch stripe.
  `index_put_` on CUDA leaves the winner of duplicate writes undefined;
  that is harmless because no live row ever reads scratch (a live row
  overwrites position p before any mask admits it), and it is the ONLY
  place rows collide.
- Tensor parallelism: the reference runs its attention under
  `shard_map` with the heads over a ``model`` mesh axis. Here, under an
  ambient mesh (`cluster/mesh.activate`) whose model axis is wider than
  one, each rank of the model group computes q/k/v for every head, takes
  its contiguous head slice ``[..., m*H/M:(m+1)*H/M, :]`` (contiguous
  before any kernel), attends over its own head slice of the KV cache
  (`init_cache(mesh=)` holds H/M heads a rank; an int8 paged cache runs
  the `paged_attention` kernel on those heads), and all-gathers the
  outputs over heads; the out-projection, the MLP, the final LN and the
  head run replicated. Every contraction is per head, so the logits are
  the same bits on every rank and equal to the unsharded model's (the
  reference's contract). A dense cache under TP stays on `_attend`
  whatever `attention_impl` is, as in the reference.

Bitwise decode == full forward (``attention_impl="xla"``): every
contraction — `_attend`'s two, as in the reference, and the dense layers
too (`_dense`) — is a broadcast multiply plus a sum over one axis whose
order depends on that axis alone (`nn.ordered_sum`), and the forward's
softmax rows have the decode step's length, so on the CPU an incremental
decode equals the full forward at every position
(tests/test_torch_decode.py). `chip_smoke.py` checks the same on the
card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from dist_mnist_tpu_torch.cluster.mesh import ambient_mesh
from dist_mnist_tpu_torch.ops import nn
from dist_mnist_tpu_torch.ops.kernels.masked_flash import (
    masked_flash_attention,
)
from dist_mnist_tpu_torch.ops.kernels.paged_attention import paged_attention
from dist_mnist_tpu_torch.ops.quant import QuantizedArray, quantize_kv
from dist_mnist_tpu_torch.parallel.collectives import (
    gather_from_model,
    scatter_to_model,
)


def _inv_sqrt(d: int) -> float:
    """``1 / sqrt(d)`` rounded as the reference computes it, in f32."""
    return float(np.float32(1.0) / np.sqrt(np.float32(d)))


def _attend(q, k, v, mask, softmax_len: int | None = None):
    """Masked multi-head attention: q ``[B,Sq,H,D]`` against k/v
    ``[B,Sk,H,D]`` with a boolean mask ``[B,Sq,Sk]`` (True = attend); f32
    scores and softmax whatever the activation dtype.

    Both contractions are a broadcast multiply plus a sum over one axis,
    not a GEMM, so each output element is summed over its own axis alone:
    over head_dim (a fixed length) by `sum`, over the keys by
    `nn.ordered_sum`, so the decode step's max_seq keys (masked past its
    position) and the forward's S keys sum alike. `softmax_len` (>= Sk)
    pads each score row with masked slots to that length before the
    softmax, which also sums a row in an order set by its length: the
    full forward passes ``max_seq``, the row length the decode step's
    softmax sees. The padded slots weigh exactly 0 and are dropped."""
    dh = q.shape[-1]
    sk = k.shape[1]
    # [B,Sq,Sk,H] <- sum_d q[B,Sq,1,H,D] * k[B,1,Sk,H,D]
    scores = (q.to(torch.float32)[:, :, None]
              * k.to(torch.float32)[:, None]).sum(-1)
    scores = scores.permute(0, 3, 1, 2) * _inv_sqrt(dh)  # [B,H,Sq,Sk]
    scores = torch.where(mask[:, None], scores,
                         torch.full((), -1e30, device=scores.device))
    if softmax_len is not None and softmax_len > sk:
        scores = F.pad(scores, (0, softmax_len - sk), value=-1e30)
    weights = torch.softmax(scores, dim=-1)[..., :sk].to(v.dtype)
    # [B,H,Sq,D] <- sum_k w[B,H,Sq,Sk,1] * v[B,H,1,Sk,D]
    out = nn.ordered_sum(
        weights[..., None] * v.permute(0, 2, 1, 3)[:, :, None], 3)
    return out.permute(0, 2, 1, 3)  # [B,Sq,H,D]


def _dense(p, x):
    """``x @ w + b`` as a broadcast multiply and an `nn.ordered_sum` over
    the contraction axis, so each output row is summed on its own,
    whatever the number of rows. A GEMM is not row-independent — MKL takes
    other paths for one row and for the rows past its micro-tiles, cuBLAS
    another kernel for another M — so the decode step (R rows) and the
    full forward (B*S rows) would round the same row apart."""
    w = p["w"].to(x.dtype)
    return nn.ordered_sum(x[..., :, None] * w, -2) + p["b"].to(x.dtype)


def _layer_pool(pool, i):
    """Layer i's slice of a stacked ``[depth, ...]`` pool: a view, so
    writes through it land in the stack."""
    if isinstance(pool, QuantizedArray):
        return QuantizedArray(pool.q[i], pool.scale[i], pool.mode)
    return pool[i]


def _pool_write(pool, page_ids, offs, new):
    """``pool[page_ids, offs] = new`` (float pool) or its quantized
    tokens (int8 pool); index tensors of one shape, ``new`` that shape +
    ``[H, D]``."""
    if isinstance(pool, QuantizedArray):
        q, s = quantize_kv(new)
        pool.q[page_ids, offs] = q
        pool.scale[page_ids, offs] = s
    else:
        pool[page_ids, offs] = new.to(pool.dtype)


def _paged_read(pool, page_table):
    """Gather a float pool's table pages into the dense view
    ``[R, n*T, H, D]`` that `_attend` consumes."""
    k = pool[page_table.long()]
    r, n, t, h, d = k.shape
    return k.reshape(r, n * t, h, d)


def _heads_spec(mesh, heads: int):
    """The mesh whose model axis shards the heads, or None when it cannot
    (no mesh, or a model axis of one). Raises on an indivisible head
    count, as the reference: silently replicating a "TP" cache would
    defeat the memory story."""
    m = mesh.model if mesh is not None else 1
    if m <= 1:
        return None
    if heads % m:
        raise ValueError(
            f"heads={heads} not divisible by model axis {m}; "
            "the TP-sharded KV cache needs heads % model == 0"
        )
    return mesh


def _attend_gather(q, k, v, mask, mesh, softmax_len=None):
    """The full-sequence attention under TP: `_attend` over this rank's
    heads (q, k, v local), then the outputs gathered over heads, so the
    result leaves the model group replicated and bitwise the unsharded
    `_attend`'s (every contraction is per head)."""
    return gather_from_model(_attend(q, k, v, mask, softmax_len), mesh, 2)


@dataclasses.dataclass(frozen=True)
class CausalLMTiny:
    """Small decoder-only LM over a synthetic token alphabet (the
    reference's geometry and params tree: `tok_emb`, `pos`, `final_ln`,
    `lm_head`, and ``block{i}/{ln1, attn/{qkv, out}, ln2, mlp_in,
    mlp_out}``)."""

    vocab_size: int = 256
    dim: int = 64
    depth: int = 2
    heads: int = 4
    mlp_ratio: int = 4
    max_seq: int = 64
    compute_dtype: torch.dtype = torch.float32
    # "xla": `_attend` everywhere (decode bit-matches the full forward on
    # the CPU). "flash": the dense decode step's attention runs the
    # masked_flash_attention kernel.
    attention_impl: str = "xla"
    cache_layout: str = "dense"
    kv_page_tokens: int = 16
    kv_quant: str = "none"

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads

    @property
    def pages_per_slot(self) -> int:
        """Pages covering one row's whole max_seq stripe (paged layout)."""
        return self.max_seq // self.kv_page_tokens

    def _validate(self) -> None:
        if self.dim % self.heads:
            raise ValueError(f"dim {self.dim} % heads {self.heads} != 0")
        if self.attention_impl not in ("xla", "flash"):
            raise ValueError(
                f"unknown attention_impl {self.attention_impl!r}; use 'xla' "
                "(bit-exact decode) or 'flash' (the masked flash kernel)")
        if self.cache_layout not in ("dense", "paged"):
            raise ValueError(f"unknown cache_layout {self.cache_layout!r}; "
                             "use 'dense' | 'paged'")
        if self.kv_quant not in ("none", "int8"):
            raise ValueError(
                f"unknown kv_quant {self.kv_quant!r}; use 'none' | 'int8'")
        if self.kv_quant == "int8" and self.cache_layout != "paged":
            raise ValueError("kv_quant='int8' is a paged-layout feature; "
                             "set cache_layout='paged'")
        if self.cache_layout == "paged" and (
                self.kv_page_tokens < 1
                or self.max_seq % self.kv_page_tokens):
            raise ValueError(
                f"kv_page_tokens={self.kv_page_tokens} must divide "
                f"max_seq={self.max_seq} — whole pages keep the paged float "
                "path bitwise equal to dense")

    def init(self, gen: torch.Generator, sample_input=None):
        """Fresh params from `gen` (the reference's distributions, not its
        bits: tests carry the reference's params across with
        `convert.params_from_jax`)."""
        del sample_input  # only the geometry fields size the params
        self._validate()
        d = self.dim
        params: dict = {
            "tok_emb": 0.02 * torch.randn(self.vocab_size, d, generator=gen),
            "pos": 0.02 * torch.randn(1, self.max_seq, d, generator=gen),
            "final_ln": nn.init_layer_norm(d),
            "lm_head": nn.init_dense(gen, d, self.vocab_size,
                                     init=nn.xavier_uniform),
        }
        for i in range(self.depth):
            params[f"block{i}"] = {
                "ln1": nn.init_layer_norm(d),
                "attn": nn.init_attention(gen, d, self.heads),
                "ln2": nn.init_layer_norm(d),
                "mlp_in": nn.init_dense(gen, d, d * self.mlp_ratio,
                                        init=nn.xavier_uniform),
                "mlp_out": nn.init_dense(gen, d * self.mlp_ratio, d,
                                         init=nn.xavier_uniform),
            }
        return params, {}

    def _qkv(self, p, x, tp=None):
        """q, k, v ``[B, S, H, D]``; under `tp` this rank's heads."""
        b, s, _ = x.shape
        qkv = _dense(p["qkv"], x).reshape(b, s, 3, self.heads,
                                            self.head_dim)
        q, k, v = qkv.unbind(2)
        if tp is None:
            return q, k, v
        return tuple(scatter_to_model(t, tp, 2) for t in (q, k, v))

    def _mlp(self, p, x):
        y = nn.layer_norm(p["ln2"], x)
        return x + _dense(p["mlp_out"], nn.gelu(_dense(p["mlp_in"], y)))

    def _forward(self, params, tokens):
        """Full-sequence causal forward: tokens ``[B,S]`` -> (logits
        ``[B,S,V]`` f32, per-layer (k, v) list; under TP this rank's
        heads of k and v). Positions past a prompt's real length give
        garbage logits that, by causality, never reach earlier
        positions."""
        b, s = tokens.shape
        if s > self.max_seq:
            raise ValueError(f"sequence {s} > max_seq {self.max_seq}")
        x = params["tok_emb"][tokens.long()].to(self.compute_dtype)
        x = x + params["pos"][:, :s].to(x.dtype)
        causal = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                       device=x.device))[None].expand(b, s, s)
        tp = _heads_spec(ambient_mesh(), self.heads)
        kv = []
        for i in range(self.depth):
            p = params[f"block{i}"]
            y = nn.layer_norm(p["ln1"], x)
            q, k, v = self._qkv(p["attn"], y, tp)
            if tp is None:
                o = _attend(q, k, v, causal, softmax_len=self.max_seq)
            else:
                o = _attend_gather(q, k, v, causal, tp,
                                   softmax_len=self.max_seq)
            x = x + _dense(p["attn"]["out"], o.reshape(b, s, self.dim))
            x = self._mlp(p, x)
            kv.append((k, v))
        x = nn.layer_norm(params["final_ln"], x)
        logits = _dense(params["lm_head"], x)
        return logits.to(torch.float32), kv

    def apply(self, params, state, x, *, train=False, rng=None):
        """Model-protocol forward: next-token logits at every position."""
        del train, rng
        logits, _ = self._forward(params, x)
        return logits, state

    def flops_per_example(self, sample_shape) -> float:
        """Analytic forward FLOPs (matmul MACs x2), as the reference."""
        s = int(sample_shape[1])
        d = self.dim
        per_block = (s * 3 * d * d * 2 + 2 * s * s * d * 2 + s * d * d * 2
                     + 2 * s * d * (d * self.mlp_ratio) * 2)
        head = s * d * self.vocab_size * 2
        return float(self.depth * per_block + head)

    # ---- serving surface (serve/decode.py) --------------------------------

    def init_cache(self, slots: int, *, num_pages: int | None = None,
                   device=None, mesh=None) -> dict:
        """Zero-filled KV cache on `device`. dense: ``[depth, slots,
        max_seq, heads, head_dim]`` per tensor. paged: pools ``[depth,
        num_pages, page_tokens, heads, head_dim]`` (default ``slots *
        pages_per_slot``: every row can be backed whole); int8 pools are
        QuantizedArray nodes with ``[..., heads, 1]`` f32 scales. On a
        `mesh` with a model axis of M the cache holds this rank's
        ``heads / M`` heads (the reference places the heads axis on the
        model axis)."""
        self._validate()
        tp = _heads_spec(mesh, self.heads)
        heads = self.heads if tp is None else self.heads // tp.model
        if self.cache_layout == "dense":
            shape = (self.depth, slots, self.max_seq, heads,
                     self.head_dim)
            return {"k": torch.zeros(shape, dtype=self.compute_dtype,
                                     device=device),
                    "v": torch.zeros(shape, dtype=self.compute_dtype,
                                     device=device)}
        if num_pages is None:
            num_pages = slots * self.pages_per_slot
        shape = (self.depth, num_pages, self.kv_page_tokens, heads,
                 self.head_dim)
        if self.kv_quant == "int8":
            def pool():
                return QuantizedArray(
                    torch.zeros(shape, dtype=torch.int8, device=device),
                    torch.zeros(shape[:-1] + (1,), dtype=torch.float32,
                                device=device), "kv_head")
            return {"k": pool(), "v": pool()}
        return {"k": torch.zeros(shape, dtype=self.compute_dtype,
                                 device=device),
                "v": torch.zeros(shape, dtype=self.compute_dtype,
                                 device=device)}

    def _check_table(self, page_table) -> None:
        paged = self.cache_layout == "paged"
        if paged and page_table is None:
            raise ValueError("paged cache_layout needs a page_table")
        if not paged and page_table is not None:
            raise ValueError("page_table is a paged-layout argument")

    def prefill(self, params, cache, tokens, slot_ids, lengths,
                page_table=None):
        """Run whole prompts and land their K/V in the cache, in place.

        tokens ``[n, S_b]`` (right-padded to the prompt bucket), slot_ids
        ``[n]`` (cache rows; padding rows point at the scratch row),
        lengths ``[n]``. Returns (logits at each prompt's last real
        position ``[n, V]``, the cache). Positions at or past a length
        write garbage K/V that decode's write-before-attend overwrites
        before any mask admits it. Paged layout takes the full-width
        ``page_table`` [rows, pages_per_slot]; positions past a slot's
        allocation land in the scratch pages its table row aliases."""
        self._check_table(page_table)
        logits, kv = self._forward(params, tokens)
        n, s_b = tokens.shape
        slots = slot_ids.long()
        if page_table is not None:
            t = self.kv_page_tokens
            at = torch.arange(s_b, device=tokens.device)
            page_ids = page_table.long()[slots][:, at // t]  # [n, S_b]
            offs = (at % t)[None].expand(n, s_b)
            for i, (k, v) in enumerate(kv):
                _pool_write(_layer_pool(cache["k"], i), page_ids, offs, k)
                _pool_write(_layer_pool(cache["v"], i), page_ids, offs, v)
        else:
            for i, (k, v) in enumerate(kv):
                cache["k"][i][slots, :s_b] = k.to(cache["k"].dtype)
                cache["v"][i][slots, :s_b] = v.to(cache["v"].dtype)
        last = logits[torch.arange(n, device=logits.device),
                      lengths.long() - 1]
        return last, cache

    def _decode_attn(self, i, cache, q, k_new, v_new, positions, page_table,
                     flash: bool = True):
        """Layer i's cached attention for one token per row: write the new
        K/V at each row's position (write before attend, so a freshly
        admitted row overwrites stale prefill padding before any mask
        admits it), then attend keys ``<= pos``. `flash` False keeps a
        dense cache on `_attend` (the TP branch)."""
        r = q.shape[0]
        rows = torch.arange(r, device=q.device)
        pos = positions.long()
        if page_table is not None:
            t = self.kv_page_tokens
            k_pool = _layer_pool(cache["k"], i)
            v_pool = _layer_pool(cache["v"], i)
            page_ids = page_table.long()[rows, pos // t]
            _pool_write(k_pool, page_ids, pos % t, k_new[:, 0])
            _pool_write(v_pool, page_ids, pos % t, v_new[:, 0])
            if isinstance(k_pool, QuantizedArray):
                return paged_attention(q.contiguous(), k_pool, v_pool,
                                       page_table,
                                       (positions + 1).to(torch.int32))
            k = _paged_read(k_pool, page_table)
            v = _paged_read(v_pool, page_table)
        else:
            k, v = cache["k"][i], cache["v"][i]
            k[rows, pos] = k_new[:, 0].to(k.dtype)
            v[rows, pos] = v_new[:, 0].to(v.dtype)
            if flash and self.attention_impl == "flash":
                return masked_flash_attention(q.contiguous(), k, v,
                                              (positions + 1).to(torch.int32))
        mask = (torch.arange(k.shape[1], device=q.device)[None, None, :]
                <= pos[:, None, None])
        return _attend(q, k, v, mask)

    def decode_step(self, params, cache, tokens, positions, page_table=None):
        """One token per row: tokens ``[R]`` are each row's latest token,
        positions ``[R]`` where it goes in that row's sequence. Returns
        (next-token logits ``[R, V]`` f32, the cache, updated in place).
        Each row reads only its own cache rows, so its stream does not
        depend on the batch around it. Under an ambient mesh with a model
        axis the cache holds this rank's heads (module docstring).

        Paged layout takes ``page_table`` [R, n]: float pools at the full
        width, int8 pools at any width covering every live prefix
        (``n*T > max(positions)``)."""
        self._check_table(page_table)
        r = tokens.shape[0]
        x = params["tok_emb"][tokens.long()].to(self.compute_dtype)
        x = (x + params["pos"][0][positions.long()].to(x.dtype))[:, None, :]
        tp = _heads_spec(ambient_mesh(), self.heads)
        for i in range(self.depth):
            p = params[f"block{i}"]
            y = nn.layer_norm(p["ln1"], x)
            q, k, v = self._qkv(p["attn"], y, tp)
            # under TP: this rank's heads, their cache, then the gather;
            # a dense cache stays on _attend whatever attention_impl is
            o = self._decode_attn(i, cache, q, k, v, positions, page_table,
                                  flash=tp is None)
            if tp is not None:
                o = gather_from_model(o, tp, 2)
            x = x + _dense(p["attn"]["out"], o.reshape(r, 1, self.dim))
            x = self._mlp(p, x)
        x = nn.layer_norm(params["final_ln"], x)
        logits = _dense(params["lm_head"], x[:, 0])
        return logits.to(torch.float32), cache
