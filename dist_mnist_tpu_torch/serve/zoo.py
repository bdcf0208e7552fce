"""The decode grid and its engine builder (port of the decode part of the
reference `serve/zoo.py`: `DecodeGrid`, `default_decode_grid`,
`build_decode_engine`; the classifier zoo joins with the zoo slice).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DecodeGrid:
    """The shapes the decode engine runs, planned up front.

    - **prefill** cells ``("prefill", n, s)``: prompts right-padded to the
      ``prompt_buckets`` entry for THEIR OWN length (never the batch's
      max), batched up to ``admit_buckets``.
    - **decode** cells: the one-token step at the full slot capacity plus
      the scratch row. Dense layouts have one, ``("decode",)``; paged
      layouts one ``("decode", p)`` per page-table width in
      ``decode_page_buckets``, and each step takes the smallest that
      covers the live prefix. Float paged grids carry only the full
      width (the bitwise twin of dense); int8 grids the power-of-two
      ladder.

    Eager PyTorch compiles nothing, so a cell is a fixed shape, not an
    executable: fixed shapes are what keep a request's stream independent
    of the batch around it (`default_decode_grid`)."""

    max_slots: int = 8
    max_seq: int = 64
    prompt_buckets: tuple = ()
    admit_buckets: tuple = ()
    #: page-table width buckets for the paged decode cells; () = dense
    decode_page_buckets: tuple = ()

    def __post_init__(self):
        if self.max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        pb = tuple(sorted({int(b) for b in self.prompt_buckets}))
        if not pb or any(b < 1 or b > self.max_seq for b in pb):
            raise ValueError(
                f"prompt buckets {pb} must be within [1, {self.max_seq}]")
        ab = tuple(sorted({int(b) for b in self.admit_buckets}))
        if not ab or any(b < 1 for b in ab):
            raise ValueError(f"admit buckets {ab} must be >= 1")
        dp = tuple(sorted({int(b) for b in self.decode_page_buckets}))
        if any(b < 1 for b in dp):
            raise ValueError(f"decode page buckets {dp} must be >= 1")
        object.__setattr__(self, "prompt_buckets", pb)
        object.__setattr__(self, "admit_buckets", ab)
        object.__setattr__(self, "decode_page_buckets", dp)

    @property
    def rows(self) -> int:
        """Rows of the decode batch / KV cache: every slot plus the
        scratch row that absorbs prefill padding writes."""
        return self.max_slots + 1

    def prompt_bucket_for(self, length: int) -> int:
        """Smallest prompt bucket holding `length`."""
        if length < 1:
            raise ValueError("empty prompt")
        for b in self.prompt_buckets:
            if b >= length:
                return b
        raise ValueError(f"prompt length {length} > largest bucket "
                         f"{self.prompt_buckets[-1]}")

    def admit_bucket_for(self, n: int) -> int:
        """Smallest admit (prefill batch) bucket holding `n` rows."""
        if n < 1:
            raise ValueError("empty admission")
        for b in self.admit_buckets:
            if b >= n:
                return b
        raise ValueError(f"admission of {n} > largest admit bucket "
                         f"{self.admit_buckets[-1]}; chunk upstream")

    def decode_page_bucket_for(self, n_pages: int) -> int:
        """Smallest page-table width covering a live prefix of `n_pages`
        pages (paged layout only)."""
        if not self.decode_page_buckets:
            raise ValueError("grid has no decode page buckets (dense)")
        if n_pages < 1:
            raise ValueError("empty prefix")
        for b in self.decode_page_buckets:
            if b >= n_pages:
                return b
        raise ValueError(f"prefix of {n_pages} pages > widest decode bucket "
                         f"{self.decode_page_buckets[-1]}")

    def cells(self) -> list:
        """Every shape the engine runs: ``("prefill", n, s)`` cells, then
        ``("decode",)`` (dense) or ``("decode", p)`` per page bucket."""
        out = [("prefill", n, s) for n in self.admit_buckets
               for s in self.prompt_buckets]
        if self.decode_page_buckets:
            out.extend(("decode", p) for p in self.decode_page_buckets)
        else:
            out.append(("decode",))
        return out


def default_decode_grid(model, *, max_slots: int = 8,
                        prompt_buckets=None) -> DecodeGrid:
    """Power-of-two prompt buckets up to the model's max_seq (floored at 4
    tokens) and ONE admit bucket, ``max_slots``. Paged models also get
    decode page buckets: the power-of-two ladder up to pages_per_slot for
    int8 KV, only the full width for float KV (truncating the key axis
    changes the reduction and breaks the bitwise paged == dense twin).

    One admit bucket is the port's difference from the reference, which
    ladders admits 1, 2, 4, ... up to max_slots: on CUDA, cuBLAS picks its
    GEMM and the reduction kernels their split by the number of rows, so a
    prompt prefilled among 2 rows could round apart from the same prompt
    among 8. Padding every admission to ``max_slots`` rows makes a
    request's prefill a function of its own prompt bucket alone, which is
    what keeps continuous and static streams identical."""
    max_seq = int(model.max_seq)
    if prompt_buckets is None:
        buckets, b = [], 4
        while b < max_seq:
            buckets.append(b)
            b *= 2
        buckets.append(max_seq)
    else:
        buckets = [int(b) for b in prompt_buckets]
    pages = []
    if getattr(model, "cache_layout", "dense") == "paged":
        pps = model.pages_per_slot
        if getattr(model, "kv_quant", "none") == "int8":
            p = 1
            while p < pps:
                pages.append(p)
                p *= 2
        pages.append(pps)
    return DecodeGrid(max_slots=max_slots, max_seq=max_seq,
                      prompt_buckets=tuple(buckets),
                      admit_buckets=(max_slots,),
                      decode_page_buckets=tuple(pages))


def build_decode_engine(device, *, model_name: str = "causal_tiny",
                        seed: int = 0, max_slots: int = 8,
                        prompt_buckets=None, **model_overrides):
    """A wired `serve/decode.DecodeEngine` for a registry causal model on
    `device`, params fresh from `seed` (`loader.init_lm_for_serving`)."""
    from dist_mnist_tpu_torch.serve.decode import DecodeEngine
    from dist_mnist_tpu_torch.serve.loader import init_lm_for_serving

    model, params = init_lm_for_serving(model_name, seed=seed,
                                        **model_overrides)
    grid = default_decode_grid(model, max_slots=max_slots,
                               prompt_buckets=prompt_buckets)
    return DecodeEngine(model, params, device, grid=grid)
