"""Model-zoo serving: the (batch, height) grid of the classifiers and the
decode grid (port of the reference `serve/zoo.py`: `SeqGrid`,
`default_seq_grid`, `parse_seq_buckets`, `supports_mask`,
`per_device_state_bytes`, `build_zoo_engine`; `DecodeGrid`,
`default_decode_grid`, `build_decode_engine`).

This module PLANS: it picks the height buckets, builds token masks,
counts resident bytes and wires an `InferenceEngine`; the engine
(`serve/engine.py`) executes the grid.

Variable length: a request shorter than the native image (fewer rows,
so fewer ViT patch tokens) is right-padded up to a power-of-two height
bucket and served with a token mask (`models/vit.py apply(mask=...)`),
so its logits are those of the short image alone, and the grid holds
O(log2(max_batch) * log2(native_h)) cells, not one per request shape.
The native bucket keeps the maskless program. With
``attention_impl="flash"`` the masked cells run the masked flash
forward at Sq > 1 (`ops/kernels/masked_flash.py`), the dense native
cell the flash forward.

An MoE checkpoint serves at an inference-time capacity factor
(`moe_capacity_factor`: the model's field replaced, the weights
unchanged, since the factor only sizes the routing buffers), all experts
local on the one device, and the engine returns each batch's routed drop
fraction beside the logits (`InferenceEngine.last_moe_drop_fraction`,
recorded by the batcher). On a mesh the experts are expert-parallel over
the ``model`` axis, as in the step.

Sharded placement: a TP, FSDP or FSDP x TP checkpoint serves
resident-sharded over a mesh of ranks (`build_zoo_engine(mesh=...)`;
the loader's `sharding_rules`, `--serve_rules`, re-lands a checkpoint
trained under one strategy in another's layout), the chief rank serving
and the others following (`serve/engine.py`). The reference's zoo also
holds a memory budget over a compiled-model cache; `build_zoo_engine`
refuses it, naming the ROADMAP items it waits for.
"""

from __future__ import annotations

import dataclasses
import inspect
import logging

import numpy as np

from dist_mnist_tpu_torch.cluster.mesh import MeshSpec, make_mesh
from dist_mnist_tpu_torch.serve.engine import InferenceEngine, _nbytes
from dist_mnist_tpu_torch.utils.tree import leaves

log = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# sequence (height) bucketing


@dataclasses.dataclass(frozen=True)
class SeqGrid:
    """The sequence-bucket axis of the 2-D serve grid.

    A ViT's token count follows the image HEIGHT: ceil(h / patch)
    patch-rows of (width / patch) tokens, in row-major order. So
    right-padding image rows pads whole trailing patch tokens, and the
    learned position table's leading rows are exactly the real tokens'.
    `heights` are the bucket ceilings, ascending, multiples of `patch`,
    the native height always last: the native bucket serves the maskless
    program, every sub-native bucket the masked one."""

    native_height: int
    width: int
    channels: int
    patch: int
    heights: tuple[int, ...]

    def __post_init__(self):
        hs = tuple(sorted(set(int(h) for h in self.heights)))
        if not hs or hs[-1] != self.native_height:
            hs = tuple(h for h in hs if h < self.native_height) \
                + (self.native_height,)
        for h in hs:
            if h < 1 or h > self.native_height:
                raise ValueError(
                    f"seq bucket height {h} outside (0, native "
                    f"{self.native_height}]")
            if h % self.patch:
                raise ValueError(
                    f"seq bucket height {h} not a multiple of patch "
                    f"{self.patch} — a partial patch-row would drop real "
                    "pixels in the VALID patch conv")
        object.__setattr__(self, "heights", hs)

    @property
    def native_only(self) -> bool:
        return self.heights == (self.native_height,)

    def bucket_for(self, h: int) -> int:
        """Smallest bucket ceiling >= h; raises above native (the learned
        position table has no rows for unseen tokens)."""
        if h < 1:
            raise ValueError("empty image (height < 1)")
        for b in self.heights:
            if h <= b:
                return b
        raise ValueError(
            f"height {h} > native {self.native_height}: the checkpoint's "
            "position table ends there; retrain with a larger native shape")

    def n_tokens(self, h: int) -> int:
        """Patch tokens (excluding any CLS) for an image of height `h`."""
        return (-(-h // self.patch)) * (self.width // self.patch)

    def mask(self, real_heights, bucket_h: int) -> np.ndarray:
        """[B, n_tokens(bucket_h)] bool — True on each row's real patch
        tokens, its first `n_tokens(real_heights[i])` (row-major order)."""
        real_heights = np.asarray(real_heights, dtype=np.int64)
        s = self.n_tokens(bucket_h)
        real = np.array([self.n_tokens(int(h)) for h in real_heights])
        return (np.arange(s)[None, :] < real[:, None])


def default_seq_grid(image_shape, patch: int) -> SeqGrid:
    """Power-of-two height ladder: patch, 2*patch, 4*patch, ... up to (and
    always including) the native height."""
    native_h, width, channels = (int(d) for d in image_shape)
    heights, h = [], patch
    while h < native_h:
        heights.append(h)
        h *= 2
    heights.append(native_h)
    return SeqGrid(native_height=native_h, width=width, channels=channels,
                   patch=patch, heights=tuple(heights))


def parse_seq_buckets(spec: str | None, image_shape,
                      patch: int) -> SeqGrid | None:
    """CLI surface: None/"" -> no seq grid (the native-only engine);
    "auto" -> `default_seq_grid`; "h1,h2,..." -> explicit bucket ceilings
    (native appended if missing)."""
    if not spec:
        return None
    if spec == "auto":
        return default_seq_grid(image_shape, patch)
    native_h, width, channels = (int(d) for d in image_shape)
    heights = tuple(int(tok) for tok in spec.split(","))
    return SeqGrid(native_height=native_h, width=width, channels=channels,
                   patch=patch, heights=heights)


def supports_mask(model) -> bool:
    """True when `model.apply` can honor a token mask: it takes a `mask`
    kwarg AND its attention is maskable — "xla" (the -1e30 pre-softmax
    einsum) or "flash" (the masked flash kernels, which turn the zoo's
    key-prefix masks into per-row lengths and skip key tiles past them).
    Ring/Ulysses attention and a block pipeline take no mask; models
    without mask support fall back to the native-only grid."""
    try:
        if "mask" not in inspect.signature(model.apply).parameters:
            return False
    except (TypeError, ValueError):
        return False
    if getattr(model, "attention_impl", "xla") not in ("xla", "flash"):
        return False
    if getattr(model, "block_pipeline", 0):
        return False
    return True


# ---------------------------------------------------------------------------
# resident bytes


def per_device_state_bytes(params, model_state) -> dict:
    """Bytes this rank's device holds for the served weights `params` and
    `model_state` as placed (a sharded restore's shards: an FSDP one about
    1/data of the replicated bytes): int8 leaves at one byte per element
    plus their f32 scales (`serve/engine.py _nbytes`)."""
    out = {
        "param_bytes": sum(_nbytes(x) for x in leaves(params)),
        "model_state_bytes": sum(_nbytes(x) for x in leaves(model_state)),
    }
    out["total_bytes"] = out["param_bytes"] + out["model_state_bytes"]
    return out


# ---------------------------------------------------------------------------
# engine construction


def build_zoo_engine(
    bundle,
    device=None,
    *,
    model_name: str,
    max_bucket: int = 256,
    seq_buckets: str | SeqGrid | None = None,
    moe_capacity_factor: float | None = None,
    memory_budget_mb: float | None = None,
    store=None,
    cache=None,
    mesh=None,
) -> InferenceEngine:
    """An `InferenceEngine` for a `loader.ServingBundle`: the seq grid when
    the model can honor masks (else the native-only grid, with a warning
    when buckets were asked for) and the bundle's quant mode, on one
    device or sharded over `mesh` (default the bundle's: a loader given a
    mesh has already kept each rank's shard under its rules; a bundle of
    whole leaves is sharded here by its rules; a `MeshSpec` is made a
    mesh over the process group's ranks). With every knob at its
    default this is the plain engine.

    `moe_capacity_factor` replaces an MoE model's capacity factor (a
    model without the field refuses, as in the reference).

    `memory_budget_mb` arms the per-device budget of weights and warmed
    cells (`serve/engine.py`: weights over it refuse here, a grid that
    cannot stay resident refuses at `prewarm`); `store` (a
    `compilecache.ExecutableStore`, the kernel store of the persistent
    cache the caller entered, through which a cell's first-run kernel
    builds go) is reported in the cell cache's stats; `cache` shares one
    `CompiledModelCache` between in-process replicas (it keeps its own
    store)."""
    model = bundle.model
    if moe_capacity_factor is not None:
        if not (dataclasses.is_dataclass(model)
                and any(f.name == "moe_capacity_factor"
                        for f in dataclasses.fields(model))):
            raise ValueError(
                f"--moe_capacity_factor given but model {model_name!r} has "
                "no moe_capacity_factor field")
        model = dataclasses.replace(
            model, moe_capacity_factor=float(moe_capacity_factor))
    budget_bytes = (int(memory_budget_mb * 1024 * 1024)
                    if memory_budget_mb else None)
    bundle_mesh = getattr(bundle, "mesh", None)
    if isinstance(mesh, MeshSpec):
        # a spec names a mesh over the process group's ranks
        mesh = make_mesh(mesh, device=device)
    if mesh is None:
        mesh = bundle_mesh
    elif bundle_mesh is not None and bundle_mesh is not mesh:
        raise ValueError("the bundle was sharded over another mesh")
    grid = seq_buckets
    if isinstance(seq_buckets, str):
        grid = parse_seq_buckets(
            seq_buckets, bundle.image_shape, getattr(model, "patch", 1))
    if grid is not None and not supports_mask(model):
        if not grid.native_only:
            log.warning(
                "model %r cannot honor token masks (no mask kwarg, kernel "
                "attention, or block pipeline) — variable-length buckets "
                "%s collapse to the native-only grid",
                model_name, grid.heights)
        grid = SeqGrid(native_height=grid.native_height, width=grid.width,
                       channels=grid.channels, patch=grid.patch,
                       heights=(grid.native_height,))
    return InferenceEngine(
        model, bundle.params, bundle.model_state, device=device,
        image_shape=bundle.image_shape,
        max_bucket=max_bucket, seq_grid=grid,
        quant=getattr(bundle, "quant", None),
        quant_report=getattr(bundle, "quant_report", None),
        mesh=mesh, rules=getattr(bundle, "rules", None),
        specs=getattr(bundle, "specs", None) if bundle_mesh is not None
        else None,
        model_name=model_name, store=store, cache=cache,
        memory_budget_bytes=budget_bytes,
    )


# ---------------------------------------------------------------------------
# autoregressive decode grid (serve/decode.py executes it)


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
                        prompt_buckets=None, mesh=None, **model_overrides):
    """A wired `serve/decode.DecodeEngine` for a registry causal model on
    `device`, params fresh from `seed` (`loader.init_lm_for_serving`; the
    same on every rank); on a `mesh` with a model axis, this rank's heads
    of a tensor-parallel engine."""
    from dist_mnist_tpu_torch.serve.decode import DecodeEngine
    from dist_mnist_tpu_torch.serve.loader import init_lm_for_serving

    model, params = init_lm_for_serving(model_name, seed=seed,
                                        **model_overrides)
    grid = default_decode_grid(model, max_slots=max_slots,
                               prompt_buckets=prompt_buckets)
    return DecodeEngine(model, params, device, grid=grid, mesh=mesh)
