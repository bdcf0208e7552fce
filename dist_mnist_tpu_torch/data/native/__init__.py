"""Native (C++) input pipeline: background batch assembly into a bounded
ring (port of the reference `data/native`).

See loader.cc for the design (a byte copy of the reference's); the library
builds with g++ into `build/torch_native/` (`utils/native_build.py`).
`NativeBatcher` is the alternative to `data/pipeline.ShardedBatcher` with
the host-side gather moved onto a C++ producer thread. Construction raises
when the toolchain is missing: nothing falls back to the Python batcher."""

from dist_mnist_tpu_torch.data.native.batcher import (
    NativeBatcher,
    build_library,
)

__all__ = ["NativeBatcher", "build_library"]
