"""Hand-written CUDA kernels and their Python wrappers.

Each wrapper module holds the kernel's launch wrapper, its plain PyTorch
version (the wrapper's path for CPU tensors, and what the kernel is held
against on the card) and a `launches` counter. Sources live in
`dist_mnist_tpu_torch/csrc/`; `build.py` compiles them with `nvcc` at
first use.
"""
