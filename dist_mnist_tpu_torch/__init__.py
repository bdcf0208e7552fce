"""dist_mnist_tpu_torch — the PyTorch/CUDA port of `dist_mnist_tpu`.

The JAX package beside this one is the reference; each module here keeps
its counterpart's path and its public layouts (NHWC images, HWIO conv
kernels, `[in, out]` dense kernels) so a parity test can feed both the
same numpy inputs. This package imports `torch`, never `jax` and nothing
of `dist_mnist_tpu`.

What is ported so far: int8 weight-only classifier serving
(`serve/`, `cli/serve.py`) of the `mlp_mnist` and `lenet5_mnist` configs,
with every quantized dense layer on the hand-written CUDA `quant_matmul`
kernel (`ops/kernels/quant_matmul.py`, `csrc/quant_matmul.cu`).

Entry points run on `cuda` unless the caller asks for `cpu`
(`utils/device.resolve_device`); kernels build into
`build/torch_kernels/` at their first launch.
"""
