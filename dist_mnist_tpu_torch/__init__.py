"""dist_mnist_tpu_torch — the PyTorch/CUDA port of `dist_mnist_tpu`.

The JAX package beside this one is the reference; each module here keeps
its counterpart's path and its public layouts (NHWC images, HWIO conv
kernels, `[in, out]` dense kernels) so a parity test can feed both the
same numpy inputs. This package imports `torch`, never `jax` and nothing
of `dist_mnist_tpu`.

What is ported so far:
- int8 weight-only classifier serving (`serve/`, `cli/serve.py`) of the
  `mlp_mnist` and `lenet5_mnist` configs, with every quantized dense layer
  on the hand-written CUDA `quant_matmul` kernel
  (`ops/kernels/quant_matmul.py`, `csrc/quant_matmul.cu`);
- single-device training (`train/`, `optim/`, `data/`, and the headline
  benchmark `bench.py`) of those models, with `optim.adam(fused=True)`
  and `optim.fused_adamw` running every leaf's update in one launch of a
  hand-written CUDA kernel (`ops/kernels/fused_adam.py`,
  `csrc/fused_adam.cu`);
- autoregressive decode serving of the causal LM `causal_tiny`
  (`models/causal_lm.py`, `serve/decode.py`, `cli/serve.py --decode`,
  `bench.py --serve --decode`) with dense, paged-float and paged-int8 KV
  caches: the int8 decode step runs the hand-written CUDA
  `paged_attention` kernel (`ops/kernels/paged_attention.py`,
  `csrc/paged_attention.cu`), and a dense cache with
  ``attention_impl="flash"`` the CUDA `masked_flash_attention` forward
  (`ops/kernels/masked_flash.py`, `csrc/masked_flash_attention.cu`);
- single-device training of ViT-Tiny on CIFAR-10 (`models/vit.py`,
  `data/augment.py`, remat in `train/step.py`, `bench.py --config
  vit_tiny_cifar_flash`), every attention call on the hand-written CUDA
  flash forward and its dQ and dK/dV kernels
  (`ops/kernels/flash_attention.py`, `csrc/flash_attention.cu`), which
  with per-row lengths are also the masked attention's backward.

Entry points run on `cuda` unless the caller asks for `cpu`
(`utils/device.resolve_device`); kernels build into
`build/torch_kernels/` at their first launch.
"""
