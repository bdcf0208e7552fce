"""Hand-written CUDA kernels and their Python wrappers.

Each wrapper module holds the kernel's launch wrapper, its plain PyTorch
version (the wrapper's path for CPU tensors, and what the kernel is held
against on the card) and a `launches` counter. Sources live in
`dist_mnist_tpu_torch/csrc/`; `build.py` compiles them with `nvcc` at
first use.
"""


def _counted():
    from dist_mnist_tpu_torch.ops.kernels import (
        flash_attention,
        fused_adam,
        masked_flash,
        paged_attention,
        quant_matmul,
    )

    return (quant_matmul.quant_matmul, fused_adam.fused_adam_update,
            fused_adam.fused_adam_clip_wd_update,
            paged_attention.paged_attention,
            masked_flash.masked_flash_attention,
            masked_flash.masked_flash_attention_backward,
            flash_attention.flash_attention_forward,
            flash_attention.flash_attention_dq,
            flash_attention.flash_attention_dkv)


def launch_counts() -> dict[str, int]:
    """Every kernel wrapper's launch counter, by wrapper name."""
    return {fn.__name__: fn.launches for fn in _counted()}


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch counter to 0."""
    for fn in _counted():
        fn.launches = 0
