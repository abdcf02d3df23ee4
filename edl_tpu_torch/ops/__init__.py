"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Each kernel's source is in ``csrc/`` (built at first use by ``_build``);
its wrapper and plain version live in the module that uses it. On CPU
tensors a wrapper runs the plain version; on CUDA tensors it launches
the kernel or raises.
"""

from edl_tpu_torch.ops.attention import (
    attention,
    attention_reference,
    flash_attention,
    flash_forward,
)

__all__ = ["attention", "attention_reference", "flash_attention", "flash_forward"]
