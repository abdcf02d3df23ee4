"""The input pipeline's batching and device feed: the port of
``edl_tpu.data``'s ``prefetch`` exports. The dispatcher, loader and data
checkpoint (jax-free) come with a later slice."""

from edl_tpu_torch.data.prefetch import batched, prefetch_to_device, shuffled

__all__ = ["batched", "prefetch_to_device", "shuffled"]
