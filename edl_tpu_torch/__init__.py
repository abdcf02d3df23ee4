"""edl_tpu_torch: the PyTorch and CUDA port of edl_tpu for NVIDIA Hopper.

The package mirrors ``edl_tpu``'s layout and names, so each module's
counterpart is easy to find, and imports nothing of it (nor of JAX): the
jax-free helpers it needs are kept as copies here. This slice serves the
TransformerLM distillation teacher: ``distill.nlp_teacher`` ->
``distill.serving.PredictServer`` -> ``TorchPredictBackend`` ->
``models.transformer.TransformerLM``, whose attention runs on the
hand-written CUDA flash forward in ``ops/csrc/flash_fwd.cu``.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU; without CUDA they raise (:func:`utils.device.resolve_device`).
"""
