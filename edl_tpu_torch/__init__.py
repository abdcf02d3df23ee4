"""edl_tpu_torch: the PyTorch and CUDA port of edl_tpu for NVIDIA Hopper.

The package mirrors ``edl_tpu``'s layout and names, so each module's
counterpart is easy to find, and imports nothing of it (nor of JAX): the
jax-free helpers it needs are kept as copies here (the store client,
discovery, the chaos plane, metrics, traces, the wire protocol), so a port
process and the JAX package's launcher, store and tools talk to each
other. The paths ported so far:

- serving the TransformerLM distillation teacher: ``distill.nlp_teacher``
  -> ``distill.serving.PredictServer`` -> ``TorchPredictBackend`` ->
  ``models.transformer.TransformerLM``;
- training it: ``tools.lm_bench`` -> ``train.step.make_train_step``;
- training it elastically, stop-resume: a launcher-started worker ->
  ``train.ElasticTrainer`` (``train.context.init``, ``parallel.mesh``
  data parallelism, ``data.prefetch_to_device``) -> per-epoch
  ``checkpoint.CheckpointManager`` saves, restored at the next world size.

Attention runs on the hand-written CUDA flash kernels of ``ops/csrc``.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU; without CUDA they raise (:func:`utils.device.resolve_device`).
"""
