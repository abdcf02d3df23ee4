"""Distillation serving: the teacher side of elastic distillation.

- ``serving``     — predict server and client (the wire protocol of
  ``edl_tpu.distill.serving``), ``TorchPredictBackend`` and the test
  backends.
- ``nlp_teacher`` — the TransformerLM soft-label teacher
  (``python -m edl_tpu_torch.distill.nlp_teacher``).

The student side (``DistillReader``, discovery, balancing) and teacher
registration in the store come with a later slice; a JAX-package
``DistillReader`` reads a port teacher today.
"""

from edl_tpu_torch.distill.serving import (
    CoalescingBackend,
    EchoPredictBackend,
    NopPredictBackend,
    PredictClient,
    PredictServer,
    TorchPredictBackend,
)

__all__ = [
    "CoalescingBackend",
    "EchoPredictBackend",
    "NopPredictBackend",
    "PredictClient",
    "PredictServer",
    "TorchPredictBackend",
]
