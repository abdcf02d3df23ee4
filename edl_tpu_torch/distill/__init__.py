"""Elastic knowledge distillation: teachers and the student side.

The port of ``edl_tpu/distill``: a student-side :class:`DistillReader`
streams training batches through a dynamically discovered,
load-balanced fleet of teacher predict servers. The store keys
(``distill/teachers/...``, ``assign/{client_id}``, ``DRAINING``), the
frames, the fault points and the ``edl_distill_*`` metrics are the JAX
package's, so port and JAX teachers, balancers and students discover,
balance and talk to each other.

- ``serving``    — predict server and client, ``TorchPredictBackend``
  and the test backends.
- ``discovery``  — ``TeacherRegister``, ``BalanceTable``,
  ``DiscoveryService``, ``DiscoveryClient``
  (``python -m edl_tpu_torch.distill.discovery_server``).
- ``worker``     — the student-side pipeline (reader → predict pool →
  ordered fetch, poison-pill epoch protocol).
- ``reader``     — the user-facing DistillReader.
- ``resilience`` — retry budgets, hedged predicts, circuit breakers.
- ``fetch``      — teacher artifacts by URI with sha256 caching.
- ``nlp_teacher`` — the TransformerLM soft-label teacher
  (``python -m edl_tpu_torch.distill.nlp_teacher``).

The JAX package's closed-loop serving driver (``distill/slo.py``) is not
ported yet.
"""

from edl_tpu_torch.distill.fetch import FetchError, fetch_from_env, fetch_model
from edl_tpu_torch.distill.reader import DistillReader
from edl_tpu_torch.distill.resilience import (
    BreakerBoard,
    FractionBudget,
    HedgePolicy,
    RetryBudget,
    hedged_call,
)
from edl_tpu_torch.distill.serving import (
    CoalescingBackend,
    EchoPredictBackend,
    NopPredictBackend,
    PredictClient,
    PredictServer,
    TorchPredictBackend,
)

__all__ = [
    "DistillReader",
    "fetch_model",
    "fetch_from_env",
    "FetchError",
    "PredictServer",
    "PredictClient",
    "TorchPredictBackend",
    "NopPredictBackend",
    "CoalescingBackend",
    "EchoPredictBackend",
    "FractionBudget",
    "RetryBudget",
    "HedgePolicy",
    "hedged_call",
    "BreakerBoard",
]
