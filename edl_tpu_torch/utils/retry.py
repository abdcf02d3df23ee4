"""One shared retry primitive for every reconnect/re-register loop.

The tree grew four hand-rolled retry loops (store client reconnect +
idempotent-request retry, registration lease restore, distill predict
attempts), each with its own backoff constants and none observable. This
helper replaces them: jittered exponential backoff, an optional overall
deadline, a ``give_up`` predicate for owners that can be closed mid-retry,
and an ``edl_rpc_retries_total`` counter (labeled by call site) so the
chaos store-blip scenario — and production incidents — show *which* path
is retrying and how hard.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional, Tuple, Type, TypeVar

from edl_tpu_torch.obs.metrics import counter as _counter
from edl_tpu_torch.utils.log import get_logger

logger = get_logger("utils.retry")

T = TypeVar("T")

_M_RETRIES = _counter(
    "edl_rpc_retries_total",
    "retry attempts after a retryable failure, by call site",
)


def backoff_delays(
    base_delay: float = 0.05,
    max_delay: float = 1.0,
    factor: float = 2.0,
    jitter: float = 0.1,
    rng: Optional[random.Random] = None,
):
    """Infinite generator of jittered exponential backoff delays.

    Jitter is multiplicative (+-``jitter`` fraction) so herds of
    reconnecting clients de-synchronize; pass a seeded ``rng`` for
    deterministic schedules (chaos scenarios).
    """
    rand = rng if rng is not None else random
    delay = base_delay
    while True:
        yield max(0.0, delay * (1.0 + rand.uniform(-jitter, jitter)))
        delay = min(delay * factor, max_delay)


def retry_call(
    fn: Callable[[], T],
    *,
    what: str,
    retry_on: Tuple[Type[BaseException], ...] = (Exception,),
    retries: Optional[int] = None,
    deadline: Optional[float] = None,
    base_delay: float = 0.05,
    max_delay: float = 1.0,
    factor: float = 2.0,
    jitter: float = 0.1,
    give_up: Optional[Callable[[], bool]] = None,
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
    rng: Optional[random.Random] = None,
    sleep: Callable[[float], None] = time.sleep,
) -> T:
    """Call ``fn`` until it returns, a non-retryable error escapes, or the
    budget runs out.

    ``retries`` bounds the number of *re*-attempts (None = unbounded);
    ``deadline`` is an overall wall-clock budget in seconds; ``give_up``
    is polled before every sleep so a closing owner stops retrying
    immediately. The final failure re-raises the last exception.
    """
    deadline_at = None if deadline is None else time.monotonic() + deadline
    delays = backoff_delays(base_delay, max_delay, factor, jitter, rng)
    attempt = 0
    while True:
        try:
            return fn()
        except retry_on as exc:
            attempt += 1
            exhausted = (
                (retries is not None and attempt > retries)
                or (deadline_at is not None and time.monotonic() >= deadline_at)
                or (give_up is not None and give_up())
            )
            if exhausted:
                raise
            _M_RETRIES.inc(what=what)
            if on_retry is not None:
                on_retry(attempt, exc)
            pause = next(delays)
            if deadline_at is not None:
                pause = min(pause, max(0.0, deadline_at - time.monotonic()))
            sleep(pause)
