"""Device resolution for the port's entry points.

The counterpart of ``edl_tpu.utils.platform.maybe_pin_cpu``: the JAX
package pins the platform from ``JAX_PLATFORMS``; here every entry point
takes an explicit ``device`` that defaults to the card. Nothing silently
carries on on the CPU: asking for CUDA where there is none raises, and the
CPU is used only when the caller names it (as the tests do).
"""

from __future__ import annotations

import torch


def resolve_device(requested="cuda") -> torch.device:
    """``requested`` ("cuda", "cuda:1", "cpu" or a ``torch.device``) ->
    ``torch.device``; raises ``RuntimeError`` when CUDA is asked for and
    absent, ``ValueError`` for any other device type."""
    dev = torch.device(requested)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device %r requested but CUDA is not available; pass "
                "device='cpu' to run on the CPU" % str(requested)
            )
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                "device %r requested but only %d CUDA device(s) present"
                % (str(requested), torch.cuda.device_count())
            )
        return dev
    if dev.type != "cpu":
        raise ValueError("unsupported device %r (cuda or cpu)" % str(requested))
    return dev
