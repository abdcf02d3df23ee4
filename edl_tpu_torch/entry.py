"""Driver entry point: the counterpart of ``__graft_entry__.entry``.

``entry()`` returns the flagship model's eval forward (ResNet50_vd, the
reference's benchmark workload, reference README.md:68-72) and its example
arguments on the card: ``forward(params, buffers, x)`` applies the model
to a name -> tensor dict of parameters and one of batch-norm buffers
(``torch.func.functional_call``, the counterpart of ``model.apply``
with ``params`` and ``batch_stats``) with ``train=False``, at
``x [8, 64, 64, 3]``. ``dryrun_multichip`` (a multi-process dry run over
the JAX one's six phases) waits for ROADMAP M24.
"""

from __future__ import annotations

import torch


def entry(device="cuda"):
    """``(forward, (params, buffers, x))`` on ``device`` (the card unless
    the caller names the CPU); weights from seed 0."""
    from edl_tpu_torch.models.resnet import ResNet50_vd
    from edl_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    model = ResNet50_vd(num_classes=1000, device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(0))
    model.eval()
    x = torch.zeros((8, 64, 64, 3), dtype=torch.float32, device=dev)

    def forward(params, buffers, x):
        with torch.no_grad():
            return torch.func.functional_call(
                model, (params, buffers), (x,), {"train": False})

    params = dict(model.named_parameters())
    buffers = dict(model.named_buffers())
    return forward, (params, buffers, x)
