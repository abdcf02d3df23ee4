"""ResNet-vd family: the port of ``edl_tpu/models/resnet.py``.

ResNet50_vd is the flagship collective-training model (the reference's
benchmark workload and the student of its distillation benchmark). The
*vd* differences from vanilla ResNet (He et al. 2019, "bag of tricks"):
a deep stem of three 3x3 convs (stride 2 on the first) and downsampling
shortcuts that average-pool first, then run a 1x1 stride-1 conv.

Modules carry flax's auto-names (``Conv_0``, ``BatchNorm_0``,
``BottleneckVd_3``, ``Dense_0``), so a flax variable path
``BottleneckVd_3/Conv_1/kernel`` is the ``state_dict`` key
``BottleneckVd_3.Conv_1.kernel`` (:mod:`edl_tpu_torch.convert` transposes
conv kernels from HWIO to OIHW on the way).

Input is what the JAX call sites pass: NHWC float images and
``train=True`` (batch statistics) or ``train=False`` (running averages).
The NHWC batch is viewed as NCHW, which is channels-last memory, and cast
to the compute ``dtype`` (bf16 by default); conv kernels are fp32 masters
kept channels-last and cast per call, so cuDNN never converts a layout.

Numerics follow flax 0.12.3:

- ``padding="SAME"`` pads ``total = max((ceil(n/s)-1)*s + k - n, 0)``
  rows, ``total // 2`` before and the rest after: a stride-2 3x3 conv or
  max pool over an even map pads 0 before and 1 after, where torch's
  ``padding=1`` would pad 1 and 1 and shift the output. Such convs get an
  explicit ``F.pad``; the max pool pads with -inf.
- the vd shortcut's 2x2 stride-2 average pool pads an odd map by one zero
  row and column after and divides by 4 there too (flax's ``avg_pool``
  counts the padding, ``count_include_pad=True``).
- :class:`BatchNorm` is flax's ``BatchNorm(momentum=0.9, epsilon=1e-5)``:
  statistics reduced in fp32, the normalisation computed in fp32 from the
  compute-dtype input and rounded to it, and the running averages
  updated as ``ra = 0.9 * ra + 0.1 * batch_stat`` with the *biased*
  batch variance (torch's own ``momentum=0.1`` update uses the unbiased
  one).
- the last BN of every block starts at zero scale; the global mean pool
  is taken in the compute dtype and the head ``Dense`` runs in fp32.

**Stage-wide batch norm.** Under ``jit`` with a dp-sharded batch the JAX
model's batch mean is a mean over the *global* batch, so a JAX world-N
step equals a world-1 step on the concatenated batch. Here each rank holds
its own rows: in training, when the stage's process group has more than
one rank (resolved at every forward: a hot restage tears the group down
and joins a new one), every BN all-reduces its per-channel ``[sum, sum
of squares, count]`` over the group with the differentiable
``torch.distributed.nn.functional.all_reduce`` and normalises with the
global mean and ``E[x^2] - E[x]^2`` variance (flax's fast variance).
The normalisation and its backward are the native batch-norm kernels in
both cases; at world > 1 the global statistics' gradients come back
through the all-reduce, so every rank's buffers stay equal and the
averaged gradient is the global batch's.

``remat=True`` checkpoints each residual block (``torch.utils.
checkpoint``, non-reentrant); the recompute in the backward does not
update the running averages a second time.
"""

from __future__ import annotations

import functools
import math
import threading
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

MOMENTUM = 0.9
EPSILON = 1e-5

# flax's truncated_normal(-2, 2) has this standard deviation per unit
_TRUNC_STD = 0.87962566103423978

_local = threading.local()


def _updates_stats() -> bool:
    """False inside a remat recompute: its BNs must not move the running
    averages again."""
    return getattr(_local, "update_stats", True)


def stage_group():
    """The group that batch statistics are reduced over: the stage's
    process group when it has more than one rank, else None."""
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return dist.group.WORLD
    return None


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's ``SAME`` padding of one spatial dim: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, kernel: int, stride: int, value: float = 0.0):
    """``x`` padded for a ``SAME`` window over its last two dims, as
    ``(x, symmetric_pad)``: symmetric pads are left to the op (returned),
    asymmetric ones are applied here."""
    ph = same_pads(x.shape[2], kernel, stride)
    pw = same_pads(x.shape[3], kernel, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return x, (ph[0], pw[0])
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value), (0, 0)


def max_pool_same(x: torch.Tensor, kernel: int = 3, stride: int = 2):
    """``nn.max_pool(x, (k, k), strides=(s, s), padding="SAME")``: the pad
    is -inf."""
    x, pad = _pad_same(x, kernel, stride, value=-math.inf)
    return F.max_pool2d(x, kernel, stride, padding=pad)  # pads with -inf


def avg_pool_same(x: torch.Tensor, stride: int) -> torch.Tensor:
    """``nn.avg_pool(x, (s, s), strides=(s, s), padding="SAME")``: zero
    pads counted in the divisor (flax's ``count_include_pad=True``)."""
    x, pad = _pad_same(x, stride, stride)
    return F.avg_pool2d(x, stride, stride, padding=pad,
                        count_include_pad=True)


def _trunc_normal_(p: torch.Tensor, fan_in: int, generator) -> None:
    """flax's ``lecun_normal``: N(0, 1/fan_in) truncated at two standard
    deviations of the underlying normal."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    draw = torch.empty(p.shape, dtype=torch.float32, device=p.device)
    nn.init.trunc_normal_(draw, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)
    p.copy_(draw)


class Conv(nn.Module):
    """Bias-free ``nn.Conv(padding="SAME")``: ``kernel [out, in/groups, k,
    k]`` (OIHW, stored channels-last), cast to the input's dtype."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 groups: int = 1, device=None) -> None:
        super().__init__()
        self.stride = stride
        self.groups = groups
        self.size = kernel
        self.kernel = nn.Parameter(torch.empty(
            (out_ch, in_ch // groups, kernel, kernel), device=device,
        ).to(memory_format=torch.channels_last))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, pad = _pad_same(x, self.size, self.stride)
        return F.conv2d(x, self.kernel.to(x.dtype), None, self.stride, pad,
                        groups=self.groups)

    @torch.no_grad()
    def init_weights(self, generator) -> None:
        _trunc_normal_(self.kernel, self.kernel[0].numel(), generator)


class Dense(nn.Module):
    """fp32 ``nn.Dense``: ``x @ kernel + bias``, ``kernel [in, out]``."""

    def __init__(self, d_in: int, d_out: int, dtype=torch.float32,
                 device=None) -> None:
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty((d_in, d_out), device=device))
        self.bias = nn.Parameter(torch.empty((d_out,), device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        return torch.addmm(self.bias.to(self.dtype), x,
                           self.kernel.to(self.dtype))

    @torch.no_grad()
    def init_weights(self, generator) -> None:
        _trunc_normal_(self.kernel, self.kernel.shape[0], generator)
        self.bias.zero_()


class _Moments(torch.autograd.Function):
    """Per-channel ``[sum x, sum x^2]`` of an NCHW tensor in fp32, as one
    [2, C] tensor; the backward is one pass, ``ds1 + 2 x ds2``."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        return torch.stack([xf.sum((0, 2, 3)), xf.square().sum((0, 2, 3))])

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        shape = (1, -1, 1, 1)
        return torch.addcmul(g[0].view(shape), x, 2.0 * g[1].view(shape)
                             ).to(x.dtype)  # sums are fp32 or wider


class _Normalize(torch.autograd.Function):
    """``(x - mean) * rsqrt(var + eps) * scale + bias`` by the native
    batch-norm kernel with given statistics, differentiable in all five
    inputs: the native backward gives ``dx`` (the statistics held fixed),
    ``dscale = sum(g * xhat)`` and ``dbias = sum(g)``, from which
    ``dmean = -scale * rsqrt * dbias`` and ``dvar = -scale * rsqrt^2 *
    dscale / 2`` follow without another pass over ``x``."""

    @staticmethod
    def forward(ctx, x, mean, var, scale, bias, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, mean, var, scale)
        return F.batch_norm(x, mean, var, scale, bias, False, 0.0, eps)

    @staticmethod
    def backward(ctx, g):
        x, mean, var, scale = ctx.saved_tensors
        rs = torch.rsqrt(var + ctx.eps)
        # the statistics go in as both the running and the saved ones:
        # the CUDA kernel reads the saved pair even in eval mode
        gx, gscale, gbias = torch.ops.aten.native_batch_norm_backward(
            g, x, scale, mean, var, mean, rs, False, ctx.eps,
            [True, True, True])
        gmean = -scale * rs * gbias
        gvar = -0.5 * scale * rs * rs * gscale
        return gx, gmean, gvar, gscale, gbias, None


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the channel
    dim of an NCHW tensor: parameters ``scale``, ``bias`` and buffers
    ``mean``, ``var``, all fp32 (see the module docstring)."""

    def __init__(self, channels: int, zero_scale: bool = False,
                 device=None) -> None:
        super().__init__()
        self.zero_scale = zero_scale
        self.scale = nn.Parameter(torch.empty((channels,), device=device))
        self.bias = nn.Parameter(torch.empty((channels,), device=device))
        self.register_buffer("mean", torch.zeros(channels, device=device))
        self.register_buffer("var", torch.ones(channels, device=device))
        self.init_weights(None)

    @torch.no_grad()
    def init_weights(self, generator) -> None:
        self.scale.fill_(0.0 if self.zero_scale else 1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if not train:
            return F.batch_norm(x, self.mean, self.var, self.scale, self.bias,
                                False, 0.0, EPSILON)
        group = stage_group()
        if group is None:
            out, mean, invstd = torch.native_batch_norm(
                x, self.scale, self.bias, None, None, True, 0.0, EPSILON)
            var = invstd.detach().pow(-2) - EPSILON
        else:
            from torch.distributed.nn.functional import all_reduce

            count = x.numel() // x.shape[1]
            local = torch.cat([_Moments.apply(x), torch.full(
                (1, x.shape[1]), float(count), device=x.device)])
            total = all_reduce(local, group=group)
            mean = total[0] / total[2]
            var = (total[1] / total[2] - mean * mean).clamp(min=0.0)
            out = _Normalize.apply(x, mean, var, self.scale, self.bias,
                                   EPSILON)
        if _updates_stats():
            with torch.no_grad():
                self.mean.mul_(MOMENTUM).add_(mean.detach(),
                                              alpha=1.0 - MOMENTUM)
                self.var.mul_(MOMENTUM).add_(var.detach(),
                                             alpha=1.0 - MOMENTUM)
        return out


def _shortcut(block, x: torch.Tensor, train: bool) -> torch.Tensor:
    """The vd shortcut: average-pool first when strided, then 1x1 conv and
    BN; the identity when the block keeps the shape."""
    if block.short is None:
        return x
    if block.stride > 1:
        x = avg_pool_same(x, block.stride)
    conv, norm = block.short
    return norm(conv(x), train)


class BottleneckVd(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck with the vd avg-pool downsample."""

    expansion = 4

    def __init__(self, in_ch: int, filters: int, stride: int,
                 device=None) -> None:
        super().__init__()
        out = filters * 4
        self.stride = stride
        self.out_channels = out
        self.Conv_0 = Conv(in_ch, filters, 1, device=device)
        self.BatchNorm_0 = BatchNorm(filters, device=device)
        self.Conv_1 = Conv(filters, filters, 3, stride, device=device)
        self.BatchNorm_1 = BatchNorm(filters, device=device)
        self.Conv_2 = Conv(filters, out, 1, device=device)
        self.BatchNorm_2 = BatchNorm(out, zero_scale=True, device=device)
        self.short = None  # (conv, norm) when the block changes the shape
        if in_ch != out or stride > 1:
            self.Conv_3 = Conv(in_ch, out, 1, device=device)
            self.BatchNorm_3 = BatchNorm(out, device=device)
            self.short = (self.Conv_3, self.BatchNorm_3)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y), train))
        y = self.BatchNorm_2(self.Conv_2(y), train)
        return F.relu(_shortcut(self, x, train) + y)


class BasicBlockVd(nn.Module):
    """3x3 -> 3x3 block with the vd avg-pool downsample."""

    expansion = 1

    def __init__(self, in_ch: int, filters: int, stride: int,
                 device=None) -> None:
        super().__init__()
        self.stride = stride
        self.out_channels = filters
        self.Conv_0 = Conv(in_ch, filters, 3, stride, device=device)
        self.BatchNorm_0 = BatchNorm(filters, device=device)
        self.Conv_1 = Conv(filters, filters, 3, device=device)
        self.BatchNorm_1 = BatchNorm(filters, zero_scale=True, device=device)
        self.short = None
        if in_ch != filters or stride > 1:
            self.Conv_2 = Conv(in_ch, filters, 1, device=device)
            self.BatchNorm_2 = BatchNorm(filters, device=device)
            self.short = (self.Conv_2, self.BatchNorm_2)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = self.BatchNorm_1(self.Conv_1(y), train)
        return F.relu(_shortcut(self, x, train) + y)


class BottleneckX(nn.Module):
    """ResNeXt bottleneck: a grouped 3x3 (``cardinality`` groups) between
    1x1 projections, with the vd avg-pool downsample."""

    def __init__(self, in_ch: int, filters: int, out_filters: int,
                 stride: int, cardinality: int, device=None) -> None:
        super().__init__()
        self.stride = stride
        self.out_channels = out_filters
        self.Conv_0 = Conv(in_ch, filters, 1, device=device)
        self.BatchNorm_0 = BatchNorm(filters, device=device)
        self.Conv_1 = Conv(filters, filters, 3, stride, groups=cardinality,
                           device=device)
        self.BatchNorm_1 = BatchNorm(filters, device=device)
        self.Conv_2 = Conv(filters, out_filters, 1, device=device)
        self.BatchNorm_2 = BatchNorm(out_filters, zero_scale=True,
                                     device=device)
        self.short = None
        if in_ch != out_filters or stride > 1:
            self.Conv_3 = Conv(in_ch, out_filters, 1, device=device)
            self.BatchNorm_3 = BatchNorm(out_filters, device=device)
            self.short = (self.Conv_3, self.BatchNorm_3)

    forward = BottleneckVd.forward


def _run_block(block, x: torch.Tensor, train: bool, remat: bool):
    """One residual block, checkpointed when ``remat`` (and gradients are
    on); only its first run updates the running averages."""
    if not (remat and torch.is_grad_enabled()):
        return block(x, train)
    first = [True]

    def run(inp):
        update, first[0] = first[0], False
        prev = _updates_stats()
        _local.update_stats = prev and update
        try:
            return block(inp, train)
        finally:
            _local.update_stats = prev

    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)


class _VdNet(nn.Module):
    """The shared trunk: a deep stem of three 3x3 convs, a SAME max pool,
    the residual blocks, the global mean pool and the fp32 head."""

    default_train = True

    def _stem(self, stem: Sequence[int], device) -> None:
        chans = (3,) + tuple(stem)
        for i in range(3):
            self.add_module("Conv_%d" % i, Conv(
                chans[i], chans[i + 1], 3, 2 if i == 0 else 1, device=device))
            self.add_module("BatchNorm_%d" % i,
                            BatchNorm(chans[i + 1], device=device))

    def forward(self, x: torch.Tensor, train: Optional[bool] = None
                ) -> torch.Tensor:
        """``x [B, H, W, 3]`` (NHWC) -> fp32 logits ``[B, num_classes]``."""
        if train is None:
            train = self.default_train
        x = x.permute(0, 3, 1, 2).to(self.dtype)  # NCHW, channels-last
        for i in range(3):
            x = getattr(self, "Conv_%d" % i)(x)
            x = F.relu(getattr(self, "BatchNorm_%d" % i)(x, train))
        x = max_pool_same(x)
        for name in self.block_names:
            x = _run_block(getattr(self, name), x, train, self.remat)
        x = x.mean((2, 3))
        return self.Dense_0(x).float()

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "_VdNet":
        """Seeded weights as flax initialises them: ``lecun_normal``
        (truncated) conv and Dense kernels, zero Dense bias, BN scales 1
        (0 for each block's last BN) and bias 0; running averages reset
        to mean 0, var 1. Drawn in module order on the generator's
        device."""
        for m in self.modules():
            if isinstance(m, (Conv, Dense, BatchNorm)):
                m.init_weights(generator)
            if isinstance(m, BatchNorm):
                m.mean.zero_()
                m.var.fill_(1.0)
        return self


class ResNet(_VdNet):
    """ResNet-vd. ``stage_sizes``: blocks per stage, e.g. (3, 4, 6, 3) is
    the 50-layer net. ``dtype`` is the compute type; parameters and BN
    statistics are fp32. ``forward(x, train=True)`` as the JAX model."""

    def __init__(self, stage_sizes: Sequence[int], block=BottleneckVd,
                 num_classes: int = 1000, width: int = 64,
                 dtype=torch.bfloat16, remat: bool = False,
                 device=None) -> None:
        super().__init__()
        self.dtype = dtype
        self.remat = remat
        self._stem((width // 2, width // 2, width), device)
        ch = width
        self.block_names = []
        for stage, num_blocks in enumerate(stage_sizes):
            for block_idx in range(num_blocks):
                name = "%s_%d" % (block.__name__, len(self.block_names))
                b = block(ch, width * 2 ** stage,
                          2 if stage > 0 and block_idx == 0 else 1,
                          device=device)
                self.add_module(name, b)
                self.block_names.append(name)
                ch = b.out_channels
        self.Dense_0 = Dense(ch, num_classes, device=device)


class ResNeXt(_VdNet):
    """ResNeXt (Xie et al. 2017) with the vd stem and shortcuts; the
    distillation benchmark's teacher family. ``forward(x, train=False)``
    as the JAX model."""

    default_train = False
    remat = False

    def __init__(self, stage_sizes: Sequence[int], cardinality: int = 32,
                 base_width: int = 16, num_classes: int = 1000,
                 dtype=torch.bfloat16, device=None) -> None:
        super().__init__()
        self.dtype = dtype
        self._stem((32, 32, 64), device)
        ch = 64
        self.block_names = []
        for stage, num_blocks in enumerate(stage_sizes):
            group_width = cardinality * base_width * 2 ** stage
            for block_idx in range(num_blocks):
                name = "BottleneckX_%d" % len(self.block_names)
                b = BottleneckX(ch, group_width, 256 * 2 ** stage,
                                2 if stage > 0 and block_idx == 0 else 1,
                                cardinality, device=device)
                self.add_module(name, b)
                self.block_names.append(name)
                ch = b.out_channels
        self.Dense_0 = Dense(ch, num_classes, device=device)


ResNeXt101_32x16d = functools.partial(ResNeXt, stage_sizes=(3, 4, 23, 3),
                                      base_width=16)
ResNeXt101_32x8d = functools.partial(ResNeXt, stage_sizes=(3, 4, 23, 3),
                                     base_width=8)
ResNeXt50_32x4d = functools.partial(ResNeXt, stage_sizes=(3, 4, 6, 3),
                                    base_width=4)

ResNet18_vd = functools.partial(ResNet, stage_sizes=(2, 2, 2, 2),
                                block=BasicBlockVd)
ResNet34_vd = functools.partial(ResNet, stage_sizes=(3, 4, 6, 3),
                                block=BasicBlockVd)
ResNet50_vd = functools.partial(ResNet, stage_sizes=(3, 4, 6, 3))
ResNet101_vd = functools.partial(ResNet, stage_sizes=(3, 4, 23, 3))
ResNet152_vd = functools.partial(ResNet, stage_sizes=(3, 8, 36, 3))


def batch_norms(module: nn.Module):
    """The batch-norm layers of ``module`` (its batch-statistics state):
    an empty list for a model without batch norm."""
    return [m for m in module.modules()
            if isinstance(m, (BatchNorm, nn.modules.batchnorm._BatchNorm))]
