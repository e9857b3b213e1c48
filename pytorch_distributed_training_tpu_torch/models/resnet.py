"""ResNet v1.5: the counterpart of the JAX package's ``models/resnet.py``
(ResNet-18/34 with ``BasicBlock``, ResNet-50/101/152 with ``Bottleneck``,
the stride on the 3x3 as torchvision places it).

Tensors are NCHW in ``channels_last`` memory, which is the JAX model's
NHWC in memory: a contiguous (B, H, W, C) batch ``permute(0, 3, 1, 2)``
is already that, with no copy, and the weights are converted to
``channels_last`` once when the model is built.  Strided convolutions use
explicit symmetric padding (7x7/s2: 3, 3x3/s2: 1), as torchvision does.

With ``tpu_fused`` (the default) the norms are the output-saving
functions of ``ops/fused_norm.py`` (BN+ReLU, the block tail BN+add+ReLU,
the downsample BN) and the 7x7 stem runs as the exact space-to-depth
convolution of ``ops/s2d_stem.py``; ``zero_init_residual`` (tail gamma
starts at 0, which the fused backward cannot divide by) puts the tail and
downsample norms back on the plain composition.  ``stem_remat`` recomputes
the stem in the backward (``torch.utils.checkpoint``).  After the stages
come a global mean pool and the head, computed in f32 from the weights it
is given (the JAX head's ``dtype=float32``).

In training the BatchNorms use the batch statistics; the forward puts
their updated running statistics into ``new_stats`` (keyed like the
model's buffers) when the caller passes that dict and leaves the buffers
alone, else it updates the buffers.  A ``group`` (a ``torch.distributed``
process group, which the data-parallel train step hands to the forward)
reaches every BatchNorm, which then takes its statistics over all
ranks' batches: the JAX model's global-batch statistics.  The model
itself holds no group.  Convolutions, pooling and the head
are library calls (cuDNN on the card), as the JAX model leaves them to
XLA.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.fused_norm import (
    BatchNorm, FusedBN, FusedBNAddRelu, FusedBNRelu, _NormBase,
)
from ..ops.s2d_stem import SpaceToDepthStem
from ..utils.device import resolve_device


def _conv(cin: int, cout: int, k: int, stride: int = 1, padding: int = 0,
          device=None) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, padding, bias=False, device=device)


class BasicBlock(nn.Module):
    """3x3 + 3x3 residual block (ResNet-18/34)."""

    expansion = 1
    depth = 2  # convolutions; the last one's norm is the block tail

    def __init__(self, in_channels: int, filters: int, strides: int = 1, *,
                 fused: bool = True, zero_init_residual: bool = False,
                 device=None):
        super().__init__()
        self.fused = fused
        self.fused_tail = fused and not zero_init_residual
        out = filters * self.expansion
        self.out_channels = out
        self._build(in_channels, filters, strides, device)
        tail_cls = FusedBNAddRelu if self.fused_tail else BatchNorm
        tail = tail_cls(out, scale_init=0.0 if zero_init_residual else 1.0,
                        device=device)
        setattr(self, f"bn{self.depth - 1}", tail)
        self.downsample_conv = self.downsample_bn = None
        if in_channels != out or strides != 1:
            self.downsample_conv = _conv(in_channels, out, 1, strides,
                                         device=device)
            self.downsample_bn = (FusedBN if self.fused_tail else BatchNorm)(
                out, device=device)

    def _build(self, cin, filters, strides, device):
        self.conv0 = _conv(cin, filters, 3, strides, 1, device)
        self.bn0 = self._norm_relu_module(filters, device)
        self.conv1 = _conv(filters, filters, 3, 1, 1, device)

    def _norm_relu_module(self, features, device):
        return (FusedBNRelu if self.fused else BatchNorm)(features,
                                                           device=device)

    def _norm_relu(self, bn, y, new_stats, group):
        if self.fused:
            return bn(y, new_stats, group)
        return F.relu(bn(y, new_stats, group))

    def _tail(self, y, residual, new_stats, group):
        bn = getattr(self, f"bn{self.depth - 1}")
        if self.fused_tail:
            return bn(y, residual, new_stats, group)
        return F.relu(bn(y, new_stats, group) + residual)

    def _residual(self, x, new_stats, group):
        if self.downsample_conv is None:
            return x
        return self.downsample_bn(self.downsample_conv(x), new_stats, group)

    def forward(self, x, new_stats: dict | None = None, group=None):
        y = self._norm_relu(self.bn0, self.conv0(x), new_stats, group)
        y = self.conv1(y)
        return self._tail(y, self._residual(x, new_stats, group), new_stats,
                          group)


class Bottleneck(BasicBlock):
    """1x1 -> 3x3 -> 1x1 bottleneck block (ResNet-50/101/152), expansion 4,
    the stride on the 3x3 (v1.5)."""

    expansion = 4
    depth = 3

    def _build(self, cin, filters, strides, device):
        self.conv0 = _conv(cin, filters, 1, device=device)
        self.bn0 = self._norm_relu_module(filters, device)
        self.conv1 = _conv(filters, filters, 3, strides, 1, device)
        self.bn1 = self._norm_relu_module(filters, device)
        self.conv2 = _conv(filters, filters * 4, 1, device=device)

    def forward(self, x, new_stats: dict | None = None, group=None):
        y = self._norm_relu(self.bn0, self.conv0(x), new_stats, group)
        y = self._norm_relu(self.bn1, self.conv1(y), new_stats, group)
        y = self.conv2(y)
        return self._tail(y, self._residual(x, new_stats, group), new_stats,
                          group)


class Stem(nn.Module):
    """conv_init -> bn_init -> ReLU (-> 3x3/s2 max pool): the ImageNet
    stem (7x7/s2, the space-to-depth form when fused), or the CIFAR
    ``small_stem`` (3x3/s1, no pool)."""

    def __init__(self, in_channels: int, features: int, *, small: bool,
                 fused: bool, device=None):
        super().__init__()
        self.small = small
        self.fused = fused
        if small:
            self.conv_init = _conv(in_channels, features, 3, 1, 1, device)
        elif fused:
            self.conv_init = SpaceToDepthStem(in_channels, features,
                                              device=device)
        else:
            self.conv_init = _conv(in_channels, features, 7, 2, 3, device)
        self.bn_init = (FusedBNRelu if fused else BatchNorm)(features,
                                                             device=device)

    def forward(self, x, new_stats: dict | None = None, group=None):
        x = self.conv_init(x)
        x = self.bn_init(x, new_stats, group)
        if not self.fused:
            x = F.relu(x)
        if not self.small:
            x = F.max_pool2d(x, 3, 2, 1)
        return x


def _module_call(module, tensors, x, new_stats, group):
    """``module`` as a function of its tensors: under remat the backward's
    recompute then runs on the tensors the forward ran on (the step's
    compute-dtype copies), not on the module's own parameters."""
    return torch.func.functional_call(module, tensors, (x,),
                                      {"new_stats": new_stats,
                                       "group": group})


class ResNet(nn.Module):
    """ResNet v1.5: (B, C, H, W) images -> (B, num_classes) f32 logits.

    ``stage_sizes`` blocks per stage ((2, 2, 2, 2) for ResNet-18),
    ``block`` BasicBlock or Bottleneck, ``num_classes`` the head's width
    (the reference sizes it from the dataset).  The input is cast to the
    dtype of the weights the forward runs on."""

    def __init__(self, stage_sizes, block, num_classes: int = 1000,
                 num_filters: int = 64, *, small_stem: bool = False,
                 tpu_fused: bool = True, stem_remat: bool = False,
                 zero_init_residual: bool = False, in_channels: int = 3,
                 device=None):
        super().__init__()
        self.stem_remat = stem_remat
        self.stem = Stem(in_channels, num_filters, small=small_stem,
                         fused=tpu_fused, device=device)
        blocks, cin = [], num_filters
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                blk = block(cin, num_filters * 2 ** i,
                            2 if i > 0 and j == 0 else 1, fused=tpu_fused,
                            zero_init_residual=zero_init_residual,
                            device=device)
                blocks.append(blk)
                cin = blk.out_channels
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(cin, num_classes, device=device)
        for name, m in self.named_modules():
            if isinstance(m, _NormBase):
                m.stats_key = name

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Fresh weights from ``generator`` by the JAX model's rules:
        convolutions He fan-out normal, the head flax ``Dense``'s
        lecun-normal (truncated at 2 sigma) with a zero bias; BatchNorm
        keeps its construction values.  The draws differ from
        ``jax.random``'s; parity tests convert the JAX weights."""
        for m in self.modules():
            if isinstance(m, SpaceToDepthStem):
                m.init_weights(generator)
            elif isinstance(m, nn.Conv2d):
                fan_out = m.weight.shape[0] * m.weight[0, 0].numel()
                m.weight.normal_(0.0, math.sqrt(2.0 / fan_out),
                                 generator=generator)
        std = math.sqrt(1.0 / self.head.weight.shape[1]) / 0.87962566103423978
        nn.init.trunc_normal_(self.head.weight, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
        self.head.bias.zero_()

    def forward(self, x, new_stats: dict | None = None, group=None):
        own = self.training and new_stats is None
        if own:
            # Collect, then write the buffers once: a remat recompute then
            # rewrites the same entries instead of updating twice.
            new_stats = {}
        x = x.to(self.head.weight.dtype)
        if self.stem_remat and self.training and torch.is_grad_enabled():
            tensors = {**dict(self.stem.named_parameters()),
                       **dict(self.stem.named_buffers())}
            x = checkpoint(_module_call, self.stem, tensors, x, new_stats,
                           group, use_reentrant=False)
        else:
            x = self.stem(x, new_stats, group)
        for blk in self.blocks:
            x = blk(x, new_stats, group)
        x = x.mean(dim=(2, 3))
        logits = F.linear(x.float(), self.head.weight.float(),
                          self.head.bias.float())
        if own:
            with torch.no_grad():
                for name, value in new_stats.items():
                    self.get_buffer(name).copy_(value)
        return logits


def _make(stage_sizes, block, num_classes, cfg_overrides, device, dtype,
          seed) -> ResNet:
    kw = {"stage_sizes": stage_sizes, "block": block,
          "num_classes": num_classes, **(cfg_overrides or {})}
    device = resolve_device(device)
    model = ResNet(**kw, device=device)
    if device.type != "meta":
        model.init_weights(torch.Generator(device=device).manual_seed(seed))
    model.to(memory_format=torch.channels_last)
    if dtype is not None:
        # The parameters only: the running statistics stay f32.
        for p in model.parameters():
            p.data = p.data.to(dtype)
    return model


def resnet18(num_classes: int = 1000, cfg_overrides: dict | None = None, *,
             device=None, dtype=None, seed: int = 0) -> ResNet:
    """The reference's model.  Weights are drawn in f32 from ``seed``,
    then the parameters are cast to ``dtype``; ``device`` defaults to
    CUDA (``utils.device``), ``device="meta"`` builds shapes only;
    ``cfg_overrides`` sets any ``ResNet`` argument."""
    return _make((2, 2, 2, 2), BasicBlock, num_classes, cfg_overrides,
                 device, dtype, seed)


def resnet34(num_classes: int = 1000, cfg_overrides: dict | None = None, *,
             device=None, dtype=None, seed: int = 0) -> ResNet:
    return _make((3, 4, 6, 3), BasicBlock, num_classes, cfg_overrides,
                 device, dtype, seed)


def resnet50(num_classes: int = 1000, cfg_overrides: dict | None = None, *,
             device=None, dtype=None, seed: int = 0) -> ResNet:
    """The model of the ImageNet configurations."""
    return _make((3, 4, 6, 3), Bottleneck, num_classes, cfg_overrides,
                 device, dtype, seed)


def resnet101(num_classes: int = 1000, cfg_overrides: dict | None = None, *,
              device=None, dtype=None, seed: int = 0) -> ResNet:
    return _make((3, 4, 23, 3), Bottleneck, num_classes, cfg_overrides,
                 device, dtype, seed)


def resnet152(num_classes: int = 1000, cfg_overrides: dict | None = None, *,
              device=None, dtype=None, seed: int = 0) -> ResNet:
    return _make((3, 8, 36, 3), Bottleneck, num_classes, cfg_overrides,
                 device, dtype, seed)
