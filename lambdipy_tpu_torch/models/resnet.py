"""ResNet-50 in PyTorch, the twin of ``lambdipy_tpu/models/resnet.py``:
the same stage sizes, widths, strides and module names, so the two can
be held against each other on the same weights
(``models/params.py from_jax_params``).

- The input is NHWC, as in JAX; inside, activations are NCHW views in
  ``channels_last`` memory (NHWC bytes), the layout cuDNN takes bf16
  convolutions in on the card.
- Convolution kernels are held in torch's ``[out, in, kh, kw]`` layout
  (flax's is ``[kh, kw, in, out]``; ``models/params.py`` maps them). The
  7x7 stem and the 3x3 convolutions pad 3 and 1 explicitly; the 1x1
  convolutions take flax's default ``SAME``, which pads nothing at 1x1;
  max pooling pads with -inf.
- Batch norm runs in inference mode and rounds once, as flax's
  ``_normalize`` does: ``(x - mean) * (rsqrt(var + 1e-5) * scale) + bias``
  in f32 from the conv's output and the f32 statistics, the result cast
  to the model dtype. It is not folded into the convolution (that would
  change the rounding against JAX).
- The head is an f32 dense layer on the global mean, which is taken in
  f32 and rounded to the model dtype first (``jnp.mean`` of a bf16 array).

Weights are buffers: the port serves, it does not train. Plain PyTorch
throughout: the JAX model reaches no Pallas kernel (XLA's convolutions).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from lambdipy_tpu_torch.utils.platform import resolve_device

BN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: tuple = (3, 4, 6, 3)  # ResNet-50
    num_classes: int = 1000
    width: int = 64
    dtype: Any = torch.bfloat16
    # the example batch's height and width (the registry's image_size)
    image_size: int = 224


RESNET50 = ResNetConfig()
RESNET_TINY = ResNetConfig(stage_sizes=(1, 1), num_classes=10, width=8,
                           dtype=torch.float32, image_size=32)


class Conv(nn.Module):
    """flax ``nn.Conv`` without bias, square kernel ``k``: ``kernel`` is
    ``[out, in, k, k]``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 pad: int = 0, dtype=torch.float32, device=None):
        super().__init__()
        self.stride, self.pad = stride, pad
        self.register_buffer("kernel", torch.empty(
            cout, cin, k, k, dtype=dtype, device=device))

    def forward(self, x):
        return F.conv2d(x, self.kernel, stride=self.stride, padding=self.pad)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(use_running_average=True)`` over the channel
    axis: f32 ``scale``, ``bias`` (flax's ``params``) and ``mean``, ``var``
    (its ``batch_stats``); the result in ``dtype``."""

    def __init__(self, c: int, dtype, device=None):
        super().__init__()
        self.dtype = dtype
        for name in ("scale", "bias", "mean", "var"):
            self.register_buffer(name, torch.empty(
                c, dtype=torch.float32, device=device))

    def forward(self, x):
        mul = torch.rsqrt(self.var + BN_EPS) * self.scale
        y = (x.float() - self.mean[:, None, None]) * mul[:, None, None]
        return (y + self.bias[:, None, None]).to(self.dtype)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel + bias``, the kernel ``[in, out]``,
    computed in ``dtype`` (the input cast to it)."""

    def __init__(self, cin: int, cout: int, dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.register_buffer("kernel", torch.empty(
            cin, cout, dtype=dtype, device=device))
        self.register_buffer("bias", torch.empty(
            cout, dtype=dtype, device=device))

    def forward(self, x):
        return x.to(self.dtype) @ self.kernel + self.bias


class BottleneckBlock(nn.Module):
    def __init__(self, cin: int, features: int, strides: int,
                 projection: bool, dtype, device=None):
        super().__init__()
        self.projection = projection
        self.conv1 = Conv(cin, features, 1, dtype=dtype, device=device)
        self.bn1 = BatchNorm(features, dtype, device)
        self.conv2 = Conv(features, features, 3, strides, 1, dtype, device)
        self.bn2 = BatchNorm(features, dtype, device)
        self.conv3 = Conv(features, features * 4, 1, dtype=dtype,
                          device=device)
        self.bn3 = BatchNorm(features * 4, dtype, device)
        if projection:
            self.proj_conv = Conv(cin, features * 4, 1, strides, 0, dtype,
                                  device)
            self.proj_bn = BatchNorm(features * 4, dtype, device)

    def forward(self, x):
        residual = x
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.projection:
            residual = self.proj_bn(self.proj_conv(residual))
        return F.relu(y + residual)


class ResNet(nn.Module):
    """Blocks are registered as ``stage{i}_block{j}`` (1-based), as the
    flax module names them. ``device`` defaults to the card and raises
    when there is none."""

    def __init__(self, cfg: ResNetConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        dev, dtype = self.device, cfg.dtype
        self.stem_conv = Conv(3, cfg.width, 7, 2, 3, dtype, dev)
        self.stem_bn = BatchNorm(cfg.width, dtype, dev)
        cin = cfg.width
        for i, count in enumerate(cfg.stage_sizes):
            features = cfg.width * 2 ** i
            for j in range(count):
                self.add_module(f"stage{i + 1}_block{j + 1}", BottleneckBlock(
                    cin, features, 2 if (i > 0 and j == 0) else 1, j == 0,
                    dtype, dev))
                cin = features * 4
        self.head = Dense(cin, cfg.num_classes, torch.float32, dev)

    def blocks(self):
        return [getattr(self, f"stage{i + 1}_block{j + 1}")
                for i, count in enumerate(self.cfg.stage_sizes)
                for j in range(count)]

    def forward(self, x):
        """``x`` ``[b, h, w, 3]`` (any float dtype) -> f32 logits
        ``[b, num_classes]``."""
        x = x.to(self.cfg.dtype).permute(0, 3, 1, 2)  # channels_last view
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for block in self.blocks():
            x = block(x)
        x = x.float().mean((2, 3)).to(self.cfg.dtype)
        return self.head(x)


def resnet50(num_classes: int = 1000, dtype=torch.bfloat16,
             width: int = 64, device=None) -> ResNet:
    return ResNet(dataclasses.replace(RESNET50, num_classes=num_classes,
                                      dtype=dtype, width=width), device)


def resnet_tiny(num_classes: int = 10, dtype=torch.bfloat16,
                device=None) -> ResNet:
    """Small variant for tests and dry runs."""
    return ResNet(dataclasses.replace(RESNET_TINY, num_classes=num_classes,
                                      dtype=dtype), device)
