"""Network building blocks for the convnext trunk family, as `nn.Module`s.

Port of the reference package's `models/blocks.py` (reference:
src/networks/blocks.cpp:32-208, the ConvNext block of
src/networks/networks.cpp:1154-1218).  Inside a module tensors are NCHW;
parameters are float32 and the forward computes in bfloat16 with float32
BatchNorm arithmetic, matching the reference package's `dtype=bfloat16`
modules: each conv / dense casts its input and weights to bf16 and rounds
its output to bf16; BatchNorm (inference) is folded to a per-channel
`x * s + t` in float32.  Heads return float32 LOGITS.

Parameter and buffer names follow the flax module tree so that
`models/convert.py` maps a flax checkpoint onto `state_dict()` keys.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

BF16 = torch.bfloat16


def fold_bn(scale, bias, mean, var, eps: float = 1e-5):
    """BatchNorm (inference) -> y = x * s + t."""
    s = scale / torch.sqrt(var + eps)
    return s, bias - mean * s


class BatchNorm(nn.Module):
    """Inference BatchNorm over dimension 1 (flax `nn.BatchNorm`, eps 1e-5)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def folded(self):
        return fold_bn(self.weight, self.bias, self.running_mean, self.running_var, self.eps)

    def forward(self, x):
        s, t = self.folded()
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return (x.float() * s.reshape(shape) + t.reshape(shape)).to(BF16)


class Conv(nn.Module):
    """'SAME'-padded conv in bf16 (flax `nn.Conv`, bias added in bf16)."""

    def __init__(self, cin: int, cout: int, kernel: int, bias: bool = True, groups: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(
            cin, cout, kernel, padding=kernel // 2, bias=bias, groups=groups
        )

    def forward(self, x):
        y = F.conv2d(
            x.to(BF16), self.conv.weight.to(BF16), padding=self.conv.padding,
            groups=self.conv.groups,
        )
        if self.conv.bias is not None:
            y = y + self.conv.bias.to(BF16)[None, :, None, None]
        return y


class Dense(nn.Module):
    """Dense layer in bf16 (flax `nn.Dense`, bias added in bf16)."""

    def __init__(self, cin: int, cout: int, bias: bool = True):
        super().__init__()
        self.linear = nn.Linear(cin, cout, bias=bias)

    def forward(self, x):
        y = F.linear(x.to(BF16), self.linear.weight.to(BF16))
        if self.linear.bias is not None:
            y = y + self.linear.bias.to(BF16)
        return y


def spatial_mean(x):
    """Mean over H, W of a bf16 NCHW tensor, accumulated in float32."""
    return x.float().mean(dim=(2, 3)).to(BF16)


class ConvBN(nn.Module):
    """Conv (no bias) + BatchNorm, with optional relu
    (reference: blocks.cpp conv_bn_relu/conv_bn)."""

    def __init__(self, cin: int, filters: int, kernel: int = 3, relu: bool = True):
        super().__init__()
        self.conv = Conv(cin, filters, kernel, bias=False)
        self.bn = BatchNorm(filters)
        self.relu = relu

    def forward(self, x):
        x = self.bn(self.conv(x))
        return torch.relu(x) if self.relu else x


class SqueezeExcitation(nn.Module):
    """Global-average-pool channel gating
    (reference: blocks.cpp:129-143 squeeze_and_excitation_block)."""

    def __init__(self, filters: int):
        super().__init__()
        self.fc1 = Dense(filters, filters)
        self.fc2 = Dense(filters, filters)

    def forward(self, x):
        z = torch.relu(self.fc1(spatial_mean(x)))
        z = torch.sigmoid(self.fc2(z))
        return x * z[:, :, None, None]


class ConvNextBlock(nn.Module):
    """Depthwise 7x7 + BN + pointwise expand/project with residual, then
    squeeze-excitation (reference: networks.cpp:1163-1181)."""

    def __init__(self, filters: int):
        super().__init__()
        self.dw = Conv(filters, filters, 7, bias=False, groups=filters)
        self.bn = BatchNorm(filters)
        self.pw1 = Conv(filters, filters, 1)
        self.pw2 = Conv(filters, filters, 1)
        self.se = SqueezeExcitation(filters)

    def forward(self, x):
        y = self.bn(self.dw(x))
        y = torch.relu(self.pw1(y))
        return self.se(self.pw2(y) + x)


class PolicyHead(nn.Module):
    """ConvBN-relu then a 1x1 conv to one logit per cell
    (reference: networks.cpp:1185-1189).  Returns logits [B, H, W]."""

    def __init__(self, filters: int, kernel: int = 1):
        super().__init__()
        self.conv_bn = ConvBN(filters, filters, kernel)
        self.out = Conv(filters, 1, 1)

    def forward(self, x):
        return self.out(self.conv_bn(x))[:, 0].float()


class ValueHead(nn.Module):
    """1x1 conv-relu, global mean, dense-BN-relu, dense to 3-way
    win/draw/loss logits (reference: networks.cpp:1192-1198)."""

    def __init__(self, filters: int, hidden: int):
        super().__init__()
        self.conv = Conv(filters, filters, 1)
        self.fc1 = Dense(filters, hidden, bias=False)
        self.bn = BatchNorm(hidden)
        self.fc2 = Dense(hidden, 3)

    def forward(self, x):
        v = spatial_mean(torch.relu(self.conv(x)))
        v = torch.relu(self.bn(self.fc1(v)))
        return self.fc2(v).float()


class ActionValuesHead(nn.Module):
    """Per-cell 3-way action-value logits, returned NHWC [B, H, W, 3]
    (reference: networks.cpp:1201-1205)."""

    def __init__(self, filters: int, kernel: int = 1):
        super().__init__()
        self.conv_bn = ConvBN(filters, filters, kernel)
        self.out = Conv(filters, 3, 1)

    def forward(self, x):
        return self.out(self.conv_bn(x)).float().permute(0, 2, 3, 1)


class MovesLeftHead(nn.Module):
    """Distribution over 0..H*W-1 moves left, as logits [B, H*W]
    (reference: networks.cpp:1208-1215)."""

    def __init__(self, filters: int, buckets: int, hidden: int = 128):
        super().__init__()
        self.conv = Conv(filters, 32, 1)
        self.fc1 = Dense(32, hidden, bias=False)
        self.bn = BatchNorm(hidden)
        self.fc2 = Dense(hidden, buckets)

    def forward(self, x):
        m = spatial_mean(torch.relu(self.conv(x)))
        m = torch.relu(self.bn(self.fc1(m)))
        return self.fc2(m).float()
