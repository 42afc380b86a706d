"""Network building blocks for the convnext trunk family, as `nn.Module`s.

Port of the reference package's `models/blocks.py` (reference:
src/networks/blocks.cpp:32-208, the ConvNext block of
src/networks/networks.cpp:1154-1218).  Inside a module tensors are NCHW;
parameters are float32 and the forward computes in `dtype` (bfloat16 by
default) with float32 BatchNorm arithmetic, matching the reference
package's `dtype=bfloat16` modules: each conv / dense casts its input and
weights to `dtype` and rounds its output to it; BatchNorm (inference) is
folded to a per-channel `x * s + t` in float32.  Heads return float32
LOGITS.  `dtype=torch.float32` computes everything in float32, as the
reference package's modules do with `dtype=jnp.float32`.

Every module that holds a BatchNorm takes `train` as flax's modules do:
`train=False` (the default) is inference on the running statistics;
`train=True` normalizes by the batch's statistics and updates the running
averages in place, as flax's `apply(..., train=True,
mutable=["batch_stats"])` does.  `nn.Module.train()` / `.eval()` select
nothing here.  Gradients flow through every cast, so the float32
parameters get float32 gradients.

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
    """BatchNorm over dimension 1 (flax `nn.BatchNorm`: eps 1e-5, momentum
    0.99).  With `train`, the statistics are the batch's, in float32 over
    every dimension but 1: the mean and the fast, biased variance
    E[x^2] - E[x]^2 clipped at 0, as flax computes them; the running
    averages move as `ra = 0.99 ra + 0.01 stat` (not `F.batch_norm`'s
    momentum 0.1 and unbiased variance)."""

    def __init__(self, features: int, eps: float = 1e-5, momentum: float = 0.99,
                 dtype: torch.dtype = BF16):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def folded(self):
        return fold_bn(self.weight, self.bias, self.running_mean, self.running_var, self.eps)

    def forward(self, x, train: bool = False):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if not train:
            s, t = self.folded()
            return (x.float() * s.reshape(shape) + t.reshape(shape)).to(self.dtype)
        xf = x.float()
        dims = [d for d in range(x.dim()) if d != 1]
        mean = xf.mean(dims)
        var = torch.clamp((xf * xf).mean(dims) - mean * mean, min=0.0)
        with torch.no_grad():
            keep = self.momentum
            self.running_mean.copy_(keep * self.running_mean + (1.0 - keep) * mean)
            self.running_var.copy_(keep * self.running_var + (1.0 - keep) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)
        return y.to(self.dtype)


class Conv(nn.Module):
    """'SAME'-padded conv in `dtype` (flax `nn.Conv`, bias added in `dtype`)."""

    def __init__(self, cin: int, cout: int, kernel: int, bias: bool = True, groups: int = 1,
                 dtype: torch.dtype = BF16):
        super().__init__()
        self.conv = nn.Conv2d(
            cin, cout, kernel, padding=kernel // 2, bias=bias, groups=groups
        )
        self.dtype = dtype

    def forward(self, x):
        y = F.conv2d(
            x.to(self.dtype), self.conv.weight.to(self.dtype), padding=self.conv.padding,
            groups=self.conv.groups,
        )
        if self.conv.bias is not None:
            y = y + self.conv.bias.to(self.dtype)[None, :, None, None]
        return y


class Dense(nn.Module):
    """Dense layer in `dtype` (flax `nn.Dense`, bias added in `dtype`)."""

    def __init__(self, cin: int, cout: int, bias: bool = True, dtype: torch.dtype = BF16):
        super().__init__()
        self.linear = nn.Linear(cin, cout, bias=bias)
        self.dtype = dtype

    def forward(self, x):
        y = F.linear(x.to(self.dtype), self.linear.weight.to(self.dtype))
        if self.linear.bias is not None:
            y = y + self.linear.bias.to(self.dtype)
        return y


def spatial_mean(x):
    """Mean over H, W of an NCHW tensor, accumulated in float32."""
    return x.float().mean(dim=(2, 3)).to(x.dtype)


class ConvBN(nn.Module):
    """Conv (no bias) + BatchNorm, with optional relu
    (reference: blocks.cpp conv_bn_relu/conv_bn)."""

    def __init__(self, cin: int, filters: int, kernel: int = 3, relu: bool = True,
                 dtype: torch.dtype = BF16):
        super().__init__()
        self.conv = Conv(cin, filters, kernel, bias=False, dtype=dtype)
        self.bn = BatchNorm(filters, dtype=dtype)
        self.relu = relu

    def forward(self, x, train: bool = False):
        x = self.bn(self.conv(x), train)
        return torch.relu(x) if self.relu else x


class SqueezeExcitation(nn.Module):
    """Global-average-pool channel gating
    (reference: blocks.cpp:129-143 squeeze_and_excitation_block)."""

    def __init__(self, filters: int, dtype: torch.dtype = BF16):
        super().__init__()
        self.fc1 = Dense(filters, filters, dtype=dtype)
        self.fc2 = Dense(filters, filters, dtype=dtype)

    def forward(self, x):
        z = torch.relu(self.fc1(spatial_mean(x)))
        z = torch.sigmoid(self.fc2(z))
        return x * z[:, :, None, None]


class ConvNextBlock(nn.Module):
    """Depthwise 7x7 + BN + pointwise expand/project with residual, then
    squeeze-excitation (reference: networks.cpp:1163-1181)."""

    def __init__(self, filters: int, dtype: torch.dtype = BF16):
        super().__init__()
        self.dw = Conv(filters, filters, 7, bias=False, groups=filters, dtype=dtype)
        self.bn = BatchNorm(filters, dtype=dtype)
        self.pw1 = Conv(filters, filters, 1, dtype=dtype)
        self.pw2 = Conv(filters, filters, 1, dtype=dtype)
        self.se = SqueezeExcitation(filters, dtype)

    def forward(self, x, train: bool = False):
        y = self.bn(self.dw(x), train)
        y = torch.relu(self.pw1(y))
        return self.se(self.pw2(y) + x)


class PolicyHead(nn.Module):
    """ConvBN-relu then a 1x1 conv to one logit per cell
    (reference: networks.cpp:1185-1189).  Returns logits [B, H, W]."""

    def __init__(self, filters: int, kernel: int = 1, dtype: torch.dtype = BF16):
        super().__init__()
        self.conv_bn = ConvBN(filters, filters, kernel, dtype=dtype)
        self.out = Conv(filters, 1, 1, dtype=dtype)

    def forward(self, x, train: bool = False):
        return self.out(self.conv_bn(x, train))[:, 0].float()


class ValueHead(nn.Module):
    """1x1 conv-relu, global mean, dense-BN-relu, dense to 3-way
    win/draw/loss logits (reference: networks.cpp:1192-1198)."""

    def __init__(self, filters: int, hidden: int, dtype: torch.dtype = BF16):
        super().__init__()
        self.conv = Conv(filters, filters, 1, dtype=dtype)
        self.fc1 = Dense(filters, hidden, bias=False, dtype=dtype)
        self.bn = BatchNorm(hidden, dtype=dtype)
        self.fc2 = Dense(hidden, 3, dtype=dtype)

    def forward(self, x, train: bool = False):
        v = spatial_mean(torch.relu(self.conv(x)))
        v = torch.relu(self.bn(self.fc1(v), train))
        return self.fc2(v).float()


class ActionValuesHead(nn.Module):
    """Per-cell 3-way action-value logits, returned NHWC [B, H, W, 3]
    (reference: networks.cpp:1201-1205)."""

    def __init__(self, filters: int, kernel: int = 1, dtype: torch.dtype = BF16):
        super().__init__()
        self.conv_bn = ConvBN(filters, filters, kernel, dtype=dtype)
        self.out = Conv(filters, 3, 1, dtype=dtype)

    def forward(self, x, train: bool = False):
        return self.out(self.conv_bn(x, train)).float().permute(0, 2, 3, 1)


class MovesLeftHead(nn.Module):
    """Distribution over 0..H*W-1 moves left, as logits [B, H*W]
    (reference: networks.cpp:1208-1215)."""

    def __init__(self, filters: int, buckets: int, hidden: int = 128,
                 dtype: torch.dtype = BF16):
        super().__init__()
        self.conv = Conv(filters, 32, 1, dtype=dtype)
        self.fc1 = Dense(32, hidden, bias=False, dtype=dtype)
        self.bn = BatchNorm(hidden, dtype=dtype)
        self.fc2 = Dense(hidden, buckets, dtype=dtype)

    def forward(self, x, train: bool = False):
        m = spatial_mean(torch.relu(self.conv(x)))
        m = torch.relu(self.bn(self.fc1(m), train))
        return self.fc2(m).float()
