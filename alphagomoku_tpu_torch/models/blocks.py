"""Network building blocks of every trunk of the zoo, as `nn.Module`s.

Port of the reference package's `models/blocks.py` (reference:
src/networks/blocks.cpp:32-208, the ConvNext block of
src/networks/networks.cpp:1154-1218): the residual, bottleneck (v1-v3),
ConvNext, mixture-of-experts ConvNext and transformer blocks, the U-net
trunk with its space-to-depth resampling, and the heads.  Inside a module tensors are NCHW;
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

Under tensor parallelism a `Conv` or `Dense` whose weight holds only this
rank's slice of its output channels (placed so by
`parallel.sharding.shard_state_`) is column-parallel: it computes its
slice and all-gathers the channels, through `ParallelLayer.tensor_parallel`
(set by `parallel.distributed.make_dp_train_step` for one step).  Every
other leaf computes replicated.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

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
    momentum 0.1 and unbiased variance).

    Under data parallelism the batch is the global one: `sync_moments`,
    when set (by `parallel.distributed.make_dp_train_step`, for one step),
    maps the local batch's mean and E[x^2] to the global batch's through a
    differentiable all-reduce, so that every rank normalizes and moves its
    running averages alike."""

    sync_moments: Callable[[torch.Tensor, torch.Tensor], tuple] | None = None

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
        sq = (xf * xf).mean(dims)
        if BatchNorm.sync_moments is not None:
            mean, sq = BatchNorm.sync_moments(mean, sq)
        var = torch.clamp(sq - mean * mean, min=0.0)
        with torch.no_grad():
            keep = self.momentum
            self.running_mean.copy_(keep * self.running_mean + (1.0 - keep) * mean)
            self.running_var.copy_(keep * self.running_var + (1.0 - keep) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)
        return y.to(self.dtype)


class TensorParallel(NamedTuple):
    """A tensor-parallel step's view of its `tp` group (the Megatron f/g
    pair, as callables over torch.distributed)."""

    size: int  # ranks of the group
    rank: int  # this rank's place in it
    enter: Callable[[torch.Tensor], torch.Tensor]  # identity; backward all-reduces over tp
    gather: Callable[[torch.Tensor, int], torch.Tensor]  # the ranks' slices joined along a
    # dim; backward takes this rank's slice


class ParallelLayer(nn.Module):
    """Base of `Conv` and `Dense`.  Under tensor parallelism
    (`tensor_parallel` set, by `parallel.distributed.make_dp_train_step`,
    for the length of one step) a layer whose weight holds a slice of its
    output channels (dim 0, `tensor_split` over the tp ranks) computes that
    slice of its output from its whole input, entered through
    `TensorParallel.enter`, and all-gathers the channels; a grouped conv
    (the depthwise) takes the input channels of its groups.  A bias is
    added where its channels are: this rank's slice before the gather (an
    attention projection's, whose flax shape is 2-D, is placed with its
    weight), a whole one after it; the same adds as without tensor
    parallelism."""

    tensor_parallel: TensorParallel | None = None

    @staticmethod
    def _tp(name: str) -> TensorParallel:
        tp = ParallelLayer.tensor_parallel
        if tp is None:
            raise RuntimeError(f"{name} holds a slice of its output channels outside a "
                               "tensor-parallel step: gather the state first "
                               "(parallel.sharding.full_state_dict)")
        return tp


def full_parameter(p: torch.Tensor, size: int, dim: int) -> torch.Tensor:
    """A parameter that is not a layer's weight (a positional embedding),
    whole: under tensor parallelism, where it holds a slice of `dim`, its
    ranks' slices gathered (`TensorParallel.gather`)."""
    if p.shape[dim] == size:
        return p
    return ParallelLayer._tp("a parameter").gather(p, dim % p.dim())


class Conv(ParallelLayer):
    """'SAME'-padded conv in `dtype` (flax `nn.Conv`, bias added in `dtype`)."""

    def __init__(self, cin: int, cout: int, kernel: int, bias: bool = True, groups: int = 1,
                 dtype: torch.dtype = BF16):
        super().__init__()
        self.conv = nn.Conv2d(
            cin, cout, kernel, padding=kernel // 2, bias=bias, groups=groups
        )
        self.dtype = dtype

    def forward(self, x):
        weight, groups = self.conv.weight, self.conv.groups
        cout = self.conv.out_channels
        local = weight.shape[0]
        if local != cout:
            tp = self._tp("a Conv")
            x = tp.enter(x)
            if groups > 1:  # this slice's groups, and their input channels
                per_out, per_in = cout // groups, self.conv.in_channels // groups
                g0, groups = tp.rank * local // per_out, local // per_out
                x = x[:, g0 * per_in:(g0 + groups) * per_in]
        y = F.conv2d(
            x.to(self.dtype), weight.to(self.dtype), padding=self.conv.padding, groups=groups,
        )
        bias = self.conv.bias
        if bias is not None and bias.shape[0] == y.shape[1]:  # the bias of y's channels
            y, bias = y + bias.to(self.dtype)[None, :, None, None], None
        if local != cout:
            y = self._tp("a Conv").gather(y, 1)
        if bias is not None:
            y = y + full_parameter(bias, cout, 0).to(self.dtype)[None, :, None, None]
        return y


class Dense(ParallelLayer):
    """Dense layer in `dtype` (flax `nn.Dense`, bias added in `dtype`)."""

    def __init__(self, cin: int, cout: int, bias: bool = True, dtype: torch.dtype = BF16):
        super().__init__()
        self.linear = nn.Linear(cin, cout, bias=bias)
        self.dtype = dtype

    def forward(self, x):
        weight, bias = self.linear.weight, self.linear.bias
        cout = self.linear.out_features
        sharded = weight.shape[0] != cout
        if sharded:
            x = self._tp("a Dense").enter(x)
        y = F.linear(x.to(self.dtype), weight.to(self.dtype))
        if bias is not None and bias.shape[0] == y.shape[-1]:  # the bias of y's channels
            y, bias = y + bias.to(self.dtype), None
        if sharded:
            y = self._tp("a Dense").gather(y, y.dim() - 1)
        if bias is not None:
            y = y + full_parameter(bias, cout, 0).to(self.dtype)
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


class ResidualBlock(nn.Module):
    """conv3x3-BN-relu, conv3x3-BN, add, relu
    (reference: blocks.cpp:45-55 createResidualBlock)."""

    def __init__(self, filters: int, dtype: torch.dtype = BF16):
        super().__init__()
        self.conv1 = ConvBN(filters, filters, 3, True, dtype)
        self.conv2 = ConvBN(filters, filters, 3, False, dtype)

    def forward(self, x, train: bool = False):
        return torch.relu(x + self.conv2(self.conv1(x, train), train))


# (kernel, output is the full width, relu) of each ConvBN of a bottleneck
# block, by version (reference: blocks.cpp:56-97)
_BOTTLENECK = {
    1: ((3, False, True), (3, True, False)),
    2: ((1, False, True), (3, False, True), (3, False, True), (1, True, False)),
    3: ((1, False, True), (3, False, True), (3, True, False)),
}


class BottleneckBlock(nn.Module):
    """Bottleneck residual blocks v1-v3: ConvBNs through half the width
    back to the full width, add, relu (reference: blocks.cpp:56-97)."""

    def __init__(self, filters: int, version: int = 1, dtype: torch.dtype = BF16):
        super().__init__()
        if version not in _BOTTLENECK:
            raise ValueError(f"bottleneck version {version}")
        half, cin, convs = filters // 2, filters, []
        for kernel, full, relu in _BOTTLENECK[version]:
            cout = filters if full else half
            convs.append(ConvBN(cin, cout, kernel, relu, dtype))
            cin = cout
        self.convs = nn.ModuleList(convs)

    def forward(self, x, train: bool = False):
        y = x
        for conv in self.convs:
            y = conv(y, train)
        return torch.relu(x + y)


class RMSNorm(nn.Module):
    """flax `nn.RMSNorm` over the last dimension: the mean square in
    float32, epsilon 1e-6, a learned scale, the result rounded to `dtype`."""

    def __init__(self, features: int, eps: float = 1e-6, dtype: torch.dtype = BF16):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))

    def forward(self, x):
        xf = x.float()
        mul = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + self.eps) * self.weight
        return (xf * mul).to(self.dtype)


def softmax_in(x, dtype):
    """jax.nn.softmax over the last dimension in `dtype`: each elementwise
    step rounded to `dtype`, the sum accumulated in float32 and rounded."""
    e = torch.exp(x - x.amax(-1, keepdim=True))
    return e / e.float().sum(-1, keepdim=True).to(dtype)


class SelfAttention(nn.Module):
    """flax `nn.SelfAttention` (`MultiHeadDotProductAttention` with one
    input): q/k/v projections with biases, the query divided by
    sqrt(head_dim) before the product, the softmax in the compute dtype
    (flax's `force_fp32_for_softmax` is off by default), the output
    projection over (heads, head_dim).  The projections are stored as dense
    (out, in) matrices; `models/convert.py` reshapes flax's
    [C, heads, head_dim] and [heads, head_dim, C] kernels to them."""

    def __init__(self, features: int, heads: int, out_features: int,
                 dtype: torch.dtype = BF16):
        super().__init__()
        self.heads = heads
        self.dtype = dtype
        self.query = Dense(features, features, dtype=dtype)
        self.key = Dense(features, features, dtype=dtype)
        self.value = Dense(features, features, dtype=dtype)
        self.out = Dense(features, out_features, dtype=dtype)

    def forward(self, x):  # [B, L, C]
        b, n, _ = x.shape
        split = lambda t: t.reshape(b, n, self.heads, -1).transpose(1, 2)  # [B, h, L, d]
        q, k, v = split(self.query(x)), split(self.key(x)), split(self.value(x))
        depth = q.shape[-1]
        q = q / torch.tensor(math.sqrt(depth), dtype=torch.float32).to(q.dtype)
        w = softmax_in(q @ k.transpose(-1, -2), q.dtype)
        y = (w @ v).transpose(1, 2).reshape(b, n, -1)
        return self.out(y)


class TransformerBlock(nn.Module):
    """Pre-norm multi-head attention + FFN over the board's cells as tokens,
    with a learned positional embedding of shape [1, H*W, C], so that a
    network holding one fixes its board size (reference: blocks.cpp:172-208
    mha_pre_norm_block / ffn_pre_norm_block)."""

    HEADS = 4

    def __init__(self, filters: int, embed: int, tokens: int, dtype: torch.dtype = BF16):
        super().__init__()
        self.dtype = dtype
        self.norm1 = RMSNorm(filters, dtype=dtype)
        self.pos_embedding = nn.Parameter(torch.zeros(1, tokens, filters))
        self.attn = SelfAttention(embed, self.HEADS, filters, dtype)
        self.norm2 = RMSNorm(filters, dtype=dtype)
        self.fc1 = Dense(filters, embed, dtype=dtype)
        self.fc2 = Dense(embed, filters, dtype=dtype)

    def forward(self, x, train: bool = False):
        b, c, h, w = x.shape
        tokens = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
        y = self.norm1(tokens) + full_parameter(self.pos_embedding, c, 2).to(self.dtype)
        tokens = tokens + self.attn(y)
        z = self.fc2(torch.relu(self.fc1(self.norm2(tokens))))
        tokens = tokens + z
        return tokens.reshape(b, h, w, c).permute(0, 3, 1, 2)


def space_to_depth(x, block: int = 2):
    """NCHW [B, C, H, W] -> [B, b*b*C, ceil(H/b), ceil(W/b)], zero-padded at
    the bottom and right, channel (i*b + j)*C + c holding cell (i, j) of
    each b x b tile (reference: ml::SpaceToDepth, networks.cpp:770-780)."""
    bsz, c, h, w = x.shape
    ph, pw = (-h) % block, (-w) % block
    if ph or pw:
        x = F.pad(x, (0, pw, 0, ph))
    h2, w2 = (h + ph) // block, (w + pw) // block
    x = x.reshape(bsz, c, h2, block, w2, block).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(bsz, block * block * c, h2, w2)


def depth_to_space(x, block: int, out_hw: tuple[int, int]):
    """Inverse of `space_to_depth`, cropped to `out_hw`
    (reference: ml::DepthToSpace(2, {h, w}))."""
    bsz, cc, h2, w2 = x.shape
    c = cc // (block * block)
    x = x.reshape(bsz, block, block, c, h2, w2).permute(0, 3, 4, 1, 5, 2)
    x = x.reshape(bsz, c, h2 * block, w2 * block)
    return x[:, :, : out_hw[0], : out_hw[1]]


class UnetTrunk(nn.Module):
    """3-level U-Net trunk: residual groups of ConvBN-relus at full, 1/2 and
    1/4 resolution, space-to-depth down and depth-to-space up, skip adds;
    `bottleneck="transformer"` puts two attention blocks at the coarsest
    level (reference: ConvUnet networks.cpp:749-830, TransformerUnet
    :846-920).  `convs` holds the ConvBNs in the order the reference
    package's module creates them (its ConvBN_0, ConvBN_1, ...), `attn` the
    transformer blocks."""

    def __init__(self, filters: int, rows: int, cols: int, bottleneck: str = "conv",
                 dtype: torch.dtype = BF16):
        super().__init__()
        e = filters
        specs = [(e, e, 3)] * 3 + [(4 * e, 2 * e, 1)] + [(2 * e, 2 * e, 3)] * 3
        specs += [(8 * e, 4 * e, 1)]
        if bottleneck == "transformer":
            quarter = lambda n: -(-(-(-n // 2)) // 2)  # ceil(ceil(n / 2) / 2)
            tokens = quarter(rows) * quarter(cols)
            self.attn = nn.ModuleList(
                TransformerBlock(4 * e, 4 * e, tokens, dtype) for _ in range(2))
        else:
            self.attn = None
            specs += [(4 * e, 4 * e, 3)] * 4
        specs += [(e, 2 * e, 1)] + [(2 * e, 2 * e, 3)] * 3 + [(e // 2, e, 1)] + [(e, e, 3)] * 3
        self.convs = nn.ModuleList(ConvBN(cin, cout, k, True, dtype) for cin, cout, k in specs)

    def forward(self, x, train: bool = False):
        convs = iter(self.convs)

        def conv(y):
            return next(convs)(y, train)

        def group(y, n):
            z = y
            for _ in range(n):
                z = conv(z)
            return y + z

        h, w = x.shape[2], x.shape[3]
        level0 = group(x, 3)
        level1 = group(conv(space_to_depth(level0, 2)), 3)
        x = conv(space_to_depth(level1, 2))
        if self.attn is not None:
            for blk in self.attn:
                x = blk(x, train)
        else:
            x = group(group(x, 2), 2)
        x = conv(depth_to_space(x, 2, (level1.shape[2], level1.shape[3])))
        x = group(x + level1, 3)
        x = conv(depth_to_space(x, 2, (h, w)))
        return group(x + level0, 3)


class MoEConvNextBlock(nn.Module):
    """ConvNext block whose pointwise MLP is a mixture of experts: every
    expert runs densely and a hard top-1 gate, weighted by the router's
    float32 probability, selects per cell (the reference package's
    TPU-native form of ConvNextMoE_PVQMraw's last block, networks.cpp:
    1334-1369).  The argmax takes the first of tied probabilities, as
    `jnp.argmax` does."""

    EXPERTS = 4

    def __init__(self, filters: int, dtype: torch.dtype = BF16):
        super().__init__()
        self.dtype = dtype
        self.dw = Conv(filters, filters, 7, bias=False, groups=filters, dtype=dtype)
        self.bn = BatchNorm(filters, dtype=dtype)
        self.router = Conv(filters, self.EXPERTS, 1, bias=False, dtype=dtype)
        self.up = nn.ModuleList(Conv(filters, filters, 1, dtype=dtype)
                                for _ in range(self.EXPERTS))
        self.down = nn.ModuleList(Conv(filters, filters, 1, bias=False, dtype=dtype)
                                  for _ in range(self.EXPERTS))
        self.se = SqueezeExcitation(filters, dtype)

    def forward(self, x, train: bool = False):
        x = self.bn(self.dw(x), train) + x
        probs = softmax_in(self.router(x).float().movedim(1, -1), torch.float32)  # [B, H, W, E]
        top = F.one_hot(probs.argmax(-1), self.EXPERTS).to(probs.dtype)
        gate = (probs * top).to(self.dtype).movedim(-1, 1)  # [B, E, H, W]
        out = None
        for e in range(self.EXPERTS):
            oe = self.down[e](torch.relu(self.up[e](x))) * gate[:, e : e + 1]
            out = oe if out is None else out + oe
        return self.se(out + x)


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
