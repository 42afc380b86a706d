"""The network zoo: the registry and one parametric network.

Port of the reference package's `models/networks.py`: `NetOutput`,
`ModelConfig`, `AGNetwork` with every trunk (resnet, bottleneck v1-v3,
convnext, convnext_moe, transformer, unet, unet_transformer), the
`create_network` registry with every reference architecture name
(reference: include/alphagomoku/networks/networks.hpp:16-250),
`postprocess` and `value_expectation` (`search/score.py`'s).  Inputs and
spatial outputs are NHWC at this public boundary, as in the reference
package; the modules are NCHW inside.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import NamedTuple

import torch
from torch import nn

from ..search.score import value_expectation  # noqa: F401  (w + d/2 of (win, draw, ...) heads)
from . import blocks as B


class NetOutput(NamedTuple):
    """Raw head outputs (logits, float32)."""

    policy_logits: torch.Tensor  # [B, H, W]
    value_logits: torch.Tensor  # [B, 3] (win, draw, loss) from side-to-move view
    q_logits: torch.Tensor | None  # [B, H, W, 3]
    moves_left_logits: torch.Tensor | None  # [B, H*W]
    soft_policy_logits: torch.Tensor | None  # [B, H, W]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static architecture description (reference: TrainingConfig blocks /
    filters, utils/configs.hpp TrainingConfig)."""

    trunk: str = "convnext"
    blocks: int = 6
    filters: int = 64
    heads: str = "pvqm"  # subset of "pvqms", p and v mandatory
    raw_input: bool = True  # 8 raw planes instead of 32 feature planes
    input_kernel: int = 5
    dtype: torch.dtype = torch.bfloat16  # compute dtype (parameters stay float32)

    @property
    def input_planes(self) -> int:
        return 8 if self.raw_input else 32


TRUNKS = ("resnet", "bottleneck_v1", "bottleneck_v2", "bottleneck_v3", "convnext",
          "convnext_moe", "transformer", "unet", "unet_transformer")


def _trunk_block(cfg: ModelConfig, i: int, rows: int, cols: int) -> nn.Module:
    """Block i of a block-stack trunk, as the reference package's
    `AGNetwork.__call__` builds it."""
    f, dt = cfg.filters, cfg.dtype
    if cfg.trunk == "resnet":
        return B.ResidualBlock(f, dt)
    if cfg.trunk.startswith("bottleneck"):
        return B.BottleneckBlock(f, int(cfg.trunk[-1]), dt)
    if cfg.trunk == "convnext_moe" and i == cfg.blocks - 1:
        # the reference puts the MoE in the LAST block only
        # (ConvNextMoE_PVQMraw, networks.cpp:1334-1369)
        return B.MoEConvNextBlock(f, dt)
    if cfg.trunk in ("convnext", "convnext_moe"):
        return B.ConvNextBlock(f, dt)
    return B.TransformerBlock(f, f, rows * cols, dt)


class AGNetwork(nn.Module):
    """Stem + trunk + heads.  Input: [B, H, W, C] planes (C = 8 raw or 32
    feature planes); `rows`, `cols` size the moves-left head and the
    transformer blocks' positional embeddings.  A block-stack trunk is
    `blocks`; the unet trunks (which ignore `cfg.blocks`) are `unet`."""

    def __init__(self, cfg: ModelConfig, rows: int = 15, cols: int = 15):
        super().__init__()
        if cfg.trunk not in TRUNKS:
            raise ValueError(f"unknown trunk {cfg.trunk!r}")
        f, dt = cfg.filters, cfg.dtype
        self.cfg = cfg
        self.stem = B.ConvBN(cfg.input_planes, f, cfg.input_kernel, dtype=dt)
        if cfg.trunk.startswith("unet"):
            self.blocks = nn.ModuleList()
            self.unet = B.UnetTrunk(f, rows, cols, "transformer" if cfg.trunk.endswith(
                "transformer") else "conv", dt)
        else:
            self.blocks = nn.ModuleList(
                _trunk_block(cfg, i, rows, cols) for i in range(cfg.blocks))
            self.unet = None
        pk = 1 if cfg.trunk == "convnext" else 3  # head kernel (reference package)
        self.policy = B.PolicyHead(f, pk, dt)
        self.value = B.ValueHead(f, min(256, 2 * f), dt)
        self.q = B.ActionValuesHead(f, pk, dt) if "q" in cfg.heads else None
        self.moves_left = B.MovesLeftHead(f, rows * cols, dtype=dt) if "m" in cfg.heads else None
        self.soft_policy = B.PolicyHead(f, pk, dt) if "s" in cfg.heads else None

    def stem_forward(self, planes: torch.Tensor, train: bool = False) -> torch.Tensor:
        """NHWC planes -> NCHW stem activation in the compute dtype."""
        return self.stem(planes.permute(0, 3, 1, 2).to(self.cfg.dtype), train)

    def heads_forward(self, x: torch.Tensor, train: bool = False) -> NetOutput:
        """NCHW trunk activation -> head logits."""
        opt = lambda head: head(x, train) if head is not None else None
        return NetOutput(
            self.policy(x, train), self.value(x, train), opt(self.q), opt(self.moves_left),
            opt(self.soft_policy),
        )

    def _run(self, planes: torch.Tensor, train: bool) -> NetOutput:
        x = self.stem_forward(planes, train)
        for blk in self.blocks:
            x = blk(x, train)
        if self.unet is not None:
            x = self.unet(x, train)
        return self.heads_forward(x, train)

    @torch.no_grad()
    def forward(self, planes: torch.Tensor) -> NetOutput:
        """Inference on the running BatchNorm statistics, whatever the
        module's train/eval mode (flax `apply(train=False)`)."""
        return self._run(planes, False)

    def forward_train(self, planes: torch.Tensor) -> NetOutput:
        """The differentiable training forward: BatchNorm on the batch's
        statistics, with the running averages updated in place (flax
        `apply(train=True, mutable=["batch_stats"])`)."""
        return self._run(planes, True)


# ---------------------------------------------------------------------------
# Registry: reference architecture names -> ModelConfig fields
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, dict] = {
    "ResnetPV": dict(trunk="resnet", heads="pv", raw_input=False),
    "ResnetPVraw": dict(trunk="resnet", heads="pv", raw_input=True),
    "ResnetPVQ": dict(trunk="resnet", heads="pvq", raw_input=False),
    "ResnetPVQraw": dict(trunk="resnet", heads="pvq", raw_input=True),
    "ResnetOld": dict(trunk="resnet", heads="pv", raw_input=False),
    "ResnetPVraw_v0": dict(trunk="resnet", heads="pv", raw_input=True),
    "ResnetPVraw_v1": dict(trunk="resnet", heads="pv", raw_input=True),
    "ResnetPVraw_v2": dict(trunk="resnet", heads="pv", raw_input=True),
    "BottleneckPV": dict(trunk="bottleneck_v2", heads="pv", raw_input=False),
    "BottleneckPVraw": dict(trunk="bottleneck_v2", heads="pv", raw_input=True),
    "BottleneckBroadcastPVraw": dict(trunk="bottleneck_v3", heads="pv", raw_input=True),
    "BottleneckPoolingPVraw": dict(trunk="bottleneck_v3", heads="pv", raw_input=True),
    "BottleneckPVQ": dict(trunk="bottleneck_v2", heads="pvq", raw_input=False),
    "BottleneckPVUM": dict(trunk="bottleneck_v2", heads="pvm", raw_input=False),
    "ConvNextPVraw": dict(trunk="convnext", heads="pv", raw_input=True),
    "ConvNextPVQraw": dict(trunk="convnext", heads="pvq", raw_input=True),
    "ConvNextPVQMraw": dict(trunk="convnext", heads="pvqm", raw_input=True),
    "ConvNextPVQMSraw": dict(trunk="convnext", heads="pvqms", raw_input=True),
    "ConvNextMoE_PVQMraw": dict(trunk="convnext_moe", heads="pvqm", raw_input=True),
    "Transformer_v2": dict(trunk="transformer", heads="pvqm", raw_input=False),
    "TransformerUnet": dict(trunk="unet_transformer", heads="pv", raw_input=False),
    "ConvUnet": dict(trunk="unet", heads="pv", raw_input=False),
    "FastNetwork": dict(trunk="resnet", heads="pv", raw_input=True, blocks=2, filters=32),
    "FastPolicy": dict(trunk="resnet", heads="pv", raw_input=True, blocks=2, filters=32),
}


def model_config(arch: str, blocks: int | None = None, filters: int | None = None,
                 dtype: torch.dtype = torch.bfloat16) -> ModelConfig:
    if arch not in _REGISTRY:
        raise ValueError(f"unknown architecture {arch!r}; known: {sorted(_REGISTRY)}")
    kw = dict(_REGISTRY[arch])
    if blocks is not None:
        kw["blocks"] = blocks
    if filters is not None:
        kw["filters"] = filters
    return ModelConfig(**kw, dtype=dtype)


def create_network(
    arch: str, blocks: int | None = None, filters: int | None = None,
    rows: int = 15, cols: int = 15, dtype: torch.dtype = torch.bfloat16,
) -> AGNetwork:
    """Factory matching the reference's createAGNetwork(architecture)."""
    return AGNetwork(model_config(arch, blocks, filters, dtype), rows, cols)


def list_architectures() -> list[str]:
    return sorted(_REGISTRY)


@torch.no_grad()
def snapshot(net: AGNetwork) -> AGNetwork:
    """A detached inference copy of `net` (no gradients, eval mode), so
    that training `net` afterwards does not change it; `net` keeps its
    train/eval mode."""
    snap = copy.deepcopy(net).eval().requires_grad_(False)
    for p in snap.parameters():
        p.grad = None
    return snap


_BIAS_STD = 0.1
_POS_STD = 0.02  # flax's normal(0.02) of TransformerBlock.pos_embedding


def _norm_scales(net: nn.Module) -> set[int]:
    return {id(m.weight) for m in net.modules() if isinstance(m, (B.BatchNorm, B.RMSNorm))}


def _pos_embeddings(net: nn.Module) -> set[int]:
    return {id(m.pos_embedding) for m in net.modules() if isinstance(m, B.TransformerBlock)}


@torch.no_grad()
def init_random_(net: AGNetwork, generator: torch.Generator) -> AGNetwork:
    """Fill `net` in place with random weights drawn from `generator` (a
    CPU generator), in parameter order: conv and dense kernels from
    N(0, 1/fan_in), as flax's default `lecun_normal`; biases, BatchNorm
    shifts and the BatchNorm scales' offsets from 1 from N(0, 0.1^2), so
    that no bias is zero (a check that a kernel kept each bias needs them
    nonzero).  RMSNorm scales are drawn as BatchNorm scales, the transformer
    blocks' positional embeddings from N(0, 0.02^2), as flax initialises
    them.  The BatchNorm statistics stay at mean 0, variance 1.  Returns
    `net`."""
    scales, pos = _norm_scales(net), _pos_embeddings(net)
    for p in net.parameters():
        noise = torch.randn(p.shape, generator=generator, dtype=torch.float32)
        if id(p) in scales:
            p.copy_(1.0 + _BIAS_STD * noise)
        elif id(p) in pos:
            p.copy_(_POS_STD * noise)
        elif p.dim() > 1:  # conv (O, I, kh, kw) or dense (O, I) kernel
            p.copy_(noise / p[0].numel() ** 0.5)
        else:
            p.copy_(_BIAS_STD * noise)
    return net


@torch.no_grad()
def init_flax_(net: AGNetwork, generator: torch.Generator) -> AGNetwork:
    """Fill `net` in place as flax's default initializers fill a fresh
    network (the draws are `generator`'s, not `jax.random`'s): conv and
    dense kernels from `lecun_normal` (a normal of variance 1/fan_in
    truncated at two standard deviations), biases and BatchNorm shifts 0,
    BatchNorm and RMSNorm scales 1, positional embeddings from
    N(0, 0.02^2), statistics mean 0 and variance 1.  Returns `net`."""
    scales, pos = _norm_scales(net), _pos_embeddings(net)
    for p in net.parameters():
        if id(p) in scales:
            p.fill_(1.0)
        elif id(p) in pos:
            p.normal_(0.0, _POS_STD, generator=generator)
        elif p.dim() > 1:  # conv (O, I, kh, kw) or dense (O, I) kernel
            std = (1.0 / p[0].numel()) ** 0.5 / 0.87962566103423978
            nn.init.trunc_normal_(p, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
        else:
            p.zero_()
    for m in net.modules():
        if isinstance(m, B.BatchNorm):
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
    return net


# ---------------------------------------------------------------------------
# Inference-space postprocessing
# ---------------------------------------------------------------------------


class NetEval(NamedTuple):
    """Probability-space outputs the search consumes."""

    policy: torch.Tensor  # [B, H, W], masked + renormalized
    value: torch.Tensor  # [B, 3] (win, draw, loss) probabilities
    q: torch.Tensor | None  # [B, H, W, 3]
    moves_left: torch.Tensor | None  # [B] expectation


def postprocess(out: NetOutput, legal_mask: torch.Tensor) -> NetEval:
    """Masked softmax over legal cells + head softmaxes."""
    plogits = torch.where(legal_mask, out.policy_logits.float(), -1e9)
    bsz = plogits.shape[0]
    policy = torch.softmax(plogits.reshape(bsz, -1), dim=-1).reshape(plogits.shape)
    value = torch.softmax(out.value_logits.float(), dim=-1)
    q = torch.softmax(out.q_logits.float(), dim=-1) if out.q_logits is not None else None
    moves_left = None
    if out.moves_left_logits is not None:
        dist = torch.softmax(out.moves_left_logits.float(), dim=-1)
        moves_left = dist @ torch.arange(dist.shape[-1], dtype=torch.float32, device=dist.device)
    return NetEval(policy, value, q, moves_left)
