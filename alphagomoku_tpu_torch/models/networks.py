"""The network zoo registry and the convnext-trunk network.

Port of the reference package's `models/networks.py`: `NetOutput`,
`ModelConfig`, the `create_network` registry with every reference
architecture name (reference: include/alphagomoku/networks/
networks.hpp:16-250) and `postprocess`.  `AGNetwork` is ported for the
`convnext` trunk; the names whose trunk is not ported yet raise
NotImplementedError.  Inputs and spatial outputs are NHWC at this public
boundary, as in the reference package; the modules are NCHW inside.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch import nn

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

    @property
    def input_planes(self) -> int:
        return 8 if self.raw_input else 32


TRUNK_NOT_PORTED = (
    "trunk {!r} is not ported yet (ROADMAP.md, 'Modules to port', item 11: "
    "the rest of the network zoo)"
)


class AGNetwork(nn.Module):
    """Stem + convnext trunk + heads.  Input: [B, H, W, C] planes (C = 8 raw
    or 32 feature planes); `rows`, `cols` size the moves-left head."""

    def __init__(self, cfg: ModelConfig, rows: int = 15, cols: int = 15):
        super().__init__()
        if cfg.trunk != "convnext":
            raise NotImplementedError(TRUNK_NOT_PORTED.format(cfg.trunk))
        f = cfg.filters
        self.cfg = cfg
        self.stem = B.ConvBN(cfg.input_planes, f, cfg.input_kernel)
        self.blocks = nn.ModuleList(B.ConvNextBlock(f) for _ in range(cfg.blocks))
        self.policy = B.PolicyHead(f, 1)
        self.value = B.ValueHead(f, min(256, 2 * f))
        self.q = B.ActionValuesHead(f, 1) if "q" in cfg.heads else None
        self.moves_left = B.MovesLeftHead(f, rows * cols) if "m" in cfg.heads else None
        self.soft_policy = B.PolicyHead(f, 1) if "s" in cfg.heads else None

    def stem_forward(self, planes: torch.Tensor) -> torch.Tensor:
        """NHWC planes -> NCHW bf16 stem activation."""
        return self.stem(planes.permute(0, 3, 1, 2).to(B.BF16))

    def heads_forward(self, x: torch.Tensor) -> NetOutput:
        """NCHW bf16 trunk activation -> head logits."""
        opt = lambda head: head(x) if head is not None else None
        return NetOutput(
            self.policy(x), self.value(x), opt(self.q), opt(self.moves_left),
            opt(self.soft_policy),
        )

    @torch.no_grad()
    def forward(self, planes: torch.Tensor) -> NetOutput:
        x = self.stem_forward(planes)
        for blk in self.blocks:
            x = blk(x)
        return self.heads_forward(x)


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


def model_config(arch: str, blocks: int | None = None, filters: int | None = None) -> ModelConfig:
    if arch not in _REGISTRY:
        raise ValueError(f"unknown architecture {arch!r}; known: {sorted(_REGISTRY)}")
    kw = dict(_REGISTRY[arch])
    if blocks is not None:
        kw["blocks"] = blocks
    if filters is not None:
        kw["filters"] = filters
    return ModelConfig(**kw)


def create_network(
    arch: str, blocks: int | None = None, filters: int | None = None,
    rows: int = 15, cols: int = 15,
) -> AGNetwork:
    """Factory matching the reference's createAGNetwork(architecture)."""
    return AGNetwork(model_config(arch, blocks, filters), rows, cols)


def list_architectures() -> list[str]:
    return sorted(_REGISTRY)


_BIAS_STD = 0.1


@torch.no_grad()
def init_random_(net: AGNetwork, generator: torch.Generator) -> AGNetwork:
    """Fill `net` in place with random weights drawn from `generator` (a
    CPU generator), in parameter order: conv and dense kernels from
    N(0, 1/fan_in), as flax's default `lecun_normal`; biases, BatchNorm
    shifts and the BatchNorm scales' offsets from 1 from N(0, 0.1^2), so
    that no bias is zero (a check that a kernel kept each bias needs them
    nonzero).  The BatchNorm statistics stay at mean 0, variance 1.
    Returns `net`."""
    bn_scales = {id(m.weight) for m in net.modules() if isinstance(m, B.BatchNorm)}
    for p in net.parameters():
        noise = torch.randn(p.shape, generator=generator, dtype=torch.float32)
        if id(p) in bn_scales:
            p.copy_(1.0 + _BIAS_STD * noise)
        elif p.dim() > 1:  # conv (O, I, kh, kw) or dense (O, I) kernel
            p.copy_(noise / p[0].numel() ** 0.5)
        else:
            p.copy_(_BIAS_STD * noise)
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
