"""Fused ConvNext trunk: the whole block stack as one CUDA kernel, and the
network forward that runs it.

`fused_trunk` launches `csrc/convnext_trunk.cu` (the port of the Pallas
kernel `alphagomoku_tpu/ops/convnext_fused.py:_trunk_kernel`) for CUDA
tensors and runs `fused_trunk_plain` for CPU tensors.  Both keep the Pallas
body's numerics: bf16 storage, f32 accumulation in the depthwise taps and
the products, BatchNorm folded to a per-channel scale and shift (inference
only), and bf16 casts at the same points.

`fused_apply(weights, planes)` is the full ConvNextPVQMraw forward (stem,
fused trunk, heads) with its weights passed in explicitly as a
`FusedWeights` (built once by `pack_weights`).  On the card it is the
network `search.mcts.run_search` evaluates.  The stem conv and the heads
stay plain PyTorch ops, as they stay XLA ops in the reference package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.blocks import BF16, fold_bn
from ..models.networks import AGNetwork, NetOutput
from . import _build

__all__ = [
    "TrunkWeights", "fold_bn", "pack_trunk_weights", "fused_trunk",
    "fused_trunk_plain", "FusedWeights", "pack_weights", "fused_apply",
    "BLOCK_LIMITS", "TRUNK_LIMITS", "HEAD_LIMITS", "KERNEL_WIDTHS",
]

KERNEL_WIDTHS = (64, 128)  # the filter counts csrc/convnext_trunk.cu is built for

# How far the kernel may be from `fused_trunk_plain`, as limits of
# `utils.bf16.agreement`.  Both round at the same points, so they differ
# only where an f32 sum taken in another order lands across a bf16
# rounding boundary.  BLOCK_LIMITS hold one block (L = 1) fed the plain
# trunk's input to that block: such flips are rare there.  TRUNK_LIMITS
# hold all L blocks, where each flip spreads through the later blocks.
# `chip_smoke.py` prints the measured shares beside these limits, and those
# of kernels fed one bias left out, which these limits reject.
BLOCK_LIMITS = dict(max_ulps=2.0, max_share_over=1e-3, max_share_differ=1e-2)
TRUNK_LIMITS = dict(max_ulps=2.0, max_share_over=0.1, max_share_differ=0.25)
# HEAD_LIMITS hold the network's heads after the trunk: TRUNK_LIMITS with
# ulps counted of at least 1/16.  A head sums C trunk channels, so a trunk
# flip of one ulp moves a logit by an absolute amount that does not shrink
# with the logit; logits below 1/16 (all of a seeded network's policy
# logits) are held to 2 ulps of 1/16, 0.00098.
HEAD_LIMITS = dict(TRUNK_LIMITS, floor=2.0**-4)


class TrunkWeights(NamedTuple):
    dw: torch.Tensor  # [L, 7, 7, C] bf16 depthwise taps
    bn_s: torch.Tensor  # [L, C] f32 folded BN scale
    bn_t: torch.Tensor  # [L, C] f32 folded BN shift
    w1: torch.Tensor  # [L, C, C] bf16 (in, out)
    b1: torch.Tensor  # [L, C] f32
    w2: torch.Tensor  # [L, C, C] bf16
    b2: torch.Tensor  # [L, C] f32
    sw1: torch.Tensor  # [L, C, C] bf16 squeeze-excitation dense 1
    sb1: torch.Tensor  # [L, C] f32
    sw2: torch.Tensor  # [L, C, C] bf16
    sb2: torch.Tensor  # [L, C] f32


@torch.no_grad()
def pack_trunk_weights(net: AGNetwork) -> TrunkWeights:
    """Stack the per-block parameters into kernel-friendly tensors on the
    network's device."""
    cols = {k: [] for k in TrunkWeights._fields}
    for blk in net.blocks:
        cols["dw"].append(blk.dw.conv.weight[:, 0].permute(1, 2, 0))  # (7, 7, C)
        s, t = blk.bn.folded()
        cols["bn_s"].append(s)
        cols["bn_t"].append(t)
        cols["w1"].append(blk.pw1.conv.weight[:, :, 0, 0].t())
        cols["b1"].append(blk.pw1.conv.bias)
        cols["w2"].append(blk.pw2.conv.weight[:, :, 0, 0].t())
        cols["b2"].append(blk.pw2.conv.bias)
        cols["sw1"].append(blk.se.fc1.linear.weight.t())
        cols["sb1"].append(blk.se.fc1.linear.bias)
        cols["sw2"].append(blk.se.fc2.linear.weight.t())
        cols["sb2"].append(blk.se.fc2.linear.bias)
    bf = {"dw", "w1", "w2", "sw1", "sw2"}
    return TrunkWeights(**{
        k: torch.stack(v).to(BF16 if k in bf else torch.float32).contiguous()
        for k, v in cols.items()
    })


def fused_trunk_plain(x: torch.Tensor, w: TrunkWeights) -> torch.Tensor:
    """Plain PyTorch version of the fused trunk: [B, H, W, C] bf16 -> same."""
    bsz, h, wd, c = x.shape
    k = w.dw.shape[1]
    r = k // 2
    f32 = torch.float32
    for l in range(w.dw.shape[0]):
        pad = torch.zeros((bsz, h + 2 * r, wd + 2 * r, c), dtype=f32, device=x.device)
        pad[:, r : r + h, r : r + wd] = x.float()
        taps = w.dw[l].float()
        acc = torch.zeros((bsz, h, wd, c), dtype=f32, device=x.device)
        for di in range(k):
            for dj in range(k):
                acc = acc + pad[:, di : di + h, dj : dj + wd] * taps[di, dj]
        ym = (acc * w.bn_s[l] + w.bn_t[l]).to(BF16).reshape(-1, c)
        y1 = torch.relu(ym.float() @ w.w1[l].float() + w.b1[l]).to(BF16)
        y2 = (y1.float() @ w.w2[l].float() + w.b2[l]).to(BF16)
        x4 = (y2.float() + x.reshape(-1, c).float()).to(BF16).reshape(bsz, h, wd, c)
        z = x4.float().mean(dim=(1, 2)).to(BF16)
        h1 = torch.relu(z.float() @ w.sw1[l].float() + w.sb1[l]).to(BF16)
        g = torch.sigmoid(h1.float() @ w.sw2[l].float() + w.sb2[l]).to(BF16)
        x = (x4.float() * g.float()[:, None, None, :]).to(BF16)
    return x


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"fused_trunk: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"fused_trunk: {name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"fused_trunk: {name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"fused_trunk: {name} must be contiguous and 16-byte aligned")


def fused_trunk(x: torch.Tensor, w: TrunkWeights) -> torch.Tensor:
    """Run the whole ConvNext block stack on a [B, H, W, C] bf16 activation:
    the CUDA kernel for CUDA tensors, `fused_trunk_plain` for CPU tensors."""
    if x.device.type == "cpu":
        return fused_trunk_plain(x, w)
    bsz, h, wd, c = x.shape
    if c not in KERNEL_WIDTHS:
        raise NotImplementedError(
            f"fused_trunk kernel takes C in {KERNEL_WIDTHS} filters, got {c} (ROADMAP.md, "
            "'TPU kernels to port': other trunk widths)"
        )
    if x.device.type != "cuda":
        raise ValueError(f"fused_trunk: unsupported device {x.device}")
    nl = w.dw.shape[0]
    if w.dw.shape[1:3] != (7, 7):
        raise ValueError(f"fused_trunk: depthwise kernel {tuple(w.dw.shape[1:3])}, expected 7x7")
    dev = x.device
    _check("x", x, BF16, (bsz, h, wd, c), dev)
    for name in TrunkWeights._fields:
        t = getattr(w, name)
        if name == "dw":
            _check(name, t, BF16, (nl, 7, 7, c), dev)
        elif t.dim() == 3:
            _check(name, t, BF16, (nl, c, c), dev)
        else:
            _check(name, t, torch.float32, (nl, c), dev)
    out = torch.empty_like(x)
    lib = _build.library()
    err = lib.ag_convnext_trunk(
        x.data_ptr(), *(getattr(w, n).data_ptr() for n in TrunkWeights._fields),
        out.data_ptr(), bsz, h, wd, c, nl, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "fused_trunk")
    fused_trunk.launches += 1
    return out


fused_trunk.launches = 0


# ---------------------------------------------------------------------------
# Full-network forward (stem + fused trunk + heads)
# ---------------------------------------------------------------------------


class FusedWeights(NamedTuple):
    """Everything `fused_apply` needs: the network (stem and heads) and its
    trunk packed for the kernel."""

    net: AGNetwork
    trunk: TrunkWeights


def pack_weights(net: AGNetwork) -> FusedWeights:
    if net.cfg.trunk != "convnext":
        raise NotImplementedError(f"fused forward needs the convnext trunk, got {net.cfg.trunk}")
    return FusedWeights(net.eval(), pack_trunk_weights(net))


@torch.no_grad()
def fused_apply(weights: FusedWeights, planes: torch.Tensor, trunk=fused_trunk) -> NetOutput:
    """NHWC planes [B, H, W, C_in] -> NetOutput through stem, `trunk` (the
    kernel by default; `fused_trunk_plain` for the plain forward) and the
    heads."""
    x = weights.net.stem_forward(planes)  # NCHW bf16
    x = trunk(x.permute(0, 2, 3, 1).contiguous(), weights.trunk)
    return weights.net.heads_forward(x.permute(0, 3, 1, 2))
