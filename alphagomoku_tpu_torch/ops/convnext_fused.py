"""Fused ConvNext trunk: the whole block stack as one CUDA kernel, and the
network forward that runs it.

`fused_trunk` launches `csrc/convnext_trunk.cu` (the port of the Pallas
kernel `alphagomoku_tpu/ops/convnext_fused.py:_trunk_kernel`) for CUDA
tensors and runs `fused_trunk_plain` for CPU tensors.  Both keep the Pallas
body's numerics: bf16 storage, f32 accumulation in the depthwise taps and
the products, BatchNorm folded to a per-channel scale and shift (inference
only), and bf16 casts at the same points.

The kernel is built for the widths `KERNEL_WIDTHS` (64 and 128); like the
Pallas kernel, the wrapper takes any C up to 128 and any board up to 20x20.
`trunk_plan(C, H, W)` picks the launch by the shape alone:

- C below 128 runs at the next built width, `kernel_width(C)`, on channels
  padded with zeros (`pad_trunk`), which is exact: a zero channel stays
  zero through every block and adds +0 to every real channel's sums;
- one CTA holds a board (`convnext_trunk_kernel<C>`) where its shared
  memory fits the card (`SM90_SMEM_OPTIN`); C = 128 on boards above 252
  cells (16x16 to 20x20) takes a cluster of two CTAs a board instead
  (`convnext_trunk_cluster_kernel<128>`), each holding half of the rows.

C above 128 raises NotImplementedError (ROADMAP.md §2 item 3).

`fused_apply(weights, planes)` is the full ConvNextPVQMraw forward (stem,
fused trunk, heads) with its weights passed in explicitly as a
`FusedWeights` (built by `pack_weights` from a snapshot of the network).
On the card it is the network `search.mcts.run_search` evaluates.  The stem conv and the heads
stay plain PyTorch ops, as they stay XLA ops in the reference package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.blocks import BF16, fold_bn
from ..models.networks import AGNetwork, NetOutput, snapshot
from . import _build

__all__ = [
    "TrunkWeights", "fold_bn", "pack_trunk_weights", "fused_trunk",
    "fused_trunk_plain", "FusedWeights", "pack_weights", "fused_apply",
    "trunk_occupancy", "trunk_smem_bytes", "BLOCK_LIMITS", "TRUNK_LIMITS", "HEAD_LIMITS",
    "KERNEL_WIDTHS", "SM90_SMEM_OPTIN", "TrunkPlan", "trunk_plan", "kernel_width",
    "pad_trunk", "pad_trunk_weights",
]

KERNEL_WIDTHS = (64, 128)  # the filter counts csrc/convnext_trunk.cu is built for
# the largest dynamic shared memory a block may opt into on sm_90, the only
# architecture the kernel is built for (227 KiB)
SM90_SMEM_OPTIN = 232448

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
    network's device; on the card, padded with zeros to the width the
    kernel runs at (`kernel_width`, `pad_trunk_weights`)."""
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
    w = TrunkWeights(**{
        k: torch.stack(v).to(BF16 if k in bf else torch.float32).contiguous()
        for k, v in cols.items()
    })
    if w.dw.device.type == "cuda":
        w = pad_trunk_weights(w, kernel_width(w.dw.shape[-1]))
    return w


def kernel_width(c: int) -> int:
    """The width the trunk kernel runs a C-filter trunk at: the next built
    width (`KERNEL_WIDTHS`).  C above 128 raises NotImplementedError."""
    for width in KERNEL_WIDTHS:
        if c <= width:
            return width
    raise NotImplementedError(
        f"fused_trunk kernel takes up to {KERNEL_WIDTHS[-1]} filters, got {c}: w1 and w2 of a "
        "wider trunk do not fit one CTA's shared memory (ROADMAP.md §2 item 3: trunk widths "
        "above 128)"
    )


def pad_trunk_weights(w: TrunkWeights, width: int) -> TrunkWeights:
    """`w` with every channel dimension padded with zeros to `width`: the
    taps, the folded BN, both dims of the four matrices and the biases.
    A padded channel's BN scale and shift are 0, so it is 0 after the
    depthwise and the BN, after relu(0 + 0), after the residual add and
    after its SE gate (0.5 x 0), and its zero rows add +0 to every real
    channel's sums."""
    c = w.dw.shape[-1]
    if c == width:
        return w
    pad = width - c

    def one(t):
        if t.dim() == 4:  # taps [L, 7, 7, C]
            return torch.nn.functional.pad(t, (0, pad)).contiguous()
        if t.dim() == 3:  # [L, C, C] (in, out)
            return torch.nn.functional.pad(t, (0, pad, 0, pad)).contiguous()
        return torch.nn.functional.pad(t, (0, pad)).contiguous()  # [L, C]

    return TrunkWeights(*(one(t) for t in w))


def pad_trunk(x: torch.Tensor, w: TrunkWeights, width: int) -> tuple[torch.Tensor, TrunkWeights]:
    """The trunk's input [B, H, W, C] and weights padded with zero channels
    to `width` (either left as it is where it already has that width): the
    trunk of the padded pair, cut to the first C channels, is the trunk of
    the pair (`pad_trunk_weights` says why)."""
    if x.shape[-1] != width:
        x = torch.nn.functional.pad(x, (0, width - x.shape[-1])).contiguous()
    return x, pad_trunk_weights(w, width)


def _products(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ w [K, N] in f32, summed k ascending with one rounding per
    term (the products of two bf16 values are exact in f32): the order the
    kernel settles its doubtful sums in.  A library matmul may split the sum
    otherwise, and on the card it does at some shapes (one board's rows)."""
    acc = torch.zeros((a.shape[0], w.shape[1]), dtype=torch.float32, device=a.device)
    for k in range(a.shape[1]):
        acc = acc + a[:, k:k + 1] * w[k]
    return acc


def fused_trunk_plain(x: torch.Tensor, w: TrunkWeights) -> torch.Tensor:
    """Plain PyTorch version of the fused trunk: [B, H, W, C] bf16 -> same.
    Weights padded wider than C (`pack_trunk_weights` on the card) run on
    the input padded to their width, cut back to C."""
    if w.dw.shape[-1] != x.shape[-1]:
        c = x.shape[-1]
        return fused_trunk_plain(*pad_trunk(x, w, w.dw.shape[-1]))[..., :c].contiguous()
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
        y1 = torch.relu(_products(ym.float(), w.w1[l].float()) + w.b1[l]).to(BF16)
        y2 = (_products(y1.float(), w.w2[l].float()) + w.b2[l]).to(BF16)
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


class TrunkPlan(NamedTuple):
    """How the trunk kernel runs a shape (`trunk_plan`)."""

    entry: str  # the kernel launched
    width: int  # the channels it runs at (`kernel_width`)
    ctas: int  # CTAs a board
    smem_bytes: int  # dynamic shared memory of one CTA


def _one_cta_bytes(c: int, h: int, w: int) -> int:
    """`Trunk<C>::bytes`: two activation buffers and the two product weights
    in bf16 rows of C + 8, the depthwise taps, and the f32 vectors of the
    BN, biases and SE."""
    rs = c + 8
    return (2 * h * w * rs + 2 * c * rs + 49 * c) * 2 + (4 * c + 2 * 8 * c + 3 * c + 2 * c) * 4


def _cluster_cta_bytes(c: int, h: int, w: int) -> int:
    """`Trunk<C>::cluster_bytes`: a CTA of the two-CTA cluster holds its
    half of the rows (the larger half, ceil(H / 2)) and the 3 halo rows of
    the other half, the depthwise output of its rows, its own copy of the
    weights and vectors, and the f32 column sums it shares for the SE
    mean."""
    rs = c + 8
    top = (h + 1) // 2
    return ((2 * top + 3) * w * rs + 2 * c * rs + 49 * c) * 2 + (
        4 * c + 2 * 8 * c + 3 * c + 2 * c + c) * 4


def trunk_plan(c: int, h: int, w: int) -> TrunkPlan:
    """The launch of the trunk kernel for a C-filter trunk on h x w boards,
    by the shape alone: the width `kernel_width(c)`; one CTA a board where
    its shared memory fits `SM90_SMEM_OPTIN`, else (C = 128 above 252
    cells: every board up to 20x20 has one) a cluster of two CTAs a board.
    Raises NotImplementedError for C above 128 and for a board that fits
    neither."""
    width = kernel_width(c)
    one = _one_cta_bytes(width, h, w)
    if one <= SM90_SMEM_OPTIN:
        return TrunkPlan("convnext_trunk_kernel", width, 1, one)
    two = _cluster_cta_bytes(width, h, w)
    if width != 128 or h < 6 or two > SM90_SMEM_OPTIN:
        raise NotImplementedError(f"fused_trunk kernel: no entry for C={c} on {h}x{w} boards")
    return TrunkPlan("convnext_trunk_cluster_kernel", width, 2, two)


def fused_trunk(x: torch.Tensor, w: TrunkWeights) -> torch.Tensor:
    """Run the whole ConvNext block stack on a [B, H, W, C] bf16 activation:
    the CUDA kernel for CUDA tensors (`trunk_plan`: C below the kernel's
    width on zero channels, `pad_trunk`), `fused_trunk_plain` for CPU
    tensors."""
    if x.device.type == "cpu":
        return fused_trunk_plain(x, w)
    bsz, h, wd, c = x.shape
    plan = trunk_plan(c, h, wd)
    if x.device.type != "cuda":
        raise ValueError(f"fused_trunk: unsupported device {x.device}")
    nl = w.dw.shape[0]
    if w.dw.shape[1:3] != (7, 7):
        raise ValueError(f"fused_trunk: depthwise kernel {tuple(w.dw.shape[1:3])}, expected 7x7")
    if w.dw.shape[-1] not in (c, plan.width):
        raise ValueError(f"fused_trunk: weights of {w.dw.shape[-1]} channels for an input of {c}")
    cp = plan.width
    x, w = pad_trunk(x, w, cp)
    dev = x.device
    _check("x", x, BF16, (bsz, h, wd, cp), dev)
    for name in TrunkWeights._fields:
        t = getattr(w, name)
        if name == "dw":
            _check(name, t, BF16, (nl, 7, 7, cp), dev)
        elif t.dim() == 3:
            _check(name, t, BF16, (nl, cp, cp), dev)
        else:
            _check(name, t, torch.float32, (nl, cp), dev)
    out = torch.empty_like(x)
    lib = _build.library()
    launch = lib.ag_convnext_trunk if plan.ctas == 1 else lib.ag_convnext_trunk_cluster
    err = launch(
        x.data_ptr(), *(getattr(w, n).data_ptr() for n in TrunkWeights._fields),
        out.data_ptr(), bsz, h, wd, cp, nl, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "fused_trunk")
    fused_trunk.launches += 1
    if plan.ctas == 2:
        fused_trunk.cluster_launches += 1
    return out if cp == c else out[..., :c].contiguous()


fused_trunk.launches = 0  # every launch, of either entry
fused_trunk.cluster_launches = 0  # the cluster entry's


def trunk_smem_bytes(c: int, h: int, w: int) -> int:
    """Dynamic shared memory of one CTA of the trunk kernel's entry for a
    C-filter trunk on h x w boards (`trunk_plan`)."""
    return trunk_plan(c, h, w).smem_bytes


def trunk_occupancy(c: int, h: int = 15, w: int = 15) -> dict:
    """What the trunk kernel's entry for a C-filter trunk on h x w boards
    (`trunk_plan`) gets from the current card: CTAs per SM, registers per
    thread, shared memory per CTA (bytes), local memory per thread (bytes;
    spills) and, for the cluster entry, the clusters the card holds at
    once (0 for the one-CTA entry)."""
    import ctypes

    plan = trunk_plan(c, h, w)
    info = (ctypes.c_int * 5)()
    _build.check(_build.library().ag_convnext_trunk_occupancy(
        plan.width, h, w, plan.ctas, info), "trunk_occupancy")
    return dict(zip(("ctas_per_sm", "registers", "smem_bytes", "local_bytes", "clusters"), info),
                entry=plan.entry, width=plan.width)


# ---------------------------------------------------------------------------
# Full-network forward (stem + fused trunk + heads)
# ---------------------------------------------------------------------------


class FusedWeights(NamedTuple):
    """Everything `fused_apply` needs: the network (stem and heads) and its
    trunk packed for the kernel."""

    net: AGNetwork
    trunk: TrunkWeights


@torch.no_grad()
def pack_weights(net: AGNetwork) -> FusedWeights:
    """`FusedWeights` of a snapshot of `net`: the stem and heads are a
    detached copy of its modules (no gradients) and the trunk is packed
    from the same values, so training `net` afterwards changes neither, and
    `net` keeps its train/eval mode.  Pack again after an optimizer step."""
    if net.cfg.trunk != "convnext":
        raise NotImplementedError(f"fused forward needs the convnext trunk, got {net.cfg.trunk}")
    snap = snapshot(net)
    return FusedWeights(snap, pack_trunk_weights(snap))


@torch.no_grad()
def fused_apply(weights: FusedWeights, planes: torch.Tensor, trunk=fused_trunk) -> NetOutput:
    """NHWC planes [B, H, W, C_in] -> NetOutput through stem, `trunk` (the
    kernel by default; `fused_trunk_plain` for the plain forward) and the
    heads."""
    x = weights.net.stem_forward(planes)  # NCHW bf16
    x = trunk(x.permute(0, 2, 3, 1).contiguous(), weights.trunk)
    return weights.net.heads_forward(x.permute(0, 3, 1, 2))
