"""NNUE-style quantized fast evaluator over threat features.

Port of the reference package's `models/nnue.py`, the counterpart of the
reference's NNUE subsystem (reference: include/alphagomoku/networks/
NNUE.hpp:27-38, src/networks/NNUE.cpp:134-155 featurization, :205+
quantized dump): a tiny MLP over cheap threat-summary features, trained in
f32 and quantized after training to int8 weights with per-output-channel
scales, evaluated with integer products.  `make_simulate_fn(nnue=)`
blends its values into the leaf values (the reference ships NNUE off by
default, hooks at AlphaBetaSearch.hpp:57,62).

The whole feature vector is recomputed per position (the lockstep batch
has no incremental accumulator).  The int8 x int8 products accumulate
exactly: the sums reach 127 * 127 * 3,601 at 15x15, past float32's 2^24,
so they run in float64 (exact below 2^53) on any device and come back as
int32, the reference package's int32 accumulators.

Parameters travel in the reference package's flax layout
(`{"params": {"Dense_0": {"kernel": [in, out], "bias": [out]}, ...}}`,
numpy arrays): `NNUEModel.variables()` / `load_variables`, and the same
for `NNUEPolicyModel` with its `batch_stats`; the trainers use torch's
optimisers.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch
from torch import nn

from ..game.types import CROSS, CIRCLE, GameRules

# per-cell feature layout, exactly the reference's (NNUE.cpp:134-155):
# 16 features per cell: cross ThreatType one-hot OPEN_3..FIVE at [0..6],
# circle at [7..13], stone one-hot (cross, circle) at [14..15]; plus one
# leading side-to-move feature
CELL_FEATURES = 16


def num_features(rows: int, cols: int) -> int:
    return 1 + rows * cols * CELL_FEATURES


def _threat_one_hots(tables, board: torch.Tensor):
    """ThreatType one-hots OPEN_3..FIVE [B, H, W, 7] f32 of cross and of
    circle; only EMPTY cells carry threats, as the reference's
    ThreatHistogram spot lists (NNUE.cpp:141-150)."""
    from ..game import vectorized as V
    from ..patterns import bitwise
    from ..patterns import tables as T

    wins = V.windows_all(board).permute(0, 2, 3, 1)  # [B, H, W, 4]
    pts_cross, pts_circle = bitwise.classify(wins, GameRules(tables.rules))
    tt_cross = V.threat_type(tables, pts_cross, False)
    tt_circle = V.threat_type(tables, pts_circle, True)
    empty = board == 0

    def one_hot(tt):
        idx = tt.long() - T.TT_OPEN_3
        oh = torch.nn.functional.one_hot(idx.clamp(0, 6), 7).float()
        valid = (idx >= 0) & (idx <= 6) & empty
        return oh * valid[..., None].float()

    return one_hot(tt_cross), one_hot(tt_circle)


def nnue_features(tables, board, stm) -> torch.Tensor:
    """[B, H, W] board + [B] side to move -> [B, 1 + H*W*16] f32, the
    reference featurization (NNUE.cpp:134-155: feature[0] = cross to move,
    then per cell one-hots of each player's ThreatType in OPEN_3..FIVE and
    the stone), by the batched bitwise classifier."""
    board = torch.as_tensor(board)
    stm = torch.as_tensor(stm, device=board.device)
    bsz, h, w = board.shape
    oh_cross, oh_circle = _threat_one_hots(tables, board)
    cell = torch.cat([oh_cross, oh_circle, (board == CROSS)[..., None].float(),
                      (board == CIRCLE)[..., None].float()], dim=-1)  # [B, H, W, 16]
    lead = (stm == CROSS).float()[:, None]
    return torch.cat([lead, cell.reshape(bsz, h * w * CELL_FEATURES)], 1)


def _flax_dense_(linear: nn.Linear, generator: torch.Generator) -> None:
    """flax's Dense initialiser: lecun_normal kernel (a normal of variance
    1 / fan_in truncated at two standard deviations) and a zero bias."""
    std = math.sqrt(1.0 / linear.in_features) / 0.87962566103423978
    with torch.no_grad():
        w = torch.empty(linear.in_features, linear.out_features)
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
        linear.weight.copy_(w.T)
        linear.bias.zero_()


class NNUEModel(nn.Module):
    """The f32 training model (reference: TrainingNNUE's f32 MLP): two
    hidden ReLU layers and (win, draw, loss) logits."""

    def __init__(self, in_features: int, hidden: int = 32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.layers = nn.ModuleList([nn.Linear(in_features, hidden), nn.Linear(hidden, hidden),
                                     nn.Linear(hidden, 3)])
        if generator is not None:
            for layer in self.layers:
                _flax_dense_(layer, generator)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.layers[0](feats))
        x = torch.relu(self.layers[1](x))
        return self.layers[2](x)

    def variables(self) -> dict:
        """The parameters in the reference package's flax layout."""
        return {"params": {f"Dense_{i}": {
            "kernel": layer.weight.detach().T.cpu().numpy().copy(),
            "bias": layer.bias.detach().cpu().numpy().copy()}
            for i, layer in enumerate(self.layers)}}

    @classmethod
    def from_variables(cls, variables: dict) -> "NNUEModel":
        dense = variables["params"]
        k0 = np.asarray(dense["Dense_0"]["kernel"])
        model = cls(k0.shape[0], k0.shape[1])
        with torch.no_grad():
            for i, layer in enumerate(model.layers):
                layer.weight.copy_(torch.from_numpy(
                    np.array(dense[f"Dense_{i}"]["kernel"], np.float32).T.copy()))
                layer.bias.copy_(torch.from_numpy(np.array(dense[f"Dense_{i}"]["bias"],
                                                           np.float32)))
        return model


class QuantizedNNUE(NamedTuple):
    """int8 weights + per-output-channel scales + an f32 tail (reference:
    NNUEWeights int8 layer_0 / int16 layer_1 / fp32 tail); numpy arrays,
    or tensors on a device after `to(device)`."""

    w0: Any  # int8 [F, H]
    s0: Any  # f32 [H]
    b0: Any  # f32 [H]
    w1: Any  # int8 [H, H]
    s1: Any  # f32 [H]
    b1: Any  # f32 [H]
    w2: Any  # f32 [H, 3] (the tail stays f32, as in the reference)
    b2: Any  # f32 [3]

    def to(self, device) -> "QuantizedNNUE":
        return QuantizedNNUE(*(torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                                               device=device) for a in self))


def quantize(params: Any) -> QuantizedNNUE:
    """Per-output-channel symmetric int8 quantization of the two hidden
    layers (reference: per-neuron scales in TrainingNNUE::dump).  `params`
    is an `NNUEModel` or its variables in the flax layout."""
    if isinstance(params, NNUEModel):
        params = params.variables()
    d0, d1, d2 = (params["params"][f"Dense_{i}"] for i in range(3))

    def q(kernel):
        k = np.asarray(kernel, np.float32)
        scale = np.maximum(np.abs(k).max(0), 1e-8) / 127.0
        return np.round(k / scale).astype(np.int8), scale.astype(np.float32)

    w0, s0 = q(d0["kernel"])
    w1, s1 = q(d1["kernel"])
    return QuantizedNNUE(
        w0=w0, s0=s0, b0=np.asarray(d0["bias"], np.float32),
        w1=w1, s1=s1, b1=np.asarray(d1["bias"], np.float32),
        w2=np.asarray(d2["kernel"], np.float32), b2=np.asarray(d2["bias"], np.float32),
    )


def _int8_dense(x: torch.Tensor, w_int8: torch.Tensor, w_scale: torch.Tensor,
                bias: torch.Tensor):
    """One quantized layer: the activations quantized to int8 per row, the
    exact int32 accumulator of the int8 products, and the scaled f32
    output.  Returns (output, accumulator)."""
    a_scale = x.abs().amax(-1, keepdim=True).clamp(min=1e-8) / 127.0
    x_q = torch.round(x / a_scale).to(torch.int8)
    acc = (x_q.double() @ w_int8.double()).to(torch.int32)
    return acc.float() * a_scale * w_scale[None, :] + bias[None, :], acc


def quantized_accumulators(q: QuantizedNNUE, feats: torch.Tensor):
    """The two int32 accumulators [B, H] of `quantized_apply` and its
    logits [B, 3]."""
    q = q.to(feats.device)
    x, acc0 = _int8_dense(feats, q.w0, q.s0, q.b0)
    x, acc1 = _int8_dense(torch.relu(x), q.w1, q.s1, q.b1)
    return acc0, acc1, torch.relu(x) @ q.w2 + q.b2


def quantized_apply(q: QuantizedNNUE, feats: torch.Tensor) -> torch.Tensor:
    """Integer-weight forward pass -> (win, draw, loss) logits [B, 3]
    (reference: avx2_forward's int8/int16 pipeline, nnue_ops)."""
    return quantized_accumulators(q, feats)[2]


def evaluate_features(q: QuantizedNNUE, feats: torch.Tensor) -> torch.Tensor:
    """Feature rows [B, F] (`nnue_features`) -> (win, draw) pairs [B, 2]."""
    wdl = torch.softmax(quantized_apply(q, feats), -1)
    return torch.stack([wdl[..., 0], wdl[..., 1]], -1)


def train_nnue(feats: torch.Tensor, wdl_targets: torch.Tensor, steps: int = 500,
               hidden: int = 32, lr: float = 1e-2, seed: int = 0):
    """Fit the f32 model to (win, draw, loss) targets with Adam (reference:
    TrainingNNUE on GPU, then dump); returns (variables in the flax layout,
    the last step's loss)."""
    feats = torch.as_tensor(feats, dtype=torch.float32)
    wdl_targets = torch.as_tensor(wdl_targets, dtype=torch.float32, device=feats.device)
    model = NNUEModel(feats.shape[1], hidden, torch.Generator().manual_seed(seed)).to(feats.device)
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    loss = None
    with torch.enable_grad():
        for _ in range(steps):
            opt.zero_grad()
            loss = -(wdl_targets * torch.log_softmax(model(feats), -1)).sum(-1).mean()
            loss.backward()
            opt.step()
    return model.variables(), float(loss.detach())


def train_from_replay(tables, boards, stm, value_wdl, steps: int = 500, hidden: int = 32,
                      lr: float = 1e-2, seed: int = 0) -> tuple[QuantizedNNUE, float]:
    """Fit and quantize an NNUE on replay positions (reference: TrainingNNUE
    trained on game positions, then dumped to quantized weights,
    NNUE.cpp:100-230).  Returns (quantized net, final loss)."""
    feats = nnue_features(tables, boards, stm)
    variables, loss = train_nnue(feats, value_wdl, steps, hidden, lr, seed)
    return quantize(variables), loss


# ---------------------------------------------------------------------------
# Policy NNUE (reference: TrainingNNUE_policy, NNUE.cpp:290-379: a tiny
# conv net over per-cell threat planes giving a move distribution, the
# policy counterpart for solver move ordering)
# ---------------------------------------------------------------------------


def nnue_policy_planes(tables, board, stm) -> torch.Tensor:
    """[B, H, W] board + [B] side to move -> [B, H, W, 16] f32 planes in
    the reference's side-to-move-relative layout (NNUE.cpp:337-361
    packInputData): opponent ThreatType one-hot OPEN_3..FIVE at [0..6],
    own at [7..13], opponent stone at [14], own stone at [15]."""
    board = torch.as_tensor(board)
    stm = torch.as_tensor(stm, device=board.device)
    oh_cross, oh_circle = _threat_one_hots(tables, board)
    stm_is_cross = (stm == CROSS)[:, None, None]
    own = torch.where(stm_is_cross[..., None], oh_cross, oh_circle)
    opp = torch.where(stm_is_cross[..., None], oh_circle, oh_cross)
    own_stone = torch.where(stm_is_cross, board == CROSS, board == CIRCLE)
    opp_stone = torch.where(stm_is_cross, board == CIRCLE, board == CROSS)
    return torch.cat([opp, own, opp_stone[..., None].float(), own_stone[..., None].float()], -1)


class _FlaxBatchNorm(nn.Module):
    """flax's `BatchNorm(use_scale=False)` over NCHW: a bias and no scale,
    epsilon 1e-5, running averages with momentum 0.99 of the batch mean
    and biased variance."""

    def __init__(self, width: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(width))
        self.register_buffer("mean", torch.zeros(width))
        self.register_buffer("var", torch.ones(width))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if train:
            mean = x.mean((0, 2, 3))
            var = (x * x).mean((0, 2, 3)) - mean * mean
            with torch.no_grad():
                self.mean.mul_(0.99).add_(0.01 * mean.detach())
                self.var.mul_(0.99).add_(0.01 * var.detach())
        else:
            mean, var = self.mean, self.var
        y = (x - mean[:, None, None]) * torch.rsqrt(var + 1e-5)[:, None, None]
        return y + self.bias[:, None, None]


class NNUEPolicyModel(nn.Module):
    """The f32 policy model (reference graph, NNUE.cpp:310-326: a 5x5 conv
    without bias + BN + ReLU, 1x1 convs without bias + BN + ReLU, a final
    1x1 conv to one logit per cell; the softmax lives in the loss).
    Takes NHWC planes [B, H, W, 16]; returns [B, H, W] logits."""

    def __init__(self, arch: tuple = (32, 32, 1), in_planes: int = CELL_FEATURES,
                 generator: torch.Generator | None = None):
        super().__init__()
        widths = (in_planes,) + tuple(arch[:-1])
        self.convs = nn.ModuleList(
            [nn.Conv2d(widths[0], widths[1], 5, padding=2, bias=False)]
            + [nn.Conv2d(widths[i], widths[i + 1], 1, bias=False)
               for i in range(1, len(widths) - 1)])
        self.norms = nn.ModuleList([_FlaxBatchNorm(wd) for wd in widths[1:]])
        self.head = nn.Conv2d(widths[-1], 1, 1)
        if generator is not None:
            with torch.no_grad():
                for conv in [*self.convs, self.head]:
                    fan_in = conv.in_channels * conv.kernel_size[0] * conv.kernel_size[1]
                    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                    nn.init.trunc_normal_(conv.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                          generator=generator)
                self.head.bias.zero_()

    def forward(self, planes: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = planes.permute(0, 3, 1, 2)
        for conv, norm in zip(self.convs, self.norms):
            x = torch.relu(norm(conv(x), train))
        return self.head(x)[:, 0]

    def variables(self) -> dict:
        """The parameters and batch statistics in the flax layout."""
        np_ = lambda t: t.detach().cpu().numpy().copy()
        params, stats = {}, {}
        for i, (conv, norm) in enumerate(zip(self.convs, self.norms)):
            params[f"Conv_{i}"] = {"kernel": np_(conv.weight.permute(2, 3, 1, 0))}
            params[f"BatchNorm_{i}"] = {"bias": np_(norm.bias)}
            stats[f"BatchNorm_{i}"] = {"mean": np_(norm.mean), "var": np_(norm.var)}
        params[f"Conv_{len(self.convs)}"] = {"kernel": np_(self.head.weight.permute(2, 3, 1, 0)),
                                             "bias": np_(self.head.bias)}
        return {"params": params, "batch_stats": stats}

    @classmethod
    def from_variables(cls, variables: dict, arch: tuple = (32, 32, 1)) -> "NNUEPolicyModel":
        params, stats = variables["params"], variables.get("batch_stats", {})
        in_planes = np.asarray(params["Conv_0"]["kernel"]).shape[2]
        model = cls(arch, in_planes)
        t = lambda a: torch.from_numpy(np.asarray(a, np.float32).copy())
        with torch.no_grad():
            for i, (conv, norm) in enumerate(zip(model.convs, model.norms)):
                conv.weight.copy_(t(params[f"Conv_{i}"]["kernel"]).permute(3, 2, 0, 1))
                norm.bias.copy_(t(params[f"BatchNorm_{i}"]["bias"]))
                norm.mean.copy_(t(stats[f"BatchNorm_{i}"]["mean"]))
                norm.var.copy_(t(stats[f"BatchNorm_{i}"]["var"]))
            last = params[f"Conv_{len(model.convs)}"]
            model.head.weight.copy_(t(last["kernel"]).permute(3, 2, 0, 1))
            model.head.bias.copy_(t(last["bias"]))
        return model


def train_nnue_policy(tables, boards, stm, policy_targets, steps: int = 300,
                      arch: tuple = (32, 32, 1), lr: float = 1e-3, seed: int = 0):
    """Fit the policy NNUE to visit-distribution targets [B, H, W] with
    RAdam (reference: TrainingNNUE_policy with CrossEntropyLoss + RAdam,
    NNUE.cpp:326-335; the port's optax-equal `training.train.RAdam`).
    Returns (variables in the flax layout, the last step's loss)."""
    from ..training.train import RAdam

    planes = nnue_policy_planes(tables, boards, stm)
    model = NNUEPolicyModel(arch, planes.shape[-1],
                            torch.Generator().manual_seed(seed)).to(planes.device)
    params = list(model.parameters())
    tx = RAdam(lr)
    opt = tx.init(params)
    bsz = planes.shape[0]
    tgt = torch.as_tensor(policy_targets, dtype=torch.float32,
                          device=planes.device).reshape(bsz, -1)
    loss = None
    with torch.enable_grad():
        for _ in range(steps):
            logits = model(planes, train=True)
            loss = -(tgt * torch.log_softmax(logits.reshape(bsz, -1), -1)).sum(-1).mean()
            grads = torch.autograd.grad(loss, params)
            opt = tx.step(params, list(grads), opt)
    return model.variables(), float(loss.detach())
