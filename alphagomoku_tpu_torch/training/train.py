"""Training step: losses, optimizer, schedules, SWA.

Port of the reference package's `training/train.py` (reference:
src/selfplay/SupervisedLearning.cpp:94-154 losses, src/networks/
networks.cpp graph.setOptimizer(ml::RAdam(...)) optimizer,
src/selfplay/NetworkLoader.cpp:41-53 SWA averaging,
include/alphagomoku/utils/Parameter.hpp schedules).

Loss structure (reference: SupervisedLearning losses + NetworkDataPack
targets, src/networks/NetworkDataPack.cpp:131-162):
- policy: CE(visit distribution, policy logits)
- value: CE(3-way win/draw/loss target, value logits)
- action values: per-cell 3-way CE masked to visited root edges
- moves left: CE over H*W buckets, weight 0.25 (reference:
  networks.cpp:1215 addOutput(..., 0.25f))
- soft policy (T=4): CE(policy target softened at T=4), weight 8.0
  (reference: networks.cpp:1300 addOutput(..., 8.0f))

The train state is the network module itself (float32 parameters and
BatchNorm statistics), the optimizer's moments and the step count; a step
updates them in place.  The optimizer is `RAdam`, the port's own code for
the reference package's `optax.chain(add_decayed_weights(l2),
radam(lr))`.  Random symmetries enter as a tensor of modes (`draw_modes`
draws them from a `torch.Generator`), so a caller can inject any.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..game import vectorized as V
from ..models.networks import AGNetwork, NetOutput
from ..patterns import features as F
from ..utils import augment


class TrainConfig(NamedTuple):
    learning_rate: float = 1e-3
    l2_regularization: float = 1e-4  # (reference: TrainingConfig)
    moves_left_weight: float = 0.25
    soft_policy_weight: float = 8.0
    soft_policy_temperature: float = 4.0
    q_weight: float = 1.0
    augment_symmetries: bool = True


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------


class RAdamState(NamedTuple):
    count: int  # updates taken
    mu: list[torch.Tensor]  # first moments, one per parameter
    nu: list[torch.Tensor]  # second moments


def _f32_pow(base: float, count: int) -> np.float32:
    """base ** count in float32 as XLA's CPU `pow` gives it for the
    counts where RAdam's rectifier is sensitive (below 873 at base 0.999):
    the float64 power of the float32 base, rounded to float32."""
    return np.float32(np.float64(np.float32(base)) ** count)


class RAdam:
    """Rectified Adam with L2 added to the gradient first: the update of
    `optax.chain(optax.add_decayed_weights(weight_decay),
    optax.radam(learning_rate))`, not `torch.optim.RAdam`'s, which differs
    in three places: optax rectifies when the variance length ro >= 5
    (torch: > 5), adds eps to sqrt(nu_hat) (torch: to sqrt(nu)), and
    computes ro, the rectifier and the bias corrections in float32, where
    ro's cancellation moves the rectifier by about 1% at step 6.  Those
    scalars are computed here on the host in float32 as optax computes them
    on the device; the tensors update with `torch._foreach_*`.
    `learning_rate` is a float or a schedule `count -> float` (optax's
    `scale_by_schedule`: the first update reads count 0)."""

    def __init__(self, learning_rate: float | Callable[[int], float], weight_decay: float = 0.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, threshold: float = 5.0):
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.b1, self.b2, self.eps, self.threshold = b1, b2, eps, threshold

    def init(self, params: list[torch.Tensor]) -> RAdamState:
        return RAdamState(0, [torch.zeros_like(p) for p in params],
                          [torch.zeros_like(p) for p in params])

    def _scalars(self, count: int) -> tuple[float, float, float | None]:
        """(1 - b1^t, 1 - b2^t, rectifier r or None below the threshold)
        at update t = count, in float32."""
        f32 = np.float32
        c1 = f32(1) - _f32_pow(self.b1, count)
        b2t = _f32_pow(self.b2, count)
        c2 = f32(1) - b2t
        ro_inf_py = 2.0 / (1.0 - self.b2) - 1.0
        ro_inf = f32(ro_inf_py)
        ro = ro_inf - f32(2 * count) * b2t / c2
        if not ro >= self.threshold:
            return float(c1), float(c2), None
        r = np.sqrt((ro - f32(4.0)) * (ro - f32(2.0)) * ro_inf
                    / (f32((ro_inf_py - 4.0) * (ro_inf_py - 2.0)) * ro))
        return float(c1), float(c2), float(f32(r))

    @torch.no_grad()
    def step(self, params: list[torch.Tensor], grads: list[torch.Tensor],
             state: RAdamState) -> RAdamState:
        """One update of `params` in place from `grads`; returns the new
        state (its moment tensors are updated in place too)."""
        count = state.count + 1
        lr = self.learning_rate(state.count) if callable(self.learning_rate) else self.learning_rate
        g = torch._foreach_mul(params, self.weight_decay)
        torch._foreach_add_(g, grads)
        mu, nu = state.mu, state.nu
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - self.b1))
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - self.b2))
        c1, c2, r = self._scalars(count)
        upd = torch._foreach_div(mu, c1)
        if r is not None:
            den = torch._foreach_sqrt(torch._foreach_div(nu, c2))
            torch._foreach_add_(den, self.eps)
            torch._foreach_mul_(upd, r)
            torch._foreach_div_(upd, den)
        torch._foreach_mul_(upd, float(np.float32(-lr)))
        torch._foreach_add_(params, upd)
        return RAdamState(count, mu, nu)


# ---------------------------------------------------------------------------
# Train state
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrainState:
    """The network (float32 parameters, BatchNorm statistics as buffers),
    the optimizer's state and the step count."""

    net: AGNetwork
    opt_state: RAdamState
    step: int = 0

    @property
    def params(self) -> dict[str, torch.Tensor]:
        return dict(self.net.named_parameters())

    @property
    def batch_stats(self) -> dict[str, torch.Tensor]:
        return dict(self.net.named_buffers())


def create_train_state(
    net: AGNetwork, cfg: TrainConfig, lr_schedule: Callable[[int], float] | None = None
) -> tuple[TrainState, RAdam]:
    """RAdam with L2 added to the gradient (the reference uses
    ml::RAdam(lr, 0.9, 0.999, l2), networks.cpp:1218).  `net` is put in
    train mode and trained in place."""
    tx = RAdam(lr_schedule if lr_schedule is not None else cfg.learning_rate,
               cfg.l2_regularization)
    net.train()
    return TrainState(net, tx.init(list(net.parameters()))), tx


def draw_modes(generator: torch.Generator, batch: int, rows: int, cols: int) -> torch.Tensor:
    """One random symmetry per sample, [batch] int64 on the generator's
    device (0-7 on square boards, 0-3 otherwise)."""
    return torch.randint(0, augment.num_symmetries(rows, cols), (batch,), generator=generator,
                         device=generator.device)


# ---------------------------------------------------------------------------
# Losses and steps
# ---------------------------------------------------------------------------

_NEG = -1e9  # masked logit: a target of 0 on an illegal cell contributes 0


class DataParallel(NamedTuple):
    """A data-parallel step's view of its process group, set in `_DP` by
    `parallel.distributed.make_dp_train_step` for the length of one step:
    each rank holds a slice of the global batch, and the step computes
    what one process computes on the whole of it."""

    all_reduce: Callable[[torch.Tensor], torch.Tensor]  # sum over the group
    share: float  # this rank's samples over the global batch's


_DP: DataParallel | None = None


def _global_sum(x: torch.Tensor) -> torch.Tensor:
    """A local sum (a loss denominator) as the global batch's."""
    return x if _DP is None else _DP.all_reduce(x)


def _batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the batch of per-sample values: this rank's part of
    the global batch's mean under data parallelism."""
    return x.mean() if _DP is None else x.mean() * _DP.share


def _losses(out: NetOutput, batch: dict, cfg: TrainConfig, legal: torch.Tensor):
    """Per-head scalar losses over valid samples: (total, parts).  Under
    data parallelism the denominators are the global batch's, so the
    ranks' losses sum to the global batch's loss."""
    valid = batch["valid"].float()
    denom = _global_sum(valid.sum()).clamp(min=1.0)
    bsz = valid.shape[0]
    hw = out.policy_logits.shape[1] * out.policy_logits.shape[2]

    plog = torch.where(legal, out.policy_logits, _NEG).reshape(bsz, hw)
    logp = torch.log_softmax(plog, -1)
    ptarget = batch["policy"].reshape(bsz, hw)
    policy_loss = (-(ptarget * logp).sum(-1) * valid).sum() / denom

    vlogp = torch.log_softmax(out.value_logits, -1)
    value_loss = (-(batch["value_wdl"] * vlogp).sum(-1) * valid).sum() / denom

    total = policy_loss + value_loss
    parts = {"policy": policy_loss, "value": value_loss}

    if out.q_logits is not None:
        qt = batch["q_value"]  # [B, H, W, 2] (win, draw)
        q_wdl = torch.stack([qt[..., 0], qt[..., 1], 1.0 - qt[..., 0] - qt[..., 1]], -1)
        qlogp = torch.log_softmax(out.q_logits, -1)
        qm = batch["q_mask"].float() * valid[:, None, None]
        q_loss = -((q_wdl * qlogp).sum(-1) * qm).sum() / _global_sum(qm.sum()).clamp(min=1.0)
        total = total + cfg.q_weight * q_loss
        parts["q"] = q_loss

    if out.moves_left_logits is not None:
        mlogp = torch.log_softmax(out.moves_left_logits, -1)
        m_loss = -mlogp.gather(1, batch["moves_left"].long()[:, None])[:, 0]
        m_loss = (m_loss * valid).sum() / denom
        total = total + cfg.moves_left_weight * m_loss
        parts["moves_left"] = m_loss

    if out.soft_policy_logits is not None:
        # T=4 softened target (reference: NetworkDataPack.cpp:149-161)
        soft = ptarget ** (1.0 / cfg.soft_policy_temperature)
        soft = soft / soft.sum(-1, keepdim=True).clamp(min=1e-12)
        slog = torch.where(legal, out.soft_policy_logits, _NEG).reshape(bsz, hw)
        s_loss = (-(soft * torch.log_softmax(slog, -1)).sum(-1) * valid).sum() / denom
        total = total + cfg.soft_policy_weight * s_loss
        parts["soft_policy"] = s_loss

    parts["total"] = total
    return total, parts


def _encode(tables: V.RuleTables, batch: dict) -> torch.Tensor:
    return F.encode(tables, batch["board"], batch["stm"])


def _planes(packed: torch.Tensor, raw: bool) -> torch.Tensor:
    return F.unpack_raw_planes(packed) if raw else F.unpack_planes(packed)


def _legal(packed: torch.Tensor) -> torch.Tensor:
    return ((packed & 1) == 1) & ~(((packed >> 6) & 1) == 1)


def _apply_update(state: TrainState, tx: RAdam, total: torch.Tensor) -> None:
    """Backward into each parameter's `.grad` (left there for the caller),
    then the optimizer step in place.  Under data parallelism the ranks'
    gradients are summed first (each rank's loss is its part of the global
    batch's), in one all-reduce."""
    params = list(state.net.parameters())
    for p in params:
        p.grad = None
    total.backward()
    for p in params:
        if p.grad is None:  # a head the loss does not read: zero, as in JAX
            p.grad = torch.zeros_like(p)
    if _DP is not None:
        flat = _DP.all_reduce(torch.cat([p.grad.reshape(-1) for p in params]))
        for p, g in zip(params, flat.split([p.numel() for p in params])):
            p.grad = g.view_as(p)
    state.opt_state = tx.step(params, [p.grad for p in params], state.opt_state)
    state.step += 1


def make_train_step(net: AGNetwork, tx: RAdam, tables: V.RuleTables, cfg: TrainConfig):
    """The train step `(state, batch, modes) -> (state, parts)` over a batch
    of samples from `selfplay.make_targets` (tensors on the network's
    device).  Features are re-encoded on the device from the raw boards,
    then each sample takes its symmetry `modes[i]` (packed features, policy,
    Q and its mask; reference: SupervisedLearning.cpp:37-46); forward with
    batch statistics, backward and the optimizer step update `state` in
    place.  `parts` holds the detached per-head losses."""
    raw = net.cfg.raw_input

    def train_step(state: TrainState, batch: dict, modes: torch.Tensor | None = None):
        packed = _encode(tables, batch)
        policy_t, q_value, q_mask = batch["policy"], batch["q_value"], batch["q_mask"]
        if cfg.augment_symmetries:
            packed = F.augment_features_batch(packed, modes)
            policy_t = augment.apply_symmetry_batch(policy_t, modes)
            q_value = augment.apply_symmetry_batch(
                q_value.permute(0, 3, 1, 2), modes).permute(0, 2, 3, 1)
            q_mask = augment.apply_symmetry_batch(q_mask, modes)
        aug_batch = dict(batch, policy=policy_t, q_value=q_value, q_mask=q_mask)
        out = state.net.forward_train(_planes(packed, raw))
        total, parts = _losses(out, aug_batch, cfg, _legal(packed))
        _apply_update(state, tx, total)
        return state, {k: v.detach() for k, v in parts.items()}

    return train_step


@torch.no_grad()
def _top_k_hits(plog: torch.Tensor, target_best: torch.Tensor, k: int) -> torch.Tensor:
    """Whether `target_best` is among the k largest logits, ties broken by
    the lower index first, as `lax.top_k` breaks them."""
    topk = torch.sort(plog, dim=-1, descending=True, stable=True).indices[:, :k]
    return (topk == target_best[:, None]).any(-1).float()


def make_eval_step(net: AGNetwork, tables: V.RuleTables, cfg: TrainConfig):
    """Validation pass `(state, batch) -> parts`: the losses and top-1/3/5
    policy accuracy on the running statistics, no gradients (reference:
    SupervisedLearning validation + accuracy history,
    SupervisedLearning.cpp:231-304)."""
    raw = net.cfg.raw_input

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict) -> dict:
        packed = _encode(tables, batch)
        legal = _legal(packed)
        out = state.net(_planes(packed, raw))
        _, parts = _losses(out, batch, cfg, legal)
        bsz = legal.shape[0]
        plog = torch.where(legal, out.policy_logits, _NEG).reshape(bsz, -1)
        target_best = batch["policy"].reshape(bsz, -1).argmax(-1)
        valid = batch["valid"].float()
        denom = valid.sum().clamp(min=1.0)
        for k in (1, 3, 5):
            parts[f"top{k}_accuracy"] = (_top_k_hits(plog, target_best, k) * valid).sum() / denom
        return parts

    return eval_step


def make_distill_step(student: AGNetwork, teacher: AGNetwork, tx: RAdam,
                      tables: V.RuleTables, cfg: TrainConfig):
    """Teacher -> student distillation step `(state, teacher_net, batch,
    modes) -> (state, parts)`: the student is trained toward the teacher's
    output distributions on the sampled positions (reference:
    SupervisedLearning distillation variant, SupervisedLearning.cpp:155-230).
    `teacher_net` is a network of `teacher`'s architecture holding the
    teacher's weights (inference forward)."""
    raw_s, raw_t = student.cfg.raw_input, teacher.cfg.raw_input

    def distill_step(state: TrainState, teacher_net: AGNetwork, batch: dict,
                     modes: torch.Tensor | None = None):
        packed = _encode(tables, batch)
        if cfg.augment_symmetries:
            packed = F.augment_features_batch(packed, modes)
        legal = _legal(packed)
        bsz = legal.shape[0]
        t_out = teacher_net(_planes(packed, raw_t))
        t_policy = torch.softmax(torch.where(legal, t_out.policy_logits, _NEG).reshape(bsz, -1),
                                 -1)
        t_value = torch.softmax(t_out.value_logits, -1)

        out = state.net.forward_train(_planes(packed, raw_s))
        s_logp = torch.log_softmax(
            torch.where(legal, out.policy_logits, _NEG).reshape(bsz, -1), -1)
        policy_loss = -_batch_mean((t_policy * s_logp).sum(-1))
        value_loss = -_batch_mean((t_value * torch.log_softmax(out.value_logits, -1)).sum(-1))
        total = policy_loss + value_loss
        if out.q_logits is not None and t_out.q_logits is not None:
            t_q = torch.softmax(t_out.q_logits, -1)
            q_logp = torch.log_softmax(out.q_logits, -1)
            total = total + cfg.q_weight * (-_batch_mean((t_q * q_logp).sum(-1)))
        parts = {"policy": policy_loss, "value": value_loss, "total": total}
        _apply_update(state, tx, total)
        return state, {k: v.detach() for k, v in parts.items()}

    return distill_step


# ---------------------------------------------------------------------------
# Parameter schedules (reference: utils/Parameter.hpp epoch-keyed values with
# none/linear/cosine interpolation)
# ---------------------------------------------------------------------------


def schedule(points: list[tuple[int, float]], interpolation: str = "linear"):
    """Epoch-keyed schedule -> f(step), computed in float32 as the
    reference package's `jnp` version computes it."""
    xs = np.asarray([p[0] for p in points], np.float32)
    ys = np.asarray([p[1] for p in points], np.float32)
    f32 = np.float32
    last = len(xs) - 1

    def interp(step):
        # jnp.interp's formula, in float32
        i = int(np.clip(np.searchsorted(xs, step, side="right"), 1, last))
        dx = xs[i] - xs[i - 1]
        if abs(dx) <= np.spacing(np.finfo(np.float32).eps):
            val = ys[i - 1]
        else:
            val = ys[i - 1] + ((step - xs[i - 1]) / dx) * (ys[i] - ys[i - 1])
        if step < xs[0]:
            return ys[0]
        return ys[-1] if step > xs[-1] else f32(val)

    def f(step):
        step = f32(step)
        idx = np.searchsorted(xs, step, side="right") - 1
        if interpolation == "none":
            return ys[int(np.clip(idx, 0, last))]
        if interpolation == "cosine":
            # cosine easing between the same keypoints
            i = int(np.clip(idx, 0, last - 1))
            x0, x1, y0, y1 = xs[i], xs[i + 1], ys[i], ys[i + 1]
            t = np.clip((step - x0) / max(x1 - x0, f32(1e-9)), f32(0.0), f32(1.0))
            return f32(y0 + (y1 - y0) * (f32(1.0) - np.cos(f32(np.pi) * t)) / f32(2.0))
        return interp(step)

    return f


# ---------------------------------------------------------------------------
# SWA (reference: NetworkLoader::get averaging via ml::averageModelWeights)
# ---------------------------------------------------------------------------


def average_params(params_list: list[Any]) -> Any:
    """Uniform weight average of nested dicts of arrays or tensors
    (stochastic weight averaging over the last k checkpoints, reference:
    TrainingManager.cpp:270-272)."""
    first = params_list[0]
    if isinstance(first, dict):
        return {k: average_params([p[k] for p in params_list]) for k in first}
    return sum(params_list) / len(params_list)
