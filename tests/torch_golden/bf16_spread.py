"""How far two bfloat16 implementations of one zoo network lie apart at full
width: flax's and the port's, on the CPU.

    JAX_PLATFORMS=cpu python tests/torch_golden/bf16_spread.py [family ...]

For each network of chip_smoke.py's phase 21 (`ZOO`: 6 blocks x 64
filters, FastPolicy at 2x32, on 15x15, the port's seeded weights carried
to flax by `to_flax`), on B = 32 random planes:

- forward (inference): `utils.bf16.agreement` of the port's bfloat16
  heads with flax's under `HEAD_LIMITS` (share differing, share over 2
  ulps of at least 1/16), and the relative L2 distance of each from the
  port's float32 forward, over all heads;
- gradient: of a fixed random linear functional of the policy and value
  logits, in train mode (BatchNorm on batch statistics), the relative L2
  distance over all tensors of each side's bfloat16 gradient from its own
  float32 one, and the worst tensor's (norms floored at 1e-3 of the
  largest).

These are the references of phase 21's checks of the card against a CPU
copy: a bfloat16 result there is held against the float32 one no farther
than the CPU's, as two correct implementations lie here.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

H = W = 15
B = 32


def _rel(ref: np.ndarray, x: np.ndarray, floor: float = 1e-30) -> float:
    return float(np.linalg.norm(ref - x) / max(np.linalg.norm(ref), floor))


def _grad_spread(exact: dict, got: dict) -> tuple[float, float, str]:
    keys = sorted(exact)
    floor = 1e-3 * max(np.linalg.norm(exact[k]) for k in keys)
    worst = max((_rel(exact[k], got[k], floor), k) for k in keys)
    flat = lambda t: np.concatenate([t[k].ravel() for k in keys])
    return _rel(flat(exact), flat(got)), *worst


def family(name: str) -> None:
    import jax
    import jax.numpy as jnp
    import torch

    import chip_smoke as C
    from alphagomoku_tpu.models.networks import AGNetwork as FlaxNet
    from alphagomoku_tpu.models.networks import ModelConfig as FlaxConfig
    from alphagomoku_tpu_torch.models import networks as TN
    from alphagomoku_tpu_torch.models.convert import to_flax
    from alphagomoku_tpu_torch.ops import convnext_fused as CF
    from alphagomoku_tpu_torch.utils.bf16 import agreement
    from tests.test_torch_network import _flatten

    spec = C.ZOO[name]
    if isinstance(spec, dict):
        port = TN.AGNetwork(TN.ModelConfig(**spec, blocks=6, filters=64), H, W)
    elif spec == "FastPolicy":
        port = TN.create_network(spec)
    else:
        port = TN.create_network(spec, blocks=6, filters=64)
    port = TN.init_random_(port, torch.Generator().manual_seed(C.ZOO_SEED)).eval()
    c = port.cfg
    state = {k: v.detach().float() for k, v in port.state_dict().items()}
    variables = jax.tree_util.tree_map(jnp.asarray, to_flax(state))
    x = (np.random.default_rng(3).random((B, H, W, c.input_planes)) < 0.3).astype(np.float32)
    r = np.random.default_rng(5).standard_normal((B, H, W)).astype(np.float32)

    def flax_net(dtype):
        return FlaxNet(FlaxConfig(trunk=c.trunk, heads=c.heads, raw_input=c.raw_input,
                                  blocks=c.blocks, filters=c.filters, dtype=dtype))

    def port_net(dtype):
        net = TN.AGNetwork(dataclasses.replace(c, dtype=dtype), H, W)
        net.load_state_dict(state)
        return net.eval()

    heads = lambda out: {f: np.asarray(getattr(out, f), np.float32) for f in out._fields
                         if getattr(out, f) is not None}
    with torch.no_grad():
        exact = heads(port_net(torch.float32)(torch.from_numpy(x)))
        ours = heads(port_net(torch.bfloat16)(torch.from_numpy(x)))
    theirs = heads(flax_net(jnp.bfloat16).apply(variables, jnp.asarray(x), train=False))
    flat = lambda t: np.concatenate([t[f].ravel() for f in sorted(exact)])
    shares = {f: agreement(torch.from_numpy(theirs[f]), torch.from_numpy(ours[f]),
                           **CF.HEAD_LIMITS) for f in exact}
    print(f"{name} forward: port vs flax share differing "
          f"{max(s['share_differ'] for s in shares.values()):.4f}, over 2 ulps "
          f"{max(s['share_over'] for s in shares.values()):.4f} (HEAD_LIMITS 0.25, 0.1); "
          f"from the port's float32: port {_rel(flat(exact), flat(ours)):.5f}, flax "
          f"{_rel(flat(exact), flat(theirs)):.5f}", flush=True)

    def flax_grad(dtype):
        net = flax_net(dtype)

        def loss(params):
            out, _ = net.apply({"params": params, "batch_stats": variables["batch_stats"]},
                               jnp.asarray(x), train=True, mutable=["batch_stats"])
            return ((out.policy_logits.astype(jnp.float32) * r).sum()
                    + out.value_logits[:, 0].astype(jnp.float32).sum())

        g = jax.jit(jax.grad(loss))(variables["params"])
        return {k: np.asarray(v, np.float64) for k, v in
                _flatten(jax.tree_util.tree_map(np.asarray, g)).items()}

    def port_grad(dtype):
        net = port_net(dtype)
        out = net.forward_train(torch.from_numpy(x))
        ((out.policy_logits.float() * torch.from_numpy(r)).sum()
         + out.value_logits[:, 0].float().sum()).backward()
        g = to_flax({k: torch.zeros_like(p) if p.grad is None else p.grad.float()
                     for k, p in net.named_parameters()})["params"]
        return {k: np.asarray(v, np.float64) for k, v in _flatten(g).items()}

    for side, grad in (("flax", flax_grad), ("port", port_grad)):
        f32 = grad(jnp.float32 if side == "flax" else torch.float32)
        bf16 = grad(jnp.bfloat16 if side == "flax" else torch.bfloat16)
        overall, worst, key = _grad_spread(f32, bf16)
        print(f"{name} gradient: {side}'s bfloat16 from its float32 {overall:.4f} over all "
              f"tensors, worst tensor {worst:.4f} ({key})", flush=True)


if __name__ == "__main__":
    import torch

    import chip_smoke as C

    torch.set_num_threads(4)
    for name in sys.argv[1:] or list(C.ZOO):
        family(name)
