"""Rate a checkpoint against the frozen AnchorV1 opponent (absolute
cross-round Elo scale; eval/anchor.py), with the port on one GPU.

    python3 -m alphagomoku_tpu_torch.tools.rate_vs_anchor --checkpoint runs/.../network_N.msgpack
        [--arch ConvNextPVQMraw] [--blocks 6] [--filters 64] [--pairs 24] [--sims 200]
        [--size 15] [--rules FREESTYLE] [--max-moves 0] [--anchor v1|v2] [--cpu]

The flags and the printed JSON line are those of the reference package's
`tools/rate_vs_anchor.py`.  The checkpoint is a flax msgpack file (for
example `runs/flagship_r4/checkpoint/network_23.msgpack`), read by
`utils/checkpoint.py`; without one the candidate holds flax's default
initialization drawn from a generator seeded with 0.  Both sides search
under `ANCHOR_MCFG` at `--sims` simulations a move (the match's shared
count, AnchorV2 included), on the card unless `--cpu` is given.
`--max-moves 0` plays every game to its rule outcome.
"""

from __future__ import annotations

import argparse
import json
import time


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", required=False, default=None)
    ap.add_argument("--arch", default="ConvNextPVQMraw")
    ap.add_argument("--blocks", type=int, default=6)
    ap.add_argument("--filters", type=int, default=64)
    ap.add_argument("--pairs", type=int, default=24)
    ap.add_argument("--sims", type=int, default=200)
    ap.add_argument("--size", type=int, default=15)
    ap.add_argument("--rules", default="FREESTYLE")
    # default 0 = play to the rule outcome (no truncation at all — the
    # anchor's uniform value cannot adjudicate truncated games)
    ap.add_argument("--max-moves", type=int, default=0)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--anchor", default="v1", choices=["v1", "v2"])
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from alphagomoku_tpu_torch.eval import match as M
    from alphagomoku_tpu_torch.eval.anchor import (
        ANCHOR_MCFG, ANCHOR_V2_VERSION, ANCHOR_VERSION, anchor_opponent,
    )
    from alphagomoku_tpu_torch.game import vectorized as V
    from alphagomoku_tpu_torch.game.types import GameRules
    from alphagomoku_tpu_torch.models.convert import from_flax
    from alphagomoku_tpu_torch.models.forward import network_apply
    from alphagomoku_tpu_torch.models.networks import create_network, init_flax_
    from alphagomoku_tpu_torch.utils import checkpoint

    version = ANCHOR_V2_VERSION if args.anchor == "v2" else ANCHOR_VERSION
    device = torch.device("cpu" if args.cpu else "cuda")
    rules = GameRules[args.rules]
    h = w = args.size
    tables = V.device_tables(rules)
    net = create_network(args.arch, blocks=args.blocks, filters=args.filters, rows=h, cols=w)
    if args.checkpoint:
        net.load_state_dict(from_flax(checkpoint.load(args.checkpoint)))
    else:
        init_flax_(net, torch.Generator().manual_seed(0))
    apply, weights = network_apply(net.to(device).eval())

    rng = np.random.default_rng(0)
    openings = M.random_openings(rng, args.pairs, h, w, stones=4)
    t0 = time.time()
    results = M.play_multi_match(
        apply, weights, [anchor_opponent(version)], tables,
        ANCHOR_MCFG, args.sims, openings,
        max_moves=(args.max_moves if args.max_moves > 0 else None),
        raw_input_a=net.cfg.raw_input, device=device,
    )
    res = results[0]
    print(json.dumps({
        "anchor": version,
        "checkpoint": args.checkpoint or "(random init)",
        "sims": args.sims,
        "pairs": args.pairs,
        "pentanomial": res.pentanomial.tolist(),
        "score_vs_anchor": round(res.score_a, 4),
        "elo_vs_anchor": round(res.elo_a, 1),
        "unfinished": res.truncated,
        "seconds": round(time.time() - t0, 1),
    }))


if __name__ == "__main__":
    main()
