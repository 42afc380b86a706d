"""Runtime self-verification: subprocess-isolated environment checks.

Port of the reference package's `utils/selfcheck.py` (reference:
src/utils/selfcheck.cpp:63-120, invoked from ProgramManager.cpp:355-375):
each check runs in a spawned subprocess with captured output, so a
crashing backend cannot take down the engine process, and the user gets a
per-check PASS/FAIL report.  The subprocesses run side by side, where the
reference package's run one after another; the report is the same.

Checks, in the reference package's order: the torch device (present, and
a small op on it gives 56; in this process, which owns the device the
engine will use), the pattern tables (the same eight-character SHA-1
digests as the reference package's), the rules engine's golden position,
a ConvNextPVQMraw 1x16 forward through the module (finite outputs), and a
FastPolicy 1x8 search at 9x9 with 81 edge slots (it must find a
win-in-1).

The numeric checks run on the given device, the card by default.  The
reference package pins its children to the CPU only because a TPU client
is exclusive to one process; a CUDA context in a spawned child is not, so
here the network and search checks run on the card, the search launching
score_backup at K = 81.  Without a checkpoint the reference package draws
its weights from `jax.random.PRNGKey(0)`; the port draws them from a
`torch.Generator` seeded with 0 (`init_flax_`).
"""

from __future__ import annotations

import functools
import multiprocessing as mp
import time
import traceback
from typing import Callable

import numpy as np
import torch


def _check_device(device: str) -> str:
    dev = torch.device(device)
    if dev.type == "cuda":
        assert torch.cuda.is_available(), "no CUDA device"
        name = torch.cuda.get_device_name(dev)
    else:
        name = str(dev)
    x = (torch.arange(8, device=dev) * 2).sum()
    assert int(x) == 56
    return f"device: {name}"


def _check_pattern_tables(device: str) -> str:
    import hashlib

    from ..game.types import GameRules
    from ..patterns import tables as T

    digests = []
    for rules in GameRules:
        pat, thr = T.get_tables(rules)
        assert pat.shape == (T.NUM_PATTERNS,) and thr.shape == (8**4,)
        digests.append(hashlib.sha1(pat.tobytes() + thr.tobytes()).hexdigest()[:8])
    return "table digests: " + " ".join(digests)


def _check_rules(device: str) -> str:
    from ..game.rules import get_outcome
    from ..game.types import CROSS, GameOutcome, GameRules, Move

    board = np.zeros((15, 15), np.int8)
    board[7, 3:8] = CROSS
    out = get_outcome(GameRules.FREESTYLE, board, Move(row=7, col=7, sign=CROSS))
    assert out == GameOutcome.CROSS_WIN, out
    return "five-in-a-row detected"


def _check_network(device: str) -> str:
    from ..models.networks import create_network, init_flax_

    net = init_flax_(create_network("ConvNextPVQMraw", blocks=1, filters=16),
                     torch.Generator().manual_seed(0)).to(device)
    x = torch.zeros((2, 15, 15, net.cfg.input_planes), device=device)
    for leaf in net(x):
        if leaf is not None:
            assert bool(torch.isfinite(leaf).all()), "non-finite output"
    return "forward pass finite"


def win_in_one():
    """The search check's position: four in a row at 9x9, both ends open,
    CROSS to move; and the winning cells."""
    from ..game.types import CROSS

    board = np.zeros((1, 9, 9), np.int8)
    board[0, 4, 2:6] = CROSS
    return board, np.full((1,), CROSS, np.int8), ((4, 1), (4, 6))


def search_check(net, device):
    """The search check's 16-simulation search with `net` (a FastPolicy
    network for 9x9 boards): max_nodes 24, max_edges 81, max_depth 8.
    Returns the final search state."""
    from ..game import vectorized as V
    from ..game.types import GameRules
    from ..models.forward import network_apply
    from ..search import mcts

    board, stm, _ = win_in_one()
    apply, variables = network_apply(net.to(device))
    cfg = mcts.MCTSConfig(max_nodes=24, max_edges=81, max_depth=8)
    return mcts.run_search(apply, variables, V.device_tables(GameRules.FREESTYLE), cfg,
                           board, stm, 16, device=device)


def _check_search(device: str) -> str:
    from ..models.networks import create_network, init_flax_
    from ..search import mcts

    net = init_flax_(create_network("FastPolicy", blocks=1, filters=8, rows=9, cols=9),
                     torch.Generator().manual_seed(0))
    mv = int(mcts.select_move(search_check(net, device))[0])
    assert (mv // 9, mv % 9) in win_in_one()[2], f"bad move {mv}"
    return "win-in-1 found"


CHECKS: list[tuple[str, Callable[[str], str]]] = [
    ("torch device", _check_device),
    ("pattern tables", _check_pattern_tables),
    ("rules engine", _check_rules),
    ("network", _check_network),
    ("search", _check_search),
]


def _run_in_subprocess(fn: Callable[[], str], queue) -> None:
    try:
        queue.put(("ok", fn()))
    except Exception:
        queue.put(("fail", traceback.format_exc()))


def _run_here(fn: Callable[[], str]) -> tuple[str, str]:
    try:
        return "ok", fn()
    except Exception:
        return "fail", traceback.format_exc()


def run_selfcheck(isolate: bool = True, timeout: float = 300.0,
                  device: str | torch.device = "cuda") -> bool:
    """Run every check on `device`; True if all pass.  isolate=True runs
    each check but the device check in its own SPAWNED subprocess (fork is
    unsafe once a multithreaded runtime, CUDA's among them, is up).  The
    subprocesses start together, since each one's start-up (an interpreter,
    the package, a CUDA context) outlasts its check, and are reported in
    the checks' order, each failed once `timeout` seconds have passed since
    the start; the device check runs in this process, whose device the
    engine uses."""
    ctx = mp.get_context("spawn")
    children = {}
    if isolate:
        for name, check in CHECKS:
            if name != "torch device":
                q = ctx.Queue()
                p = ctx.Process(target=_run_in_subprocess,
                                args=(functools.partial(check, str(device)), q))
                p.start()
                children[name] = (p, q)
    deadline = time.monotonic() + timeout
    all_ok = True
    for name, check in CHECKS:
        if name not in children:
            status, detail = _run_here(functools.partial(check, str(device)))
        else:
            p, q = children[name]
            p.join(max(0.0, deadline - time.monotonic()))
            if p.is_alive():
                p.terminate()
                p.join()
                status, detail = "fail", "timeout"
            elif q.empty():
                status, detail = "fail", f"crashed (exit {p.exitcode})"
            else:
                status, detail = q.get()
        mark = "PASS" if status == "ok" else "FAIL"
        print(f"[{mark}] {name}: {detail.splitlines()[-1] if detail else ''}", flush=True)
        all_ok &= status == "ok"
    return all_ok


if __name__ == "__main__":
    import sys

    sys.exit(0 if run_selfcheck() else 1)
