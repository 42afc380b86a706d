"""Time the playing engine's moves through its launcher, as a player's
GUI or a Gomocup manager drives it.

    python3 -m alphagomoku_tpu_torch.tools.engine_move [--checkpoint PATH]
        [--timeout-turn MS] [--out DIR]

Starts `python3 -m alphagomoku_tpu_torch.engine.manager --protocol
extended --checkpoint PATH` (the launcher's defaults: 400 simulations, the
VCT leaf solver, on the card) as a child process, writes protocol lines to
its standard input and times each answer from the line that asks for it
to the move line it prints:

1. a warm-up move: BEGIN under `INFO max_node 50` (the engine is built
   and its first search run here);
2. one move at the defaults with no clock: `INFO max_node 0`, no turn
   limit, BEGIN on a new game (400 simulations in 8 chunks of 50);
3. one Gomocup turn at the protocol's clock: `INFO timeout_turn MS`
   (default 5000) and `INFO time_left 120000`, the engine's time manager
   budgeting the turn, then a TURN; the engine reads the clock between
   chunks of 50 simulations, so a turn can outlast its budget.

Prints the engine's search lines, then one JSON line with the seconds of
each move, the simulations each search reports and the turn's overrun
(seconds over the turn limit's); with `--out`, writes it to
DIR/engine_move.json too.  Runs on the card.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CKPT = ROOT / "runs" / "flagship_r4" / "checkpoint" / "network_23.msgpack"
MOVE = re.compile(r"\d+,\d+")


class Launcher:
    """The launcher as a child process, read line by line."""

    def __init__(self, checkpoint: str):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "alphagomoku_tpu_torch.engine.manager", "--protocol",
             "extended", "--checkpoint", checkpoint],
            cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, bufsize=1)

    def send(self, *lines: str) -> None:
        for line in lines:
            self.proc.stdin.write(line + "\n")
        self.proc.stdin.flush()

    def until(self, pattern: re.Pattern) -> tuple[list[str], float]:
        """Lines up to and including the first that matches `pattern`,
        and the seconds they took."""
        t0 = time.perf_counter()
        seen = []
        for line in self.proc.stdout:
            line = line.rstrip("\n")
            seen.append(line)
            print(f"  < {line}", flush=True)
            if pattern.fullmatch(line):
                return seen, time.perf_counter() - t0
        raise SystemExit(f"engine_move: the launcher exited ({self.proc.wait()}) after {seen}")

    def move(self, *lines: str) -> dict:
        self.send(*lines)
        seen, seconds = self.until(MOVE)
        info = [x for x in seen if x.startswith("MESSAGE depth")]
        sims = int(re.search(r" n (\d+) ", info[-1]).group(1)) if info else 0
        return dict(seconds=seconds, move=seen[-1], simulations=sims,
                    message=info[-1] if info else "")

    def close(self) -> None:
        self.send("END")
        try:
            self.proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            self.proc.kill()


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--checkpoint", default=str(CKPT))
    p.add_argument("--timeout-turn", type=int, default=5000, help="the turn's limit, ms")
    p.add_argument("--out", default=None, help="directory for engine_move.json")
    args = p.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    eng = Launcher(args.checkpoint)
    try:
        eng.send("START 15")
        eng.until(re.compile("OK"))
        warm = eng.move("INFO timeout_turn 3600000", "INFO time_left 2000000000",
                        "INFO max_node 50", "BEGIN")
        full = eng.move("INFO max_node 0", "BEGIN")
        r, c = (int(x) for x in full["move"].split(","))
        reply = next(f"{rr},{cc}" for rr, cc in ((r + 1, c + 1), (r - 1, c - 1), (r + 1, c - 1))
                     if 0 <= rr < 15 and 0 <= cc < 15)
        turn = eng.move(f"INFO timeout_turn {args.timeout_turn}", "INFO time_left 120000",
                        f"TURN {reply}")
    finally:
        eng.close()
    limit = args.timeout_turn / 1000.0
    result = dict(device=smi, warm_up=warm, default_move=full, gomocup_turn=dict(
        turn, limit_s=limit, overrun=turn["seconds"] / limit))
    print(json.dumps(result), flush=True)
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
        (Path(args.out) / "engine_move.json").write_text(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
