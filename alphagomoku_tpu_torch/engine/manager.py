"""Program manager: the protocol <-> engine message pump.

Counterpart of the reference's ProgramManager main loop
(reference: src/player/ProgramManager.cpp:98-213): an async stdin listener
feeds the protocol, which queues typed messages; the pump dispatches
{START_PROGRAM, SET_OPTION, SET_POSITION, START_SEARCH, STOP_SEARCH,
EXIT_PROGRAM}, runs searches with the TimeManager budget, and routes results
back out through the protocol formatters.

Port of the reference package's `engine/manager.py`: the same options,
defaults and search modes; the engine (`engine.Engine`) runs on `device`,
the card unless the caller asks for the CPU.  `--selfcheck` runs the
environment checks of `utils/selfcheck.py`."""

from __future__ import annotations

import sys
from typing import IO

from ..game.types import CROSS, GameRules, Move
from .engine import Engine
from .gomocup import ExtendedGomocupProtocol, GomocupProtocol
from .protocol import (
    InputListener,
    Message,
    MessageQueue,
    MessageType,
    OutputSender,
)
from .time_manager import TimeManager


class ProgramManager:
    def __init__(
        self,
        protocol: str = "gomocup",
        architecture: str = "ConvNextPVQMraw",
        blocks: int = 6,
        filters: int = 64,
        checkpoint: str | None = None,
        simulations: int = 400,
        leaf_solver: str = "vct",
        leaf_solver_steps: int = 16,
        instream: IO[str] | None = None,
        outstream: IO[str] | None = None,
        device: str = "cuda",
    ):
        self.input_queue = MessageQueue()
        self.output_queue = MessageQueue()
        if protocol == "yixin":
            from .yixin import YixinBoardProtocol

            proto_cls = YixinBoardProtocol
        elif protocol == "extended":
            proto_cls = ExtendedGomocupProtocol
        else:
            proto_cls = GomocupProtocol
        self.protocol = proto_cls(self.input_queue, self.output_queue)
        # instream=None -> no reader thread; lines arrive via push_line
        # (test mode); the launcher passes sys.stdin explicitly
        self.listener = InputListener(instream)
        out = outstream if outstream is not None else sys.stdout

        def sink(line: str) -> None:
            out.write(line + "\n")
            out.flush()

        self.sender = OutputSender(sink)
        self.time_manager = TimeManager()

        # engine options (reference: EngineSettings defaults,
        # player/EngineSettings.hpp:34-93)
        self.options: dict[str, str] = {
            "rows": "15",
            "columns": "15",
            "rules": "FREESTYLE",
            "time_for_turn": "5000",
            "time_for_match": "120000",
            "time_left": "120000",
            "protocol_lag": "150",
            # (reference: EngineSettings defaults, EngineSettings.hpp:48-63)
            "max_memory": str(256 * 1024 * 1024),
            "max_depth": "0",
            "max_nodes": "0",
            "auto_pondering": "0",
            "time_for_pondering": "0",
            "analysis_mode": "0",
            # `style` is accepted and unused — the reference accepts the
            # option but EngineSettings has no consumer for it either
            "style": "0",
            # per-rule network checkpoint paths (reference: path_to_conv_
            # networks rewritten per rule, ProgramManager.cpp:405-417)
            "network_freestyle": "",
            "network_standard": "",
            "network_renju": "",
            "network_caro5": "",
            "network_caro6": "",
            # swap2 opening book: JSON list of 3-move rows, each move
            # {"row", "col", "sign"} (reference: EngineSettings
            # swap2_openings_file + load_opening_book,
            # src/player/EngineSettings.cpp:29-50,75)
            "swap2_openings_file": "",
        }
        self._arch = architecture
        self._blocks = blocks
        self._filters = filters
        self._checkpoint = checkpoint
        self._simulations = simulations
        self._leaf_solver = leaf_solver
        self._leaf_solver_steps = leaf_solver_steps
        self._device = device
        self.engine: Engine | None = None
        self._bg_search = None
        self._running = True

    def _stop_background_search(self) -> None:
        if self.engine is not None:
            self.engine.stop()
        if self._bg_search is not None and self._bg_search.is_alive():
            self._bg_search.join(timeout=30.0)
        self._bg_search = None

    # -- engine lifecycle --------------------------------------------------

    def _setup_engine(self) -> Engine:
        """(reference: ProgramManager::setup_engine, rebuild on option
        change, ProgramManager.cpp:478-495)"""
        if self.engine is None:
            rules = GameRules.from_string(self.options["rules"])
            # per-rule network path override (reference: network paths
            # rewritten per rule, ProgramManager.cpp:405-417)
            per_rule = self.options.get(f"network_{rules.name.lower()}", "")
            checkpoint = per_rule or self._checkpoint
            max_memory = int(float(self.options.get("max_memory", "0") or 0))
            max_depth = int(self.options.get("max_depth", "0") or 0)
            self.engine = Engine(
                rules=rules,
                rows=int(self.options["rows"]),
                cols=int(self.options["columns"]),
                architecture=self._arch,
                blocks=self._blocks,
                filters=self._filters,
                checkpoint=checkpoint or None,
                simulations=self._simulations,
                leaf_solver=self._leaf_solver,
                leaf_solver_steps=self._leaf_solver_steps,
                max_memory=max_memory if max_memory > 0 else None,
                max_depth=max_depth if max_depth > 0 else None,
                draw_after=int(float(self.options.get("draw_after", "0") or 0)),
                solver_tuning=self.options.get("solver_tuning", "") in
                ("1", "true", "on"),
                device=self._device,
            )
        return self.engine

    def _load_swap2_book(self) -> list[list[Move]]:
        """Parse the swap2 opening book: a JSON list of 3-move rows, each
        move {"row": int, "col": int, "sign": "CROSS"|"CIRCLE"} (reference:
        load_opening_book, src/player/EngineSettings.cpp:29-50).  A missing
        or unreadable file yields an empty book (the reference logs "No
        swap2 opening book")."""
        import json
        import os

        from ..game.types import CIRCLE

        path = self.options.get("swap2_openings_file", "")
        if not path or not os.path.exists(path):
            return []
        signs = {"CROSS": CROSS, "CIRCLE": CIRCLE, "X": CROSS, "O": CIRCLE}
        try:
            with open(path) as fh:
                data = json.load(fh)
            book = []
            for row in data:
                book.append([
                    Move(row=int(m["row"]), col=int(m["col"]),
                         sign=signs[str(m["sign"]).upper()])
                    for m in row
                ])
            return book
        except (OSError, ValueError, KeyError, TypeError):
            return []

    def _set_option(self, name: str, value: str) -> None:
        old = self.options.get(name)
        self.options[name] = value
        realloc = ("rows", "columns", "rules", "max_memory", "max_depth",
                   "draw_after",
                   "network_freestyle", "network_standard", "network_renju",
                   "network_caro5", "network_caro6")
        if name in realloc and old != value:
            self.engine = None  # reallocate on next search
            # (reference: SetOptionOutcome REALLOCATE_ENGINE)

    # -- search dispatch ---------------------------------------------------

    def _time_budget_s(self) -> float:
        engine = self._setup_engine()
        move_number = len(engine.moves)
        tm = self.time_manager
        budget_ms = tm.get_time_for_turn(
            rules=engine.rules,
            rows=engine.rows,
            move_number=move_number,
            expectation=0.5,
            time_for_turn=float(self.options["time_for_turn"]),
            time_left=float(self.options["time_left"]),
            protocol_lag=float(self.options["protocol_lag"]),
        )
        return max(0.05, budget_ms / 1000.0)

    def _start_search(self, mode: str) -> None:
        engine = self._setup_engine()
        if mode not in ("ponder", "analyze"):
            self._stop_background_search()
        if mode.startswith("bestmove"):
            # protocol-adjustable node limit (reference: EngineSettings
            # max_nodes via INFO max_node, EngineSettings.hpp:34-93)
            max_sims = None
            if self.options.get("max_nodes", "0") not in ("0", ""):
                max_sims = max(
                    engine.sim_chunk, int(self.options["max_nodes"])
                )
            self.time_manager.start_timer()
            rt_seq = [0]

            def rt_chunk(_summary):
                # realtime analysis stream during the search (reference:
                # YixinBoard REALTIME POS/DONE/LOSE/BEST every 100 ms,
                # YixinBoardProtocol.cpp:714-795); protocols without a
                # REALTIME_INFO processor drop these messages
                snap = engine.realtime_snapshot()
                if snap is not None:
                    snap["seq"] = rt_seq[0]
                    rt_seq[0] += 1
                    self.output_queue.push(
                        Message(MessageType.REALTIME_INFO, snap)
                    )
                    self.protocol.process_output(self.sender)

            summary = engine.search(
                self._time_budget_s(), max_simulations=max_sims,
                on_chunk=rt_chunk,
            )
            self.time_manager.stop_timer()
            from ..utils.logger import log

            log("search", engine.search_info_text(summary))
            self.output_queue.push(
                Message(
                    MessageType.INFO_MESSAGE,
                    f"depth 1-{len(summary.principal_variation)} "
                    f"ev {summary.expectation:.3f} n {summary.simulations} "
                    f"n/s {int(summary.simulations / max(summary.time_used, 1e-9))} "
                    f"tm {int(1000 * summary.time_used)} pv "
                    + " ".join(m.text() for m in summary.principal_variation),
                )
            )
            self.output_queue.push(Message(MessageType.BEST_MOVE, summary.best_move))
            if (
                self.options.get("auto_pondering", "0") == "1"
                and self.options.get("analysis_mode", "0") != "1"
            ):
                # think on the opponent's time after answering (reference:
                # MatchController auto-ponder, MatchController.cpp:55-77)
                engine.make_move(summary.best_move)
                self._start_search("ponder")
        elif mode == "showforbid":
            forbidden = engine.forbidden_moves()
            text = " ".join(f"{m.row},{m.col}" for m in forbidden)
            self.output_queue.push(
                Message(MessageType.PLAIN_STRING, ("FORBID " + text).strip())
            )
        elif mode in ("ponder", "analyze"):
            # background search emitting periodic analysis until STOP
            # (reference: PonderingController + YixinBoard realtime
            # POS/DONE analysis stream)
            self._stop_background_search()

            def run_bg():
                rt_seq = [0]

                def emit(summary):
                    self.output_queue.push(
                        Message(
                            MessageType.INFO_MESSAGE,
                            f"depth 1-{len(summary.principal_variation)} "
                            f"ev {summary.expectation:.3f} n {summary.simulations} pv "
                            + " ".join(
                                m.text() for m in summary.principal_variation[:6]
                            ),
                        )
                    )
                    snap = engine.realtime_snapshot()
                    if snap is not None:
                        snap["seq"] = rt_seq[0]
                        rt_seq[0] += 1
                        self.output_queue.push(
                            Message(MessageType.REALTIME_INFO, snap)
                        )

                ponder_ms = float(self.options.get("time_for_pondering", "0") or 0)
                budget = (
                    ponder_ms / 1000.0
                    if (mode == "ponder" and ponder_ms > 0)
                    else 3600.0
                )  # (reference: EngineSettings time_for_pondering)
                engine.search(
                    time_budget=budget,
                    on_chunk=emit if mode == "analyze" else None,
                    max_simulations=1 << 22,
                )

            import threading

            self._bg_search = threading.Thread(target=run_bg, daemon=True)
            self._bg_search.start()
        elif mode == "swap":
            # after the opponent's opening stone(s): take their color when
            # the mover is behind, play otherwise (reference: SwapController)
            summary = engine.search(self._time_budget_s(), selector="balanced")
            if summary.expectation < 0.5:
                self.output_queue.push(Message(MessageType.PLAIN_STRING, "SWAP"))
            else:
                self.output_queue.push(Message(MessageType.BEST_MOVE, summary.best_move))
        elif mode.startswith("swap5"):
            # swap5 opening rule (reference: Swap5Controller.cpp:29-95;
            # declared but not reachable from the reference's dispatcher —
            # here it is a first-class search mode): stone 1 is random-ish,
            # stones 1-4 offer a swap-or-balanced-move decision, stone 5
            # answers with the best 6th move
            must_play = mode.endswith("play")
            n = len(engine.moves)
            if n == 0:
                import random as _random

                r = _random.randrange(engine.rows)
                c = _random.randrange(engine.cols)
                self.output_queue.push(
                    Message(MessageType.BEST_MOVE, Move(row=r, col=c, sign=CROSS))
                )
            elif n <= 4:
                summary = engine.search(self._time_budget_s(), selector="balanced")
                if summary.expectation < 0.5 and not must_play:
                    self.output_queue.push(Message(MessageType.PLAIN_STRING, "SWAP"))
                else:
                    self.output_queue.push(
                        Message(MessageType.BEST_MOVE, summary.best_move)
                    )
            else:
                summary = engine.search(self._time_budget_s())
                self.output_queue.push(Message(MessageType.BEST_MOVE, summary.best_move))
        elif mode == "swap1st":
            # swap1st opening rule (reference: Swap1stController.cpp:21-66):
            # evaluate the opponent's first stone and swap when behind (the
            # reference's first-stone placement is an unimplemented TODO; a
            # balanced random central stone is played here instead)
            n = len(engine.moves)
            if n == 0:
                import random as _random

                r = engine.rows // 2 + _random.randrange(-2, 3)
                c = engine.cols // 2 + _random.randrange(-2, 3)
                self.output_queue.push(
                    Message(MessageType.BEST_MOVE, Move(row=r, col=c, sign=CROSS))
                )
            else:
                summary = engine.search(self._time_budget_s())
                if summary.expectation < 0.5:
                    self.output_queue.push(Message(MessageType.PLAIN_STRING, "SWAP"))
                else:
                    self.output_queue.push(
                        Message(MessageType.BEST_MOVE, summary.best_move)
                    )
        elif mode.startswith("evaluate"):
            # answer the per-move evaluation from the last search's root
            # edges without searching (reference:
            # GomocupProtocol::info_evaluate + get_evaluation_string,
            # GomocupProtocol.cpp:21-40,347-361)
            try:
                r, c = (int(x) for x in mode.split()[1].split(","))
            except (IndexError, ValueError):
                self.output_queue.push(Message(MessageType.INFO_MESSAGE, ""))
                return
            root = getattr(engine, "_last_root", None)
            text = ""
            if root is not None:
                import numpy as np

                a = r * engine.cols + c
                idx = np.where(root["actions"].astype(np.int64) == a)[0]
                if len(idx):
                    i = int(idx[0])
                    es = int(root["escore"][i])
                    pv = (es >> 13) & 7
                    n = float(root["visits"][i])
                    if pv != 2 and es not in (0x0000, 0xFFFF):  # proven
                        dist = abs((es & 0x1FFF) - 4000)
                        name = {0: "LOSS", 1: "DRAW", 3: "WIN"}[pv]
                        text = f"ev {name} in {dist}"
                    else:
                        q = (
                            (root["vsum"][i, 0] + 0.5 * root["vsum"][i, 1])
                            / max(n, 1.0)
                        )
                        text = f"ev {100.0 * q:.2f}%"
                    # winrate/drawrate suffix (reference:
                    # get_evaluation_string, GomocupProtocol.cpp:21-40)
                    text += " winrate {:.2f}% drawrate {:.2f}%".format(
                        100.0 * root["vsum"][i, 0] / max(n, 1.0),
                        100.0 * root["vsum"][i, 1] / max(n, 1.0),
                    )
            self.output_queue.push(Message(MessageType.INFO_MESSAGE, text))
        elif mode == "rif":
            # the reference declares RIFController but ships no
            # implementation and never dispatches it (RIFController.hpp
            # only); acknowledged-unsupported to match
            self.output_queue.push(
                Message(MessageType.ERROR, "RIF opening rule is not supported")
            )
        elif mode.startswith("swap2") or mode.startswith("balance"):
            # balancing searches pick the closest-to-draw move
            # (reference: Swap2Controller + BalancedSelector,
            # src/player/controllers/Swap2Controller.cpp:22-156)
            budget = self._time_budget_s()
            if mode.startswith("swap2") and len(engine.moves) == 0:
                # first player: place THREE opening stones from a random
                # book row (reference: PUT_FIRST_3_STONES,
                # Swap2Controller.cpp:48-60); with no book the reference
                # errors — here a balanced-search fallback places a strong
                # first stone and two balancing stones instead
                book = self._load_swap2_book()
                if book:
                    import random

                    row = book[random.randrange(len(book))]
                    self.output_queue.push(Message(MessageType.BEST_MOVE, row))
                    return
                first = engine.search(budget / 3.0).best_move
                engine.make_move(first)
                second = engine.search(budget / 3.0, selector="balanced").best_move
                engine.make_move(second)
                third = engine.search(budget / 3.0, selector="balanced").best_move
                self.output_queue.push(
                    Message(MessageType.BEST_MOVE, [first, second, third])
                )
                return
            if mode.startswith("swap2") and len(engine.moves) == 5:
                # after the two balancing stones: swap when behind, play
                # otherwise (reference: EVALUATE_5_STONES,
                # Swap2Controller.cpp:142-155, threshold 0.5)
                summary = engine.search(budget)
                if summary.expectation < 0.5:
                    self.output_queue.push(
                        Message(MessageType.PLAIN_STRING, "SWAP")
                    )
                else:
                    self.output_queue.push(
                        Message(MessageType.BEST_MOVE, summary.best_move)
                    )
                return
            if mode.startswith("swap2") and len(engine.moves) == 3:
                # 3-stone opening: swap / play one strong move / answer with
                # TWO balancing stones (reference thresholds 1/3 and 2/3 on
                # the root expectation, Swap2Controller.cpp:72-131)
                summary = engine.search(0.5 * budget, selector="balanced")
                if summary.expectation < 1.0 / 3.0:
                    self.output_queue.push(Message(MessageType.PLAIN_STRING, "SWAP"))
                    return
                if summary.expectation > 2.0 / 3.0:
                    self.output_queue.push(
                        Message(MessageType.BEST_MOVE, summary.best_move)
                    )
                    return
                # balanced middle: chain two balancing searches — play the
                # first balancing move, search the reply position for the
                # second (Swap2Controller.cpp:86-131 second_balancing_move)
                first = summary.best_move
                engine.make_move(first)
                summary2 = engine.search(0.5 * budget, selector="balanced")
                second = summary2.best_move
                self.output_queue.push(
                    Message(MessageType.BEST_MOVE, [first, second])
                )
                return
            summary = engine.search(budget, selector="balanced")
            self.output_queue.push(Message(MessageType.BEST_MOVE, summary.best_move))

    # -- the pump ----------------------------------------------------------

    def process_message(self, msg: Message) -> None:
        if msg.type == MessageType.START_PROGRAM:
            pass
        elif msg.type == MessageType.SET_OPTION:
            self._set_option(*msg.data)
        elif msg.type == MessageType.SET_POSITION:
            self._stop_background_search()
            self._setup_engine().set_position(msg.data)
        elif msg.type == MessageType.START_SEARCH:
            self._start_search(str(msg.data))
        elif msg.type == MessageType.STOP_SEARCH:
            self._stop_background_search()
        elif msg.type == MessageType.EXIT_PROGRAM:
            self._running = False

    def run_once(self) -> None:
        """One pump tick: read one protocol line, dispatch queued messages,
        flush output."""
        self.protocol.process_input(self.listener)
        while True:
            msg = self.input_queue.try_pop()
            if msg is None:
                break
            self.process_message(msg)
        self.protocol.process_output(self.sender)

    def run(self) -> None:
        while self._running:
            self.run_once()


def main(argv: list[str] | None = None) -> None:
    import argparse

    p = argparse.ArgumentParser(description="AlphaGomoku engine (PyTorch, on the GPU)")
    p.add_argument(
        "--protocol", default="extended", choices=["gomocup", "extended", "yixin"]
    )
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--arch", default="ConvNextPVQMraw")
    p.add_argument("--blocks", type=int, default=6)
    p.add_argument("--filters", type=int, default=64)
    p.add_argument("--simulations", type=int, default=400)
    p.add_argument("--leaf-solver", default="vct", choices=["none", "vcf", "vct"],
                   help="per-leaf proof search fused into the MCTS step")
    p.add_argument("--leaf-solver-steps", type=int, default=16)
    p.add_argument("--device", default="cuda", help="torch device of the engine")
    p.add_argument(
        "--selfcheck",
        action="store_true",
        help="run environment self-verification and exit "
        "(reference: ProgramManager --selfcheck)",
    )
    p.add_argument("--benchmark", action="store_true", help="run the NN benchmark")
    p.add_argument("--configure", action="store_true", help="write config.json")
    p.add_argument("--output-dir", default=".",
                   help="where --benchmark and --configure write their files")
    args = p.parse_args(argv)
    if args.selfcheck:
        from ..utils.selfcheck import run_selfcheck

        raise SystemExit(0 if run_selfcheck(device=args.device) else 1)
    if args.benchmark or args.configure:
        from .benchmark import main as bench_main

        flags = []
        if args.benchmark:
            flags.append("--benchmark")
        if args.configure:
            flags.append("--configure")
        bench_main(flags + ["--arch", args.arch, "--blocks", str(args.blocks),
                            "--filters", str(args.filters), "--device", args.device,
                            "--output-dir", args.output_dir])
        return
    ProgramManager(
        protocol=args.protocol,
        architecture=args.arch,
        blocks=args.blocks,
        filters=args.filters,
        checkpoint=args.checkpoint,
        simulations=args.simulations,
        leaf_solver=args.leaf_solver,
        leaf_solver_steps=args.leaf_solver_steps,
        instream=sys.stdin,
        device=args.device,
    ).run()


if __name__ == "__main__":
    main()
