"""The port's protocol layer held against the JAX package's, line for line:
the transcripts of tests/test_protocol.py and the protocol-level ones of
tests/test_yixin_realtime.py (with pushed realtime snapshots), and more of
the Extended Gomocup and YixinBoard commands, run through both packages'
protocol classes; the emitted lines, the messages queued for the engine
and the protocols' move lists must be equal.  Also the time manager, over
a grid of rules, move numbers, expectations and clocks."""

import itertools

import pytest

from alphagomoku_tpu.engine import gomocup as JG
from alphagomoku_tpu.engine import protocol as JP
from alphagomoku_tpu.engine import time_manager as JTM
from alphagomoku_tpu.engine import yixin as JY
from alphagomoku_tpu.game.types import GameRules

from alphagomoku_tpu_torch.engine import gomocup as TG
from alphagomoku_tpu_torch.engine import protocol as TP
from alphagomoku_tpu_torch.engine import time_manager as TTM
from alphagomoku_tpu_torch.engine import yixin as TY
from alphagomoku_tpu_torch.game import types as TTY

PACKAGES = {
    "jax": dict(P=JP, classes={"gomocup": JG.GomocupProtocol,
                               "extended": JG.ExtendedGomocupProtocol,
                               "yixin": JY.YixinBoardProtocol}),
    "torch": dict(P=TP, classes={"gomocup": TG.GomocupProtocol,
                                 "extended": TG.ExtendedGomocupProtocol,
                                 "yixin": TY.YixinBoardProtocol}),
}


def _plain(x):
    """Messages' data as plain values (the packages' Move and enum types
    are distinct classes)."""
    if hasattr(x, "_fields"):  # Move
        return ("Move",) + tuple(int(v) for v in x)
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if hasattr(x, "name") and hasattr(x, "value"):  # enum
        return x.name
    return x


def run(package: str, proto: str, steps) -> dict:
    """Drive one protocol object through `steps` as the tests' Fixture
    does; returns every observable: the lines sent, the engine-bound
    messages after each step, and the move list."""
    pkg = PACKAGES[package]
    P = pkg["P"]
    listener = P.InputListener()
    inq, outq = P.MessageQueue(), P.MessageQueue()
    protocol = pkg["classes"][proto](inq, outq)
    sent: list[str] = []
    sender = P.OutputSender(sent.append)
    log = []
    for step in steps:
        kind, args = step[0], step[1:]
        if kind == "feed":
            for line in args:
                listener.push_line(line)
            while not listener.is_empty():
                protocol.process_input(listener)
        elif kind == "flush":
            protocol.process_output(sender)
        elif kind == "clear":
            sent.clear()
        elif kind == "best":  # the engine's answer: one move or a list
            mv = [_move(package, *m) for m in args[0]]
            outq.push(P.Message(P.MessageType.BEST_MOVE, mv[0] if len(mv) == 1 else mv))
        elif kind == "push":  # any other engine-side message
            outq.push(P.Message(P.MessageType[args[0]], args[1]))
        elif kind == "snapshot":  # a realtime snapshot, as the manager pushes it
            seq, edges, losing, best = args
            outq.push(P.Message(P.MessageType.REALTIME_INFO,
                                {"seq": seq, "edges": edges, "losing": losing, "best": best}))
            protocol.process_output(sender)
        else:
            raise ValueError(kind)
        drained = []
        while (m := inq.try_pop()) is not None:
            drained.append((m.type.name, _plain(m.data)))
        log.append((list(sent), drained))
    return dict(log=log, moves=_plain(list(getattr(protocol, "list_of_moves", []))),
                realtime=getattr(protocol, "show_realtime_info", None))


def _move(package, row, col, sign):
    if package == "jax":
        from alphagomoku_tpu.game.types import Move
        return Move(row=row, col=col, sign=sign)
    return TTY.Move(row=row, col=col, sign=sign)


X, O = 1, 2
TRANSCRIPTS = {
    # tests/test_protocol.py
    "start_ok": ("gomocup", [("feed", "START 15"), ("flush",)]),
    "start_bad_size": ("gomocup", [("feed", "START 10"), ("flush",)]),
    "turn_flow": ("gomocup", [("feed", "START 15"), ("flush",), ("feed", "TURN 7,8")]),
    "turn_occupied": ("gomocup", [("feed", "START 15", "TURN 7,7"), ("feed", "TURN 7,7"),
                                  ("flush",)]),
    "board_reconstruction": ("gomocup", [("feed", "START 15", "BOARD", "7,7,1", "8,8,2",
                                          "DONE")]),
    "board_opponent_started": ("gomocup", [("feed", "START 15", "BOARD", "0,0,2", "7,7,1",
                                            "1,1,2", "DONE")]),
    "board_invalid_counts": ("gomocup", [("feed", "START 15", "BOARD", "0,0,2", "1,1,2",
                                          "DONE"), ("flush",)]),
    "begin": ("gomocup", [("feed", "START 15", "BEGIN")]),
    "info_rule": ("gomocup", [("feed", "START 15", "INFO rule 4")]),
    "info_rule_invalid": ("gomocup", [("feed", "INFO rule 7"), ("flush",)]),
    "info_timeouts": ("gomocup", [("feed", "INFO timeout_turn 5000",
                                   "INFO timeout_match 120000", "INFO time_left 90000")]),
    "takeback": ("gomocup", [("feed", "START 15", "TURN 7,7"), ("feed", "TAKEBACK 7,7"),
                             ("flush",)]),
    "takeback_wrong": ("gomocup", [("feed", "START 15", "TURN 7,7"), ("feed", "TAKEBACK 3,3"),
                                   ("flush",)]),
    "unknown": ("gomocup", [("feed", "BLAH blah"), ("flush",)]),
    "end": ("gomocup", [("feed", "END")]),
    "about": ("gomocup", [("feed", "ABOUT"), ("flush",)]),
    "best_move_output": ("gomocup", [("feed", "START 15"), ("flush",),
                                     ("best", [(7, 8, X)]), ("clear",), ("flush",)]),
    "extended_play": ("extended", [("feed", "START 15", "PLAY 3,4"), ("flush",)]),
    "extended_version_clearhash": ("extended", [("feed", "PROTOCOLVERSION", "CLEARHASH"),
                                                ("flush",)]),
    "extended_stop": ("extended", [("feed", "STOP")]),
    "extended_swap2board": ("extended", [("feed", "START 15", "SWAP2BOARD", "7,7", "8,8",
                                          "9,7", "DONE")]),
    "extended_swapboard": ("extended", [("feed", "START 15", "SWAPBOARD", "7,7", "DONE")]),
    "extended_proboard": ("extended", [("feed", "PROBOARD"), ("flush",)]),
    "analysis_mode_suggests": ("extended", [("feed", "START 15", "INFO analysis_mode 1"),
                                            ("flush",), ("best", [(7, 8, X)]), ("clear",),
                                            ("flush",)]),
    # the engine's other answers and commands of a game (the engine phase of
    # chip_smoke.py drives these through the port's ProgramManager)
    "extended_game": ("extended", [
        ("feed", "START 15", "INFO max_node 50", "INFO timeout_turn 5000", "BEGIN"),
        ("flush",), ("best", [(7, 7, X)]), ("push", "INFO_MESSAGE", "depth 1-2 ev 0.5"),
        ("flush",), ("feed", "TURN 7,8"), ("best", [(6, 6, X)]), ("flush",),
        ("feed", "TAKEBACK 6,6"), ("flush",), ("feed", "INFO rule 4", "SHOWFORBID"),
        ("push", "PLAIN_STRING", "FORBID 3,3 4,4"), ("flush",),
        ("feed", "SWAP5BOARD", "DONE", "SWAP1STBOARD", "7,7", "DONE", "BALANCE 2"),
        ("push", "PLAIN_STRING", "SWAP"), ("push", "ERROR", "RIF opening rule is not supported"),
        ("best", [(1, 1, X), (2, 2, O), (3, 3, X)]), ("flush",),
        ("feed", "INFO evaluate 7,7", "RECTSTART 20,20", "RESTART", "START 20", "BEGIN"),
        ("flush",), ("feed", "PONDER", "STOP", "END"),
    ]),
    # tests/test_yixin_realtime.py
    "realtime_stream": ("yixin", [
        ("feed", "info show_detail 1"),
        ("snapshot", 0, [(7, 7), (7, 8)], [], (7, 7)), ("clear",),
        ("snapshot", 1, [(7, 7), (7, 8)], [(7, 8)], (7, 7)), ("clear",),
        ("snapshot", 2, [(7, 7), (7, 8)], [(7, 8)], (6, 6)), ("clear",),
        ("snapshot", 0, [(1, 1)], [], (1, 1)),
    ]),
    "realtime_gated": ("yixin", [
        ("snapshot", 0, [(7, 7)], [], (7, 7)), ("feed", "info show_detail 0"),
        ("snapshot", 0, [(7, 7)], [], (7, 7)),
    ]),
    "realtime_dropped_by_gomocup": ("gomocup", [("snapshot", 0, [], [], None)]),
    "yixin_commands": ("yixin", [
        ("feed", "START 15", "INFO rule 1", "yxboard", "7,7,1", "8,8,2", "done"), ("flush",),
        ("feed", "yxshowforbid", "yxstop", "yxnbest 3", "yxhashclear", "yxhashdump",
         "yxshowhashusage", "yxdraw", "yxresign", "yxshowinfo", "yxbalance 1", "yxswap2step1",
         "yxswap2", "info hash_size 1024", "info caution_factor 3", "yxquery", "ABOUT"),
        ("flush",), ("best", [(6, 6, X)]), ("flush",),
    ]),
}


@pytest.mark.parametrize("name", sorted(TRANSCRIPTS))
def test_transcript_equals_jax(name):
    proto, steps = TRANSCRIPTS[name]
    ref = run("jax", proto, steps)
    ours = run("torch", proto, steps)
    assert ours == ref
    # the transcript did something, except the one whose message is dropped
    did = any(sent or drained for sent, drained in ref["log"])
    assert did != (name == "realtime_dropped_by_gomocup")


def test_about_line_is_the_reference_packages():
    ours = run("torch", "gomocup", [("feed", "ABOUT"), ("flush",)])
    assert any("AlphaGomokuTPU" in line for line in ours["log"][-1][0])


def test_time_manager_equals_jax():
    """get_time_for_turn, get_time_for_opening and the moves-left curves
    over a grid of rules, move numbers, expectations and clocks."""
    ref, ours = JTM.TimeManager(), TTM.TimeManager()
    grid = itertools.product(GameRules, (0, 1, 10, 20, 64, 100, 150, 225, 349, 350, 400, 450),
                             (0.0, 0.25, 0.5, 0.9, 1.0), (500.0, 5000.0, 30000.0),
                             (0.0, 1000.0, 90000.0, 120000.0), (0.0, 150.0))
    n = 0
    for rules, move, ev, turn, left, lag in grid:
        trules = TTY.GameRules(rules)
        a = ref.get_time_for_turn(rules, 15, move, ev, turn, left, lag)
        b = ours.get_time_for_turn(trules, 15, move, ev, turn, left, lag)
        assert a == b
        assert (ref.estimators[rules].get(move, ev)
                == ours.estimators[trules].get(move, ev))
        n += 1
    for turn, left, lag in itertools.product((100.0, 5000.0), (0.0, 3000.0, 1e6), (0.0, 150.0)):
        assert ref.get_time_for_opening(turn, left, lag) == ours.get_time_for_opening(
            turn, left, lag)
    ours.start_timer()
    ours.stop_timer()
    assert ours.get_elapsed_time() >= 0.0
    ours.reset_timer()
    assert ours.used_time == 0.0 and n > 1000
    est = {"c0": [(0, 60), (400, 0)], "c2": [(0, 200), (350, 0)]}
    assert JTM.MovesLeftEstimator(**est).get(100, 0.75) == TTM.MovesLeftEstimator(**est).get(
        100, 0.75)
