"""The port's playing engine (`engine/engine.py`, `engine/manager.py`) held
against the JAX package's through whole protocol transcripts.

Both packages' ProgramManagers run the same lines with one deterministic
stub network put in through `Engine._apply` (the stub of
tests/test_torch_mcts.py, with the same recipe at 9x9 and 20x20), and
every search the engine runs is recorded: its tree (the `EXACT` fields
array-equal, values and priors within 1e-5 relative), its summary (move,
simulations, nodes, principal variation, proven string) and the protocol's
output lines, which must be equal line for line (the speed and time fields
of the search message masked).  The JAX side comes from goldens of
`jax_engine_case` (tests/torch_golden).  Also one case with the real
network_23 at 8 simulations, the ProgramManager cases of
tests/test_engine.py and tests/test_yixin_realtime.py on the port, and the
port's own entry-point checks."""

from __future__ import annotations

import functools
import io
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from alphagomoku_tpu_torch.engine import engine as TE
from alphagomoku_tpu_torch.engine import manager as TMGR
from alphagomoku_tpu_torch.engine.protocol import Message, MessageType
from alphagomoku_tpu_torch.game.types import CROSS, CIRCLE, Move
from alphagomoku_tpu_torch.models.networks import NetOutput
from tests import torch_golden

torch.set_num_threads(1)

CKPT = Path(__file__).resolve().parents[1] / "runs/flagship_r4/checkpoint/network_23.msgpack"
EXACT = ("node_visits", "node_count", "edge_action", "edge_child", "node_score",
         "edge_score", "node_hash", "node_complete")
CLOSE = ("node_value_sum", "edge_prior")
SIMS = 16  # the manager's simulations: capacity 56, one chunk of 16
# a tiny network for the engine to build: the stub replaces its forward
NET = dict(architecture="ConvNextPVQMraw", blocks=1, filters=16)
# no clock limit binds on a slow machine: searches end at their node target
NO_CLOCK = ["INFO timeout_turn 3600000", "INFO time_left 2000000000"]


@functools.lru_cache(maxsize=None)
def stub_tables(h: int, w: int):
    """The stub's fixed policy logits (a 0.25 grid) and value weights (in
    multiples of 1/8) for an h x w board: tests/test_torch_mcts.py's at 15x15."""
    base = ((np.random.default_rng(7).permutation(h * w) % 24) * 0.25).reshape(h, w)
    wv = np.random.default_rng(8).integers(-4, 5, size=(h, w)) / 8.0
    return base.astype(np.float32), wv.astype(np.float32)


def torch_stub(_, planes):
    base, wv = (torch.from_numpy(a) for a in stub_tables(*planes.shape[1:3]))
    p = planes.float()
    rows = (p[..., 1] + p[..., 2]).sum(2, keepdim=True)
    s = (p[..., 1] * wv).sum((1, 2)) - (p[..., 2] * wv).sum((1, 2))
    return NetOutput(
        policy_logits=base[None] + 0.25 * rows,
        value_logits=torch.stack([s, torch.zeros_like(s), -s], -1),
        q_logits=None, moves_left_logits=None, soft_policy_logits=None,
    )


def jax_stub(_, planes):
    import jax.numpy as jnp
    from alphagomoku_tpu.models.networks import NetOutput as JaxNetOutput

    base, wv = stub_tables(*planes.shape[1:3])
    p = planes.astype(jnp.float32)
    rows = (p[..., 1] + p[..., 2]).sum(2, keepdims=True)
    s = (p[..., 1] * wv).sum((1, 2)) - (p[..., 2] * wv).sum((1, 2))
    return JaxNetOutput(
        policy_logits=base[None] + 0.25 * rows,
        value_logits=jnp.stack([s, jnp.zeros_like(s), -s], -1),
        q_logits=None, moves_left_logits=None, soft_policy_logits=None,
    )


def board_lines(own, opp):
    """A Gomocup BOARD block: the engine's stones (1) and the opponent's (2)."""
    return (["BOARD"] + [f"{r},{c},1" for r, c in own] + [f"{r},{c},2" for r, c in opp]
            + ["DONE"])


REPLY = ("reply",)  # TURN with the most visited reply to the engine's last move
CASES = {
    # BEGIN on an empty board
    "begin": ("extended", ["START 15", *NO_CLOCK, "BEGIN"]),
    # the opponent's half-open four: the engine (cross) must play 7,7
    "block": ("extended", ["START 15", *NO_CLOCK, *board_lines(
        [(7, 2), (2, 2), (3, 3), (4, 4)], [(7, 3), (7, 4), (7, 5), (7, 6)])]),
    # two TURNs along the searched tree: both searches reuse it
    "reuse": ("extended", ["START 15", *NO_CLOCK, "BEGIN", REPLY, REPLY]),
    # a four chain the root VCF proves ("WIN in n"), and a double open
    # three that only the host VCT proves ("WIN (VCT)")
    "vcf": ("extended", ["START 15", *NO_CLOCK, *board_lines(
        [(7, 5), (7, 6), (7, 7), (9, 9), (10, 10)],
        [(7, 4), (0, 0), (0, 2), (14, 14), (14, 12)])]),
    "vct": ("extended", ["START 15", *NO_CLOCK, *board_lines(
        [(7, 6), (7, 7), (5, 8), (6, 8)], [(0, 0), (0, 2), (14, 14), (14, 12)])]),
    # renju: black's 3x3 fork at 7,7 for SHOWFORBID, with black and then
    # white to move
    "renju": ("extended", ["START 15", "INFO rule 4", *NO_CLOCK, "PLAY 7,5", "PLAY 0,0",
                           "PLAY 7,6", "PLAY 0,14", "PLAY 5,7", "PLAY 14,0", "PLAY 6,7",
                           "PLAY 14,14", "SHOWFORBID", "PLAY 12,12", "SHOWFORBID"]),
    # a 20x20 board
    "board20": ("extended", ["START 20", *NO_CLOCK, "BEGIN"]),
    # YixinBoard with the realtime stream over two chunks
    "yixin": ("yixin", ["START 15", *NO_CLOCK, "INFO max_node 32", "info show_detail 1",
                        "BEGIN"]),
}


def _reply(rec: dict) -> str:
    """The opponent's reply along the last search's tree: the most visited
    edge of the child the engine's move leads to."""
    ea, ec = rec["tree.edge_action"][0], rec["tree.edge_child"][0]
    nv, cols = rec["tree.node_visits"][0], int(rec["cols"])
    move = int(rec["best_move"][0]) * cols + int(rec["best_move"][1])
    child = int(ec[int(rec["root"]), list(ea[int(rec["root"])]).index(move)])
    visits = np.where(ec[child] >= 0, nv[np.clip(ec[child], 0, None)], -1)
    a = int(ea[child, int(visits.argmax())])
    return f"TURN {a // cols},{a % cols}"


def _record(engine, summary, cols: int) -> dict:
    """One search's observables as numpy arrays."""
    rec = {"best_move": np.array([summary.best_move.row, summary.best_move.col]),
           "simulations": np.array(summary.simulations), "nodes": np.array(summary.nodes),
           "pv": np.array([m.row * cols + m.col for m in summary.principal_variation] or [-1]),
           "proven": np.array(summary.proven), "expectation": np.array(summary.expectation,
                                                                        np.float32),
           "cols": np.array(cols)}
    if summary.simulations > 0:
        state = engine._last_state
        rec.update({f"tree.{n}": to_np(getattr(state.tree, n)).astype(np.int64) for n in EXACT})
        rec.update({f"tree.{n}": to_np(getattr(state.tree, n)).astype(np.float32)
                    for n in CLOSE})
        rec["root"] = np.array(int(to_np(state.root_node)[0]))
        rec["reuse_count"] = np.array(engine.reuse_count)
    return rec


def to_np(a) -> np.ndarray:
    """A tensor of either package as numpy (bf16 as f32)."""
    if isinstance(a, torch.Tensor):
        return (a.float() if a.dtype == torch.bfloat16 else a).cpu().numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _mask(line: str) -> str:
    return re.sub(r"n/s \d+ tm \d+", "n/s _ tm _", line)


def drive_case(name: str, manager_cls, engine_cls, **kw) -> dict:
    """Run CASES[name] through a ProgramManager, recording every search;
    returns the golden's dict: `lines` and `search<i>.<field>`."""
    proto, lines = CASES[name]
    out = io.StringIO()
    mgr = manager_cls(protocol=proto, simulations=SIMS, instream=None, outstream=out, **NET,
                      **kw)
    records = []
    orig = engine_cls.search

    def search(self, *a, **k):
        summary = orig(self, *a, **k)
        records.append(_record(self, summary, self.cols))
        return summary

    engine_cls.search = search
    try:
        # the lines up to each REPLY go in at once (a BOARD block reads on)
        for i, line in enumerate(lines):
            mgr.listener.push_line(_reply(records[-1]) if line is REPLY else line)
            if i + 1 == len(lines) or lines[i + 1] is REPLY:
                while not mgr.listener.is_empty():
                    mgr.run_once()
    finally:
        engine_cls.search = orig
    result = {"lines": np.array([_mask(x) for x in out.getvalue().splitlines()])}
    for i, rec in enumerate(records):
        result.update({f"search{i}.{k}": v for k, v in rec.items()})
    return result


def jax_engine_case(name: str) -> dict:
    """The JAX package's side of CASES[name] (the golden engine_<name>)."""
    from alphagomoku_tpu.engine import engine as JE
    from alphagomoku_tpu.engine import manager as JMGR

    orig = JE.Engine._apply
    JE.Engine._apply = lambda self, v, planes: jax_stub(v, planes)
    try:
        return drive_case(name, JMGR.ProgramManager, JE.Engine)
    finally:
        JE.Engine._apply = orig


def port_engine_case(name: str) -> dict:
    orig = TE.Engine._apply
    TE.Engine._apply = lambda self, v, planes: torch_stub(v, planes)
    try:
        return drive_case(name, TMGR.ProgramManager, TE.Engine, device="cpu")
    finally:
        TE.Engine._apply = orig


def compare(ref: dict, ours: dict) -> None:
    assert sorted(ours) == sorted(ref)
    for key, want in ref.items():
        got = ours[key]
        if key.endswith(CLOSE) or key.endswith("expectation"):
            assert np.allclose(got, want, rtol=1e-5, atol=0), key
        else:
            assert np.array_equal(got, want), (key, got, want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_engine_case_equals_jax(name):
    ref = torch_golden.load(f"engine_{name}")
    ours = port_engine_case(name)
    compare(ref, ours)
    searches = {k.split(".")[0] for k in ours if k.startswith("search")}
    if name == "block":
        assert tuple(ours["search0.best_move"]) == (7, 7)
    if name == "reuse":
        assert [int(ours[f"search{i}.reuse_count"]) for i in range(3)] == [0, 1, 2]
    if name == "vcf":
        assert str(ours["search0.proven"]).startswith("WIN in ")
    if name == "vct":
        assert str(ours["search0.proven"]) == "WIN (VCT)"
    if name == "renju":
        forbid = [x for x in ours["lines"] if x.startswith("FORBID")]
        assert "7,7" in forbid[0].split()
    if name == "yixin":
        assert any("REALTIME BEST" in x for x in ours["lines"])
    assert bool(searches) != (name == "renju")


# ---------------------------------------------------------------------------
# The real network
# ---------------------------------------------------------------------------

FLAGSHIP_POSITIONS = {
    # cross to move on an open four: the root VCF proves it
    "open_four": ([(7, 4), (7, 5), (7, 6), (7, 7)], [(9, 3), (9, 4), (9, 5)], {(7, 3), (7, 8)}),
    # circle's half-open four: cross must block, and the search runs
    "block": ([(7, 2), (2, 2), (3, 3), (4, 4)], [(7, 3), (7, 4), (7, 5), (7, 6)], {(7, 7)}),
}


def flagship_case(engine_cls, move_cls, **kw) -> dict:
    """Both flagship positions through an Engine with network_23 at 8 sims."""
    eng = engine_cls(checkpoint=str(CKPT), simulations=8, sim_chunk=8, **kw)
    out = {}
    for name, (own, opp, _) in FLAGSHIP_POSITIONS.items():
        eng.set_position([move_cls(r, c, CROSS) for r, c in own]
                         + [move_cls(r, c, CIRCLE) for r, c in opp])
        s = eng.search()
        out[f"{name}.best_move"] = np.array([s.best_move.row, s.best_move.col])
        out[f"{name}.proven"] = np.array(s.proven)
        out[f"{name}.simulations"] = np.array(s.simulations)
        if s.simulations:
            st = eng._last_state
            root = int(to_np(st.root_node)[0])
            out[f"{name}.root_score"] = np.array(int(to_np(st.tree.node_score)[0, root]))
    return out


def jax_engine_flagship() -> dict:
    from alphagomoku_tpu.engine import engine as JE
    from alphagomoku_tpu.game.types import Move as JMove

    return flagship_case(JE.Engine, JMove)


def test_flagship_engine_equals_jax():
    ref = torch_golden.load("engine_flagship")
    ours = flagship_case(TE.Engine, Move, device="cpu")
    assert sorted(ours) == sorted(ref)
    for key in ref:
        assert np.array_equal(ours[key], ref[key]), key
    for name, (_, _, wins) in FLAGSHIP_POSITIONS.items():
        assert tuple(ours[f"{name}.best_move"]) in wins
    assert int(ours["block.simulations"]) == 8


# ---------------------------------------------------------------------------
# The manager's other modes on the port (tests/test_engine.py,
# tests/test_yixin_realtime.py), with the stub network
# ---------------------------------------------------------------------------


@pytest.fixture
def stub_engine(monkeypatch):
    monkeypatch.setattr(TE.Engine, "_apply", lambda self, v, planes: torch_stub(v, planes))


def small_manager(protocol="extended", rows=9):
    out = io.StringIO()
    mgr = TMGR.ProgramManager(protocol=protocol, simulations=8, instream=None, outstream=out,
                              device="cpu", **NET)
    mgr.options["rows"] = mgr.options["columns"] = str(rows)
    mgr.options["time_for_turn"] = "30000"
    mgr.options["time_left"] = "30000"
    return mgr, out


def drive(mgr, *lines):
    for line in lines:
        mgr.listener.push_line(line)
    out: list[str] = []
    orig = mgr.sender._sink
    mgr.sender._sink = out.append
    try:
        while not mgr.listener.is_empty():
            mgr.run_once()
    finally:
        mgr.sender._sink = orig
    return out


def answers(out):
    return [x for x in out if "," in x and not x.startswith(("MESSAGE", "ERROR"))]


def test_swap5_swap1st_rif_and_evaluate(stub_engine):
    """swap5 / swap1st / rif / info evaluate through the manager
    (tests/test_yixin_realtime.py's ProgramManager cases)."""
    mgr, out = small_manager()
    mgr.process_message(Message(MessageType.SET_POSITION, []))
    mgr.process_message(Message(MessageType.START_SEARCH, "swap5"))
    mgr.protocol.process_output(mgr.sender)
    assert re.search(r"^\d+,\d+$", out.getvalue(), re.M)
    out.truncate(0), out.seek(0)
    mgr.process_message(Message(MessageType.SET_POSITION, [Move(4, 4, CROSS)]))
    mgr.process_message(Message(MessageType.START_SEARCH, "swap1st"))
    mgr.protocol.process_output(mgr.sender)
    assert "SWAP" in out.getvalue() or re.search(r"^\d+,\d+$", out.getvalue(), re.M)
    out.truncate(0), out.seek(0)
    mgr.process_message(Message(MessageType.START_SEARCH, "rif"))
    mgr.protocol.process_output(mgr.sender)
    assert "not supported" in out.getvalue()
    mgr.process_message(Message(MessageType.START_SEARCH, "bestmove"))
    out.truncate(0), out.seek(0)
    acts = mgr.engine._last_root["actions"]
    a = int(acts[acts >= 0][0])
    mgr.process_message(Message(MessageType.START_SEARCH, f"evaluate {a // 9},{a % 9}"))
    mgr.protocol.process_output(mgr.sender)
    assert re.search(r"MESSAGE ev (\d+\.\d+%|WIN|LOSS|DRAW)", out.getvalue()), out.getvalue()


def test_ponder_stop_and_turn(stub_engine):
    """Background pondering (a search in another thread, under that
    thread's own grad mode) stops on STOP; the engine plays on."""
    import time

    mgr, _ = small_manager(rows=15)
    drive(mgr, "START 15")
    drive(mgr, "PONDER")
    time.sleep(0.5)
    assert mgr._bg_search is not None
    drive(mgr, "STOP")
    assert mgr._bg_search is None
    assert len(answers(drive(mgr, "TURN 3,3"))) == 1


def test_showforbid_and_swap2_book(stub_engine, tmp_path):
    import json

    mgr, _ = small_manager(rows=15)
    drive(mgr, "START 15", "INFO rule 4", "PLAY 7,5", "PLAY 0,0", "PLAY 7,6", "PLAY 0,14",
          "PLAY 5,7", "PLAY 14,0", "PLAY 6,7", "PLAY 14,14")
    forbid = [x for x in drive(mgr, "SHOWFORBID") if x.startswith("FORBID")]
    assert "7,7" in forbid[0].split()
    book = [[{"row": 7, "col": 7, "sign": "CROSS"}, {"row": 8, "col": 8, "sign": "CIRCLE"},
             {"row": 9, "col": 7, "sign": "CROSS"}]]
    path = tmp_path / "book.json"
    path.write_text(json.dumps(book))
    drive(mgr, "START 15", "INFO rule 0", f"INFO swap2_openings_file {path}")
    assert answers(drive(mgr, "SWAP2BOARD", "DONE"))[0].split() == ["7,7", "8,8", "9,7"]


@pytest.mark.parametrize("expectation,answer", [(0.2, "SWAP"), (0.5, 2), (0.8, 1)])
def test_swap2_three_stones(stub_engine, monkeypatch, expectation, answer):
    """The swap2 decision at 3 stones on the search's expectation: SWAP,
    two balancing stones, or one move (Swap2Controller.cpp:72-131)."""
    def fake_search(self, time_budget=None, selector="best", on_chunk=None,
                    max_simulations=None):
        taken = {(m.row, m.col) for m in self.moves}
        cell = next((r, c) for r in range(self.rows) for c in range(self.cols)
                    if (r, c) not in taken)
        return TE.SearchSummary(Move(*cell, self.sign_to_move()), expectation, expectation,
                                0.0, 1, 1, 0.0, [], "")

    mgr, _ = small_manager(rows=15)
    drive(mgr, "START 15")
    monkeypatch.setattr(TE.Engine, "search", fake_search)
    out = drive(mgr, "SWAP2BOARD", "7,7", "8,8", "9,7", "DONE")
    if answer == "SWAP":
        assert "SWAP" in out
    else:
        assert len(answers(out)) == 1 and len(answers(out)[0].split()) == answer


def test_solver_budget_tuner_brackets():
    t = TE.SolverBudgetTuner(cap=128, step=2, cap_max=1024, cap_min=32)
    for _ in range(40):
        t.record(100.0 if t.current == t.lower.param_value else 150.0)
        if t.lower.param_value > 128:
            break
    assert (t.lower.param_value, t.upper.param_value) == (256, 512)


# ---------------------------------------------------------------------------
# The port's own entry points
# ---------------------------------------------------------------------------


def test_entry_points_default_to_the_card(monkeypatch):
    import inspect

    from alphagomoku_tpu_torch.utils import selfcheck

    for fn in (TE.Engine.__init__, TMGR.ProgramManager.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    parser_default = re.search(r'"--device", default="(\w+)"',
                               Path(TMGR.__file__).read_text()).group(1)
    assert parser_default == "cuda"
    # --selfcheck runs the checks on the launcher's device (the card by
    # default) and exits 0 when they pass (tests/test_torch_selfcheck.py
    # runs them)
    seen = []
    monkeypatch.setattr(selfcheck, "run_selfcheck", lambda **kw: seen.append(kw) or True)
    with pytest.raises(SystemExit) as exit_:
        TMGR.main(["--selfcheck"])
    assert exit_.value.code == 0 and seen == [{"device": "cuda"}]


def test_checkpoint_of_another_board_size_raises():
    with pytest.raises(ValueError, match="20x20"):
        TE.Engine(rows=20, cols=20, checkpoint=str(CKPT), simulations=8, device="cpu")


def test_trunk_kernel_at_128_on_20x20_raises():
    from alphagomoku_tpu_torch.ops import convnext_fused as CF

    x = torch.zeros((1, 20, 20, 128), dtype=torch.bfloat16, device="meta")
    with pytest.raises(NotImplementedError, match="ROADMAP.md, 'TPU kernels to port', entry 2"):
        CF.fused_trunk(x, None)
    assert CF.trunk_smem_bytes(64, 20, 20) == 146304 <= CF.SM90_SMEM_OPTIN
    assert CF.trunk_smem_bytes(128, 20, 20) == 312576 > CF.SM90_SMEM_OPTIN


def test_benchmark_and_config(tmp_path):
    from alphagomoku_tpu_torch.engine import benchmark as TB

    report = TB.run_benchmark(blocks=1, filters=16, seconds_per_point=0.01,
                              output_path=str(tmp_path / "benchmark.json"), batch_sizes=(1, 2),
                              device="cpu")
    assert [r["batch_size"] for r in report["results"]] == [1, 2]
    cfg = TB.create_config(str(tmp_path / "benchmark.json"), str(tmp_path / "config.json"))
    assert cfg["search_batch_size"] in (1, 2) and (tmp_path / "config.json").exists()
