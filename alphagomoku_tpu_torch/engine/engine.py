"""Search engine facade: position state + batch-1 search + summaries.

Port of the reference package's `engine/engine.py` (reference:
src/player/SearchEngine.cpp, SearchThread.cpp): the multi-threaded
shared-tree search collapses to repeated calls of the batched search
(batch 1 for protocol play), with the simulation budget grown chunk-wise
so time controls can stop between chunks (the reference grows its batch as
sqrt(simulations), SearchThread.cpp:23-27).  Where the reference package
scans `sim_chunk` jitted steps, the port calls its simulation step
`sim_chunk` times; the root score is read once a chunk.

The network is `models.networks.create_network`, loaded from the flax
checkpoint with the port's reader (`utils/checkpoint.py`), of any
architecture of the zoo, and the searches evaluate it through
`models.forward.network_apply`: the trunk kernel on the card for the
convnext trunk (`fused_apply` on a `pack_weights` snapshot), the module's
own forward on a snapshot for every other trunk.
`Engine._apply(variables, planes)` is the one seam through which the
network is called.

Known difference: without a checkpoint the reference package initialises
its network from `jax.random.PRNGKey(seed)`, which torch cannot reproduce;
the port draws its own seeded weights (`models.networks.init_random_` from
a `torch.Generator` seeded with `seed`).  A checkpoint trained for another
board size does not load (its moves-left head has rows * cols buckets, a
transformer block's positional embedding rows * cols tokens): the port
raises ValueError at construction, where the reference package fails at
its first search.

Threads: `ProgramManager` searches in a background thread for ponder and
analysis.  torch's grad mode is thread-local, so `search` enters
`torch.no_grad()` itself; the CUDA stream is thread-local too, and every
thread of the engine runs on its device's default stream.
"""

from __future__ import annotations

import time
from math import erf, sqrt
from typing import NamedTuple

import numpy as np
import torch

from ..game import board as board_mod
from ..game import vectorized as V
from ..game.types import CROSS, Move, GameRules, invert_sign
from ..models.convert import from_flax
from ..models.forward import network_apply
from ..models.networks import create_network, init_random_
from ..search import mcts, selectors, vcf
from ..search import vct as VCT
from ..search import score as S
from ..utils import checkpoint as CK


class SearchSummary(NamedTuple):
    """(reference: player/SearchEngine.hpp SearchSummary)"""

    best_move: Move
    expectation: float
    win_rate: float
    draw_rate: float
    simulations: int
    nodes: int
    time_used: float
    principal_variation: list[Move]
    proven: str  # "", "WIN", "LOSS", "DRAW"
    stats: dict | None = None  # per-phase counters (reference: SearchStats
    # printed by SearchEngine::logSearchInfo, Search.hpp:33-54)


class Measurement:
    """Sliding window of (step, speed) samples with linear-regression
    prediction (reference: ThreatSpaceSearch Measurement,
    src/search/alpha_beta/ThreatSpaceSearch.cpp:80-117)."""

    def __init__(self, param_value: int):
        self.param_value = int(param_value)
        self.values: list[tuple[int, float]] = []

    def update(self, x: int, y: float) -> None:
        if len(self.values) >= 10:
            self.values.pop(0)
        self.values.append((x, y))

    def predict(self, x: int) -> tuple[float, float]:
        if len(self.values) < 5:
            return 0.0, 1.0e6
        xs = np.asarray([v[0] for v in self.values], np.float64)
        ys = np.asarray([v[1] for v in self.values], np.float64)
        n = len(xs)
        mx, my = xs.mean(), ys.mean()
        sxx = ((xs - mx) ** 2).sum()
        slope = ((xs - mx) * (ys - my)).sum() / max(sxx, 1e-9)
        intercept = my - slope * mx
        resid = ys - (intercept + slope * xs)
        var = (resid ** 2).sum() / max(n - 2, 1)
        pred_var = var * (1.0 / n + (x - mx) ** 2 / max(sxx, 1e-9))
        return float(intercept + slope * x), float(np.sqrt(max(pred_var, 0.0)))


class SolverBudgetTuner:
    """Online self-tuning of the leaf-solver width cap for SPEED
    (reference: ThreatSpaceSearch::tune, ThreatSpaceSearch.cpp:243-307 —
    shipped there without a caller; wired here into Engine.search).

    Alternates searches between a lower cap and `step x` that cap, feeds
    each measured speed into that cap's regression, and doubles/halves the
    bracket when the regression says the larger cap is faster with >95%
    (or <5%) confidence."""

    def __init__(self, cap: int, step: int = 2, cap_max: int = 2048,
                 cap_min: int = 32):
        self.step = int(step)
        self.cap_max = int(cap_max)
        self.cap_min = int(cap_min)
        self.lower = Measurement(cap)
        self.upper = Measurement(self.step * cap)
        self.current = cap
        self.counter = 0

    def record(self, speed: float) -> int:
        """Feed the speed measured at `self.current`; returns the cap the
        NEXT search should use."""
        if self.current == self.lower.param_value:
            self.lower.update(self.counter, speed)
            self.current = self.upper.param_value
        else:
            self.upper.update(self.counter, speed)
            self.current = self.lower.param_value
        self.counter += 1
        lo_m, lo_s = self.lower.predict(self.counter)
        up_m, up_s = self.upper.predict(self.counter)
        mean = lo_m - up_m
        stddev = float(np.hypot(lo_s, up_s))
        probability = 1.0 - 0.5 * (1.0 + erf(mean / max(stddev, 1e-9) / sqrt(2)))
        if probability > 0.95 and self.lower.param_value * self.step <= self.cap_max:
            new_cap = self.step * self.lower.param_value
            self.lower = Measurement(new_cap)
            self.upper = Measurement(self.step * new_cap)
            self.current = new_cap
        elif probability < 0.05 and self.lower.param_value // self.step >= self.cap_min:
            new_cap = self.lower.param_value // self.step
            self.lower = Measurement(new_cap)
            self.upper = Measurement(self.step * new_cap)
            self.current = new_cap
        return self.current


def load_network(architecture: str, blocks: int, filters: int, rows: int, cols: int,
                 checkpoint: str | None, seed: int):
    """The engine's network on the CPU: the flax checkpoint's weights, or
    seeded ones (`init_random_`) without a checkpoint."""
    net = create_network(architecture, blocks, filters, rows, cols)
    if not checkpoint:
        return init_random_(net, torch.Generator().manual_seed(seed)).eval()
    state = from_flax(CK.load(checkpoint))
    own = net.state_dict()
    wrong = [k for k, v in state.items() if k in own and tuple(v.shape) != tuple(own[k].shape)]
    if wrong:
        raise ValueError(
            f"checkpoint {checkpoint} does not fit a {rows}x{cols} board: {wrong[0]} has shape "
            f"{tuple(state[wrong[0]].shape)}, the network needs {tuple(own[wrong[0]].shape)} "
            "(the moves-left head has rows * cols buckets, a transformer block's "
            "positional embedding rows * cols tokens)")
    net.load_state_dict(state)
    return net.eval()


class Engine:
    """One playing engine instance."""

    def __init__(
        self,
        rules: GameRules = GameRules.FREESTYLE,
        rows: int = 15,
        cols: int = 15,
        architecture: str = "ConvNextPVQMraw",
        blocks: int = 6,
        filters: int = 64,
        checkpoint: str | None = None,
        simulations: int = 400,
        sim_chunk: int = 50,
        seed: int = 0,
        leaf_solver: str = "vct",
        leaf_solver_steps: int = 16,
        max_memory: int | None = None,
        max_depth: int | None = None,
        draw_after: int = 0,
        solver_tuning: bool = False,
        device: str | torch.device = "cuda",
    ):
        self.rules = rules
        self.rows, self.cols = rows, cols
        self.device = torch.device(device)
        self.simulations = simulations
        self.sim_chunk = min(sim_chunk, simulations)
        self.tables = V.device_tables(rules)
        self.net = load_network(architecture, blocks, filters, rows, cols, checkpoint,
                                seed).to(self.device)
        self._forward, self.variables = network_apply(self.net)
        self.moves: list[Move] = []
        # capacity 3x the per-move budget leaves headroom to carry the
        # subtree across moves (reference: NodeCache tree reuse); an engine
        # memory budget caps it (reference: EngineSettings max_memory ->
        # tree/cache size, EngineSettings.hpp:58)
        capacity = 3 * simulations + 8
        if max_memory is not None and max_memory > 0:
            k = 32
            bytes_per_node = 27 + k * 22  # struct-of-arrays row footprint
            capacity = max(64, min(capacity, max_memory // bytes_per_node))
        self._mcfg = mcts.MCTSConfig(
            max_nodes=capacity, max_edges=32,
            max_depth=min(40, max_depth) if max_depth else 40,
            leaf_solver=leaf_solver, leaf_solver_steps=leaf_solver_steps,
            draw_after=draw_after,
        )
        self._last_state: mcts.SearchState | None = None
        self._last_moves: list[Move] = []
        self.reuse_count = 0
        # online solver-budget self-tuning (reference:
        # ThreatSpaceSearch::tune — measure speed at two cap values,
        # regress, shift the bracket)
        self._tuner = (
            SolverBudgetTuner(self._mcfg.leaf_solver_cap or 256)
            if solver_tuning and leaf_solver != "none" else None
        )
        self._simulate = self._make_simulate()
        self._stop_requested = False
        # seconds of the last search's stages: root VCF, host VCT, root
        # init (or tree reuse) and the simulation chunks
        self.last_timings: dict[str, float] = {}

    # -- the network seam and the search pieces ---------------------------

    def _apply(self, v, planes):
        return self._forward(v, planes)

    def _net_apply(self, v, planes):
        return self._apply(v, planes)  # looked up at call time: tests patch _apply

    def _make_simulate(self):
        return mcts.make_simulate_fn(self._net_apply, self.tables, self._mcfg,
                                     self.net.cfg.raw_input)

    def _init(self, board, stm) -> mcts.SearchState:
        return mcts.init_root(self._net_apply, self.variables, self.tables, self._mcfg, board,
                              stm, self.net.cfg.raw_input, self.device)

    def _chunk(self, state: mcts.SearchState) -> mcts.SearchState:
        for _ in range(self.sim_chunk):
            state = self._simulate(self.variables, state)
        return state

    # -- position management ----------------------------------------------

    def set_position(self, moves: list[Move]) -> None:
        self.moves = list(moves)

    def make_move(self, move: Move) -> None:
        self.moves.append(move)

    def board_array(self) -> np.ndarray:
        board = np.zeros((self.rows, self.cols), np.int8)
        for m in self.moves:
            board[m.row, m.col] = m.sign
        return board

    def sign_to_move(self) -> int:
        if not self.moves:
            return CROSS
        return invert_sign(self.moves[-1].sign)

    def stop(self) -> None:
        self._stop_requested = True

    # -- search ------------------------------------------------------------

    def search(
        self,
        time_budget: float | None = None,
        selector: str = "best",
        on_chunk=None,
        max_simulations: int | None = None,
    ) -> SearchSummary:
        """Run the search on the current position.

        Chunks of `sim_chunk` simulations run until the simulation target,
        the time budget, or a proven root stops the search (reference stop
        conditions: SearchThread.cpp:181-222)."""
        with torch.no_grad():
            return self._search(time_budget, selector, on_chunk, max_simulations)

    def _search(self, time_budget, selector, on_chunk, max_simulations) -> SearchSummary:
        self._stop_requested = False
        t0 = time.monotonic()
        timings = self.last_timings = {}
        host_board = self.board_array()
        board = torch.from_numpy(host_board[None]).to(self.device)
        stm_val = self.sign_to_move()
        stm = torch.full((1,), stm_val, dtype=torch.int8, device=self.device)

        # root pre-solve: a proven VCF line short-circuits the tree search
        # (reference: AlphaBetaSearch::solve before NN scheduling,
        # Search.cpp:159-183)
        res = vcf.solve(self.tables, board, stm, max_depth=10, max_steps=192)
        win, mv, dist = (int(x) for x in
                         torch.stack([res.win.int(), res.best_move, res.distance], -1)[0].tolist())
        timings["vcf"] = time.monotonic() - t0
        if win:
            return SearchSummary(
                best_move=Move(row=mv // self.cols, col=mv % self.cols, sign=stm_val),
                expectation=1.0,
                win_rate=1.0,
                draw_rate=0.0,
                simulations=0,
                nodes=0,
                time_used=time.monotonic() - t0,
                principal_variation=[],
                proven=f"WIN in {dist}",
            )
        # deeper host VCT (open-three forcing lines with complete defender
        # sets; reference: ThreatSpaceSearch), bounded by a node budget
        t1 = time.monotonic()
        vres = VCT.solve(host_board, stm_val, self.rules, max_depth=8, node_budget=8000)
        timings["vct"] = time.monotonic() - t1
        if vres.win and vres.best_move is not None:
            r, c = vres.best_move
            return SearchSummary(
                best_move=Move(row=r, col=c, sign=stm_val),
                expectation=1.0,
                win_rate=1.0,
                draw_rate=0.0,
                simulations=0,
                nodes=vres.nodes,
                time_used=time.monotonic() - t0,
                principal_variation=[],
                proven="WIN (VCT)",
            )

        if self._tuner is not None:
            cap = self._tuner.current
            if cap != self._mcfg.leaf_solver_cap:
                self._mcfg = self._mcfg._replace(leaf_solver_cap=cap)
                self._simulate = self._make_simulate()
                self._last_state = None  # tree built under another config
        t1 = time.monotonic()
        state = self._warm_start(board, stm)
        if state is None:
            state = self._init(board, stm)
        timings["init"] = time.monotonic() - t1
        sims = 0
        t_sims = time.monotonic()
        target = max_simulations if max_simulations is not None else self.simulations
        while sims < target:
            state = self._chunk(state)
            sims += self.sim_chunk
            if on_chunk is not None:
                on_chunk(
                    self._summarize(
                        state, stm_val, sims, time.monotonic() - t0, selector
                    )
                )
            # the one host read of a chunk: the root's packed score
            if S.is_proven(state.tree.node_score[0, state.root_node[0]].cpu()):
                break
            if time_budget is not None and time.monotonic() - t0 > time_budget:
                break
            if self._stop_requested:
                break
        timings["simulate"] = time.monotonic() - t_sims
        timings["steps"] = sims
        self._last_state = state
        self._last_moves = list(self.moves)
        if self._tuner is not None and sims > 0:
            dt = max(time.monotonic() - t_sims, 1e-6)
            self._tuner.record(sims / dt)
        return self._summarize(state, stm_val, sims, time.monotonic() - t0, selector)

    def _warm_start(self, board, stm) -> "mcts.SearchState | None":
        """Carry the previous search's subtree when the position advanced by
        one or two plies along explored edges (reference: Tree::setBoard +
        NodeCache::cleanup subtree reuse, Tree.cpp:128-151).  The tree's
        tensors are taken over, and updated in place by the next search."""
        prev_state, prev_moves = self._last_state, self._last_moves
        if prev_state is None:
            return None
        delta = len(self.moves) - len(prev_moves)
        if not (1 <= delta <= 2) or self.moves[: len(prev_moves)] != prev_moves:
            return None
        tree = prev_state.tree
        count = int(tree.node_count[0])
        if count + self.simulations > tree.capacity:
            return None
        node = int(prev_state.root_node[0])
        actions_all = tree.edge_action[0].cpu().numpy()
        children_all = tree.edge_child[0].cpu().numpy()
        for m in self.moves[len(prev_moves) :]:
            a = m.row * self.cols + m.col
            slots = np.where(actions_all[node] == a)[0]
            if len(slots) == 0:
                return None
            child = int(children_all[node, slots[0]])
            if child < 0:
                return None
            node = child
        self.reuse_count += 1
        dev = board.device
        return mcts.SearchState(
            tree=tree,
            root_board=board,
            root_stm=stm,
            root_node=torch.full((1,), node, dtype=torch.int64, device=dev),
            noisy_prior=tree.edge_prior[0:1, node].float(),
            sims_done=torch.zeros(1, dtype=torch.int32, device=dev),
            stats=mcts.SearchStats.zeros(1, dev),
            frontier=count,
        )

    def _summarize(
        self,
        state: mcts.SearchState,
        stm: int,
        sims: int,
        dt: float,
        selector: str = "best",
    ) -> SearchSummary:
        # keep root statistics for search-info dumps (reference:
        # SearchEngine::logSearchInfo, SearchEngine.cpp:149-241)
        tree = state.tree
        root_t = state.root_node[:1]
        es = mcts.edge_stats(tree, torch.zeros_like(root_t), root_t)
        host = lambda t: t[0].cpu().numpy()
        visits0 = host(es.visits)
        self._last_root = {
            "actions": tree.edge_action[0, root_t[0]].cpu().numpy(),
            "visits": visits0,
            # (win, draw) sums reconstructed from the derived rates for the
            # search-info dumps
            "vsum": np.stack([host(es.q_win), host(es.q_draw)], -1) * visits0[:, None],
            "prior": tree.edge_prior[0, root_t[0]].float().cpu().numpy(),
            # packed scores, 16-bit values zero-extended into int32
            "escore": host(es.score),
        }
        move_flat = int(selectors.select(state, selector)[0])
        r, c = move_flat // self.cols, move_flat % self.cols
        val = mcts.root_value(state)[0].cpu().numpy()
        nodes = int(tree.node_count[0])
        root_score = int(tree.node_score[0, root_t[0]])
        pv_names = {0: "LOSS", 1: "DRAW", 3: "WIN"}
        proven = ""
        if S.is_proven(torch.tensor(root_score)):  # zero-extended 16-bit score
            proven = pv_names.get(root_score >> 13, "")
        pv = self._principal_variation(state)
        return SearchSummary(
            best_move=Move(row=r, col=c, sign=stm),
            expectation=float(val[0] + 0.5 * val[1]),
            win_rate=float(val[0]),
            draw_rate=float(val[1]),
            simulations=sims,
            nodes=nodes,
            time_used=dt,
            principal_variation=pv,
            proven=proven,
            stats=state.stats.summary(state.sims_done),
        )

    def _principal_variation(
        self, state: mcts.SearchState, max_len: int = 10
    ) -> list[Move]:
        """Walk max-visit edges down the tree
        (reference: SearchEngine::getSummary PV extraction via
        BestEdgeSelector, SearchEngine.cpp:243-270)."""
        tree = state.tree
        ea = tree.edge_action[0].cpu().numpy()
        ec = tree.edge_child[0].cpu().numpy()
        # edge visits are the child nodes' visits (see Tree docstring)
        nv = tree.node_visits[0].cpu().numpy()
        ev = np.where(ec >= 0, nv[np.clip(ec, 0, len(nv) - 1)], 0)
        pv: list[Move] = []
        node = int(state.root_node[0])
        sign = self.sign_to_move()
        for _ in range(max_len):
            valid = ea[node] >= 0
            if not valid.any() or ev[node].sum() == 0:
                break
            slot = int(np.where(valid, ev[node], -1).argmax())
            a = int(ea[node, slot])
            pv.append(Move(row=a // self.cols, col=a % self.cols, sign=sign))
            sign = invert_sign(sign)
            child = int(ec[node, slot])
            if child < 0:
                break
            node = child
        return pv

    def search_info_text(self, summary: SearchSummary) -> str:
        """Post-search dump: board diagram, top edges, PV
        (reference: SearchEngine::logSearchInfo ASCII dumps,
        SearchEngine.cpp:149-241)."""
        lines = [board_mod.to_string(self.board_array())]
        lines.append(
            f"best {summary.best_move.text()}  ev {summary.expectation:.3f} "
            f"(w {summary.win_rate:.3f} d {summary.draw_rate:.3f})  "
            f"sims {summary.simulations}  nodes {summary.nodes}  "
            f"time {summary.time_used:.2f}s  {summary.proven}"
        )
        root = getattr(self, "_last_root", None)
        if root is not None:
            order = np.argsort(-root["visits"])[:10]
            rows = []
            for i in order:
                a = int(root["actions"][i])
                if a < 0:
                    continue
                n = float(root["visits"][i])
                q = (
                    (root["vsum"][i, 0] + 0.5 * root["vsum"][i, 1]) / n
                    if n > 0
                    else 0.0
                )
                mv = Move(row=a // self.cols, col=a % self.cols, sign=0)
                rows.append(
                    f"  {mv.text()[1:]:>4s}  N={int(n):6d}  Q={q:.3f}  "
                    f"P={float(root['prior'][i]):.3f}"
                )
            lines.append("top edges:")
            lines.extend(rows)
        if summary.principal_variation:
            lines.append("pv: " + " ".join(m.text() for m in summary.principal_variation))
        if summary.stats:
            s = summary.stats
            lines.append(
                "stats: depth {avg_depth:.1f}  expand {expansions:.0f}  "
                "transp {transpositions:.0f}  dup {duplicates:.0f}  "
                "proven {proven_revisits:.0f}  term {terminals:.0f}  "
                "solver {solver_wins:.0f}".format(**s)
            )
        return "\n".join(lines)

    def realtime_snapshot(self) -> dict | None:
        """Root-edge snapshot for the YixinBoard realtime analysis stream:
        the considered moves, the proven-loss moves, and the LCB-selected
        best (reference: YixinBoardProtocol::process_realtime_info,
        YixinBoardProtocol.cpp:758-795 — LCBSelector at c=0.2)."""
        root = getattr(self, "_last_root", None)
        if root is None:
            return None
        actions = root["actions"].astype(np.int32)
        valid = actions >= 0
        if not valid.any():
            return None
        visits = root["visits"].astype(np.float64)
        q = np.where(
            visits > 0,
            (root["vsum"][:, 0] + 0.5 * root["vsum"][:, 1]) / np.maximum(visits, 1.0),
            0.0,
        )
        escore = root["escore"].astype(np.int64)  # zero-extended 16-bit scores
        # packed ProvenValue LOSS, excluding the +-inf sentinels
        is_loss = ((escore >> 13) == 0) & (escore != 0x0000) & (escore != 0xFFFF)
        n_parent = max(visits.sum(), 1.0)
        lcb = q - 0.2 * np.sqrt(np.log(n_parent) / (1.0 + visits))
        lcb = np.where(is_loss, -1e6, lcb)
        lcb = np.where(valid & (visits > 0), lcb, -np.inf)
        best = int(actions[int(np.argmax(lcb))]) if np.isfinite(lcb).any() else int(
            actions[np.argmax(np.where(valid, visits, -1))]
        )
        to_rc = lambda a: (int(a) // self.cols, int(a) % self.cols)
        return {
            "edges": [to_rc(a) for a in actions[valid]],
            "losing": [to_rc(a) for a in actions[valid & is_loss]],
            "best": to_rc(best),
        }

    def forbidden_moves(self) -> list[Move]:
        """Renju forbidden cells of the current position (for SHOWFORBID,
        reference: ExtendedGomocupProtocol SHOWFORBID + YixinBoard
        yxshowforbid)."""
        if self.rules != GameRules.RENJU:
            return []
        board = torch.from_numpy(self.board_array()[None]).to(self.device)
        with torch.no_grad():
            plane = V.forbidden_plane(self.tables, board)[0].cpu().numpy()
        return [
            Move(row=int(r), col=int(c), sign=CROSS)
            for r, c in zip(*np.nonzero(plane))
        ]
