"""Lockstep batched self-play: a `[B]` batch of games stepped together, one
MCTS search per move for the whole batch, the samples recorded on the
device.

Port of the reference package's `selfplay/selfplay.py` (reference:
src/selfplay/{GeneratorManager,GeneratorThread,GameGenerator}.cpp): the
per-game coroutines multiplexed onto one network evaluator become a batch
of environments advanced in lockstep.  Sample layout mirrors
`SearchDataPack` (reference: dataset/data_packs.cpp:24-43): board, side to
move, per-cell visit distribution, per-cell action values (from root
edges), root value, played move, and the final game outcome backfilled
into the targets.

Random numbers: each move takes its root noise [B, K] and its Gumbel draw
[B, K] for the temperature sampling (`MoveDraws`), drawn from a
`torch.Generator` on the search's device in that order (`draw_move`), or
given by the caller per move (`draws`, indexed by the move number), so
that the same draws give the same games.

Where the reference package plays every one of `max_moves` moves, the
port stops searching once every game of the batch has ended (one host
sync per move): each later move's record is `dead_record`, which holds the
frozen board and side to move, `alive=False` and zeros elsewhere, fields
that `make_targets` masks out (`valid` is False).
"""

from __future__ import annotations

import os
from typing import Any, Callable, NamedTuple, Sequence

import numpy as np
import torch

from ..game.types import CROSS, CIRCLE, GameOutcome
from ..game import vectorized as V
from ..search import mcts


class SelfplayConfig(NamedTuple):
    """(reference: utils/configs.hpp SelfplayConfig + GameConfig); the
    reference package's fields and defaults."""

    num_simulations: int = 100
    temperature_moves: int = 10  # sample by visits for the first N plies
    temperature: float = 1.0
    noise_weight: float = 0.25
    noise_alpha: float = 0.1
    max_moves: int = 128  # plies played; longer games are truncated
    tree_reuse: bool = False  # carry the played child's subtree between
    # moves (reference: Tree::setBoard + NodeCache::cleanup carry-over,
    # Tree.cpp:128-151); needs mcfg.max_nodes headroom beyond one search
    draw_after: int = 0  # adjudicate a draw after this many stones
    # (reference: GameConfig::draw_after); 0 = board area


class GameRecord(NamedTuple):
    """One move's training sample, [B, ...]; stacked to [M, B, ...]."""

    board: torch.Tensor  # [M, B, H, W] int8 (position BEFORE the move)
    stm: torch.Tensor  # [M, B] int8 side to move
    visit_dist: torch.Tensor  # [M, B, H, W] f32 root visit distribution
    q_value: torch.Tensor  # [M, B, H, W, 2] f32 root edge (win, draw)
    q_mask: torch.Tensor  # [M, B, H, W] bool visited-edge mask
    root_value: torch.Tensor  # [M, B, 2] f32
    move: torch.Tensor  # [M, B] int16 flat action
    alive: torch.Tensor  # [M, B] bool sample validity
    phase_counters: torch.Tensor  # [M, 8] f32: batch-summed per-move search
    # counters [depth_sum, expansions, transpositions, duplicates,
    # proven_revisits, terminals, solver_wins, sims] (reference:
    # GeneratorManager.cpp:219-239, Search.hpp:33-54)


class SelfplayResult(NamedTuple):
    record: GameRecord
    outcome: torch.Tensor  # [B] int8 final GameOutcome (UNKNOWN if truncated)
    game_length: torch.Tensor  # [B] int32 stones on the final board


class PlayCarry(NamedTuple):
    """Carry of lockstep self-play between moves: env + previous search
    (for tree reuse) + the move that produced the current position."""

    env: V.EnvState
    search: mcts.SearchState
    prev_move: torch.Tensor  # [B] int32, -1 before the first search


class MoveDraws(NamedTuple):
    """The random numbers of one move."""

    noise: torch.Tensor  # [B, K] root noise (`mcts.sample_root_noise`)
    gumbel: torch.Tensor  # [B, K] Gumbel draw of the temperature sampling


def draw_move(mcfg: mcts.MCTSConfig, batch: int, generator: torch.Generator) -> MoveDraws:
    """One move's draws from `generator`: the root noise, then the Gumbel
    draw."""
    noise = mcts.sample_root_noise(mcfg, batch, generator)
    return MoveDraws(noise, mcts.sample_gumbel((batch, mcfg.max_edges), generator))


def _root_q(state: mcts.SearchState):
    """Per-cell root action values [B, H, W, 2] + mask [B, H, W] from the K
    root edges."""
    tree = state.tree
    bsz = tree.batch
    h, w = state.root_board.shape[1], state.root_board.shape[2]
    rb = torch.arange(bsz, device=state.root_board.device)
    actions = tree.edge_action[rb, state.root_node]
    es = mcts.edge_stats(tree, rb, state.root_node)
    valid = (actions != mcts.NULL) & (es.visits > 0)
    q = torch.stack([es.q_win, es.q_draw], dim=-1)
    idx = actions.long().clamp(0, h * w - 1)
    qmap = torch.zeros((bsz, h * w, 2), dtype=torch.float32, device=rb.device)
    qmap.scatter_add_(1, idx[..., None].expand(-1, -1, 2), torch.where(valid[..., None], q, 0.0))
    mmap = torch.zeros((bsz, h * w), dtype=torch.int32, device=rb.device)
    mmap.scatter_add_(1, idx, valid.int())
    return qmap.reshape(bsz, h, w, 2), (mmap > 0).reshape(bsz, h, w)


def init_carry(
    net_apply: Callable, variables: Any, tables: V.RuleTables, mcfg: mcts.MCTSConfig,
    batch: int, rows: int, cols: int, init_env: V.EnvState | None = None, device="cuda",
) -> PlayCarry:
    """Fresh carry on `device` (or `init_env`'s); `init_env` seeds games
    from prepared openings (reference: GameGenerator PREPARE_OPENING,
    GameGenerator.cpp:60-75)."""
    env = init_env if init_env is not None else V.env_reset(batch, rows, cols, device)
    dev = env.board.device
    search = mcts.init_root(net_apply, variables, tables, mcfg, env.board, env.to_move,
                            device=dev)
    return PlayCarry(env, search, torch.full((batch,), -1, dtype=torch.int32, device=dev))


def make_move_step(
    net_apply: Callable, variables: Any, tables: V.RuleTables, mcfg: mcts.MCTSConfig,
    scfg: SelfplayConfig, cols: int,
):
    """One self-play move for the whole batch: `(carry, move_idx, draws) ->
    (carry, GameRecord of the move)`, the unit of chunked generation.  The
    record is read before the next move's tree reuse builds on the
    search."""

    def move_step(carry: PlayCarry, move_idx: int, draws: MoveDraws):
        envc = carry.env
        if scfg.tree_reuse:
            state0 = mcts.reuse_or_init_root(
                net_apply, variables, tables, mcfg, carry.search, carry.prev_move, envc.board,
                envc.to_move, reserve=scfg.num_simulations + 8, noise=draws.noise,
            )
            steps_n = -(-scfg.num_simulations // max(1, mcfg.leaf_batch))
            state = mcts.simulate_n(net_apply, variables, tables, mcfg, state0, steps_n)
        else:
            state = mcts.run_search(
                net_apply, variables, tables, mcfg, envc.board, envc.to_move,
                scfg.num_simulations, device=envc.board.device, noise=draws.noise,
            )
        dist = mcts.root_visit_distribution(state)
        rval = mcts.root_value(state)
        qmap, qmask = _root_q(state)

        # temperature sampling for opening diversity, argmax after
        # (reference: GameGenerator final selector + opening temperature)
        if move_idx < scfg.temperature_moves:
            move = mcts.select_move(state, temperature=scfg.temperature, gumbel=draws.gumbel)
        else:
            move = mcts.select_move(state)

        st = state.stats
        counters = torch.stack([
            st.depth_sum.sum(), st.expansions.sum(), st.transpositions.sum(),
            st.duplicates.sum(), st.proven_revisits.sum(), st.terminals.sum(),
            st.solver_wins.sum(), state.sims_done.sum(),
        ]).float()
        sample = GameRecord(
            board=envc.board, stm=envc.to_move, visit_dist=dist, q_value=qmap, q_mask=qmask,
            root_value=rval, move=move.to(torch.int16),
            alive=envc.outcome == int(GameOutcome.UNKNOWN), phase_counters=counters,
        )
        newenv = V.env_step(tables, envc, move // cols, move % cols, draw_after=scfg.draw_after)
        return PlayCarry(newenv, state, move.int()), sample

    return move_step


def dead_record(env: V.EnvState) -> GameRecord:
    """The record of a move searched by no game: every game has ended.  It
    holds the frozen board and side to move, `alive=False`, and zeros."""
    bsz, h, w = env.board.shape
    dev = env.board.device
    zeros = lambda *shape, dtype=torch.float32: torch.zeros(shape, dtype=dtype, device=dev)
    return GameRecord(
        board=env.board, stm=env.to_move, visit_dist=zeros(bsz, h, w),
        q_value=zeros(bsz, h, w, 2), q_mask=zeros(bsz, h, w, dtype=torch.bool),
        root_value=zeros(bsz, 2), move=zeros(bsz, dtype=torch.int16),
        alive=zeros(bsz, dtype=torch.bool), phase_counters=zeros(8),
    )


def _search_config(mcfg: mcts.MCTSConfig, scfg: SelfplayConfig) -> mcts.MCTSConfig:
    return mcfg._replace(noise_weight=scfg.noise_weight, noise_alpha=scfg.noise_alpha,
                         draw_after=scfg.draw_after)


def _play(move_step, carry: PlayCarry, moves: range, mcfg: mcts.MCTSConfig,
          generator: torch.Generator | None, draws: Sequence[MoveDraws] | None):
    """Play `moves` (their numbers) from `carry`: (carry, [GameRecord])."""
    records = []
    bsz = carry.env.board.shape[0]
    for i in moves:
        if not bool((carry.env.outcome == int(GameOutcome.UNKNOWN)).any()):
            records.append(dead_record(carry.env))
            continue
        d = draws[i] if draws is not None else draw_move(mcfg, bsz, generator)
        with torch.no_grad():
            carry, rec = move_step(carry, i, d)
        records.append(rec)
    return carry, records


def _stack(records: Sequence[GameRecord]) -> GameRecord:
    return GameRecord(*[torch.stack(xs) for xs in zip(*records)])


def play_games(
    net_apply: Callable, variables: Any, tables: V.RuleTables, mcfg: mcts.MCTSConfig,
    scfg: SelfplayConfig, generator: torch.Generator | None, batch: int, rows: int, cols: int,
    init_env: V.EnvState | None = None, draws: Sequence[MoveDraws] | None = None,
    device="cuda",
) -> SelfplayResult:
    """Play `batch` games in lockstep for `scfg.max_moves` moves.

    Finished games freeze (env_step no-ops) and their samples are marked
    dead; once every game has ended, the remaining moves are
    `dead_record`s.  `init_env` seeds games from prepared openings.  Each
    move's draws come from `draws[move]` if given, else from `generator`
    (`draw_move`)."""
    mcfg = _search_config(mcfg, scfg)
    carry = init_carry(net_apply, variables, tables, mcfg, batch, rows, cols, init_env, device)
    move_step = make_move_step(net_apply, variables, tables, mcfg, scfg, cols)
    carry, records = _play(move_step, carry, range(scfg.max_moves), mcfg, generator, draws)
    return SelfplayResult(_stack(records), carry.env.outcome, carry.env.move_count)


def play_games_resumable(
    net_apply: Callable, variables: Any, tables: V.RuleTables, mcfg: mcts.MCTSConfig,
    scfg: SelfplayConfig, generator: torch.Generator | None, batch: int, rows: int, cols: int,
    chunk_moves: int = 16, should_stop: Callable[[], bool] | None = None,
    snapshot_path: str | None = None, init_env: V.EnvState | None = None,
    on_stats: Callable[[dict], None] | None = None,
    draws: Sequence[MoveDraws] | None = None,
    on_move: Callable[[int, PlayCarry], None] | None = None, device="cuda",
) -> SelfplayResult | None:
    """Chunked lockstep self-play with mid-generation preemption snapshots.

    Plays `chunk_moves` plies per chunk and checks `should_stop` between
    chunks; on stop, the in-flight state (env, per-move record so far,
    chunk cursor, and the generator's state from `get_state()`) is written
    to `snapshot_path` and None is returned.  A later call with the same
    arguments resumes from the snapshot (its generator state replaces
    `generator`'s, so a resumed run draws what an uninterrupted one would)
    and deletes it on completion (reference: the SIGINT mid-game
    serialization of every in-flight GameGenerator,
    GameGenerator.cpp:122-141, GeneratorManager.cpp:240-291).  The run
    stops after the chunk in which every game ended.

    The search tree itself is NOT serialized: a resumed game re-searches
    its next move from scratch (with tree_reuse the carry rebuilds over the
    following moves), as the reference stores the game, not the tree.
    `on_move(move, carry)` sees the carry after each searched move."""
    mcfg = _search_config(mcfg, scfg)
    move_step = make_move_step(net_apply, variables, tables, mcfg, scfg, cols)
    if on_move is not None:
        inner = move_step

        def move_step(carry, i, d):
            carry, rec = inner(carry, i, d)
            on_move(i, carry)
            return carry, rec

    n_chunks = -(-scfg.max_moves // chunk_moves)
    start_chunk = 0
    records: list[GameRecord] = []
    env = init_env
    if snapshot_path is not None and os.path.exists(snapshot_path):
        snap = np.load(snapshot_path, allow_pickle=False)
        start_chunk = int(snap["chunk"])
        if generator is not None:
            generator.set_state(torch.from_numpy(snap["generator"]))
        dev = torch.device(device)
        env = V.EnvState(*[torch.from_numpy(snap[f]).to(dev) for f in V.EnvState._fields])
        if start_chunk > 0:
            rec = GameRecord(*[torch.from_numpy(snap[f"rec_{f}"]).to(dev)
                               for f in GameRecord._fields])
            records = [GameRecord(*xs) for xs in zip(*[t.unbind(0) for t in rec])]
    carry = init_carry(net_apply, variables, tables, mcfg, batch, rows, cols, env, device)

    for ci in range(start_chunk, n_chunks):
        lo = ci * chunk_moves
        hi = min(lo + chunk_moves, scfg.max_moves)
        carry, recs = _play(move_step, carry, range(lo, hi), mcfg, generator, draws)
        records += recs
        live = carry.env.outcome == int(GameOutcome.UNKNOWN)
        if on_stats is not None:
            # aggregated per-phase counters of this chunk (reference: the
            # 60 s aggregated selfplay stats, GeneratorManager.cpp:219-239)
            c = torch.stack([r.phase_counters for r in recs]).sum(0).tolist()
            sims = max(c[7], 1.0)
            on_stats({
                "moves": int(hi), "games_live": int(live.sum()), "avg_depth": c[0] / sims,
                "expansions": c[1], "transpositions": c[2], "duplicates": c[3],
                "proven_revisits": c[4], "terminals": c[5], "solver_wins": c[6], "sims": c[7],
            })
        if not bool(live.any()):
            # every game finished: later chunks would search frozen
            # positions (the reference's generators retire finished games
            # immediately)
            break
        if should_stop is not None and should_stop() and hi < scfg.max_moves:
            if snapshot_path is not None:
                rec_all = _stack(records)
                payload = {"chunk": np.asarray(ci + 1)}
                if generator is not None:
                    payload["generator"] = generator.get_state().numpy()
                payload.update({f: getattr(carry.env, f).cpu().numpy()
                                for f in V.EnvState._fields})
                payload.update({f"rec_{f}": getattr(rec_all, f).cpu().numpy()
                                for f in GameRecord._fields})
                tmp = snapshot_path + ".tmp.npz"
                np.savez_compressed(tmp, **payload)
                os.replace(tmp, snapshot_path)
            return None

    if snapshot_path is not None and os.path.exists(snapshot_path):
        os.remove(snapshot_path)
    return SelfplayResult(_stack(records), carry.env.outcome, carry.env.move_count)


def make_targets(result: SelfplayResult, moves_left_cap: int) -> dict[str, torch.Tensor]:
    """Flatten a SelfplayResult into per-sample training targets.

    Returns a dict of [M*B, ...] tensors: board/stm to re-encode features
    at train time (symmetry augmentation happens there, reference:
    SupervisedLearning.cpp:37-46), policy [.., H, W], value_wdl [.., 3],
    q targets + mask, moves_left bucket index, played move, and the
    sample weight mask `valid` (alive and the game finished)."""
    rec = result.record
    m, bsz = rec.stm.shape
    dev = rec.stm.device

    outcome = result.outcome[None, :].expand(m, bsz)
    finished = outcome != int(GameOutcome.UNKNOWN)
    valid = rec.alive & finished

    stm = rec.stm
    win = (((outcome == int(GameOutcome.CROSS_WIN)) & (stm == CROSS))
           | ((outcome == int(GameOutcome.CIRCLE_WIN)) & (stm == CIRCLE)))
    draw = outcome == int(GameOutcome.DRAW)
    loss = finished & ~win & ~draw
    value_wdl = torch.stack([win.float(), draw.float(), loss.float()], dim=-1)

    move_idx = torch.arange(m, dtype=torch.int32, device=dev)[:, None]
    length = result.game_length[None, :].expand(m, bsz)
    moves_left = (length - move_idx).clamp(0, moves_left_cap - 1)

    def flat(x):
        return x.reshape((m * bsz,) + tuple(x.shape[2:]))

    return {
        "board": flat(rec.board),
        "stm": flat(stm),
        "policy": flat(rec.visit_dist),
        "value_wdl": flat(value_wdl),
        "q_value": flat(rec.q_value),
        "q_mask": flat(rec.q_mask),
        "root_value": flat(rec.root_value),
        "moves_left": flat(moves_left),
        "played_move": flat(rec.move),
        "valid": flat(valid),
    }
