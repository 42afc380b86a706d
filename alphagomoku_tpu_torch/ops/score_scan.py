"""Proven-score minimax backward scan of the MCTS backup
(reference semantics: Tree::backup + Node::updateScore,
src/search/monte_carlo/Tree.cpp:299-351, Node.hpp:283-286).

Walking a selection path bottom-up, each level d refreshes the traversed
edge's packed 16-bit score from the child's score (`invert_up`) and then
re-minimaxes the node: WIN if any edge is WIN; LOSS/DRAW only when every
edge of a COMPLETE node is proven.

Two entry points, both on the CUDA kernels of `csrc/score_scan.cu` (the
port of the Pallas kernel `alphagomoku_tpu/ops/score_scan.py:_kernel`) for
CUDA tensors and on their plain versions for CPU tensors:

- `score_scan(start, valid, sl, es, ea, comp, ns)`, the Pallas kernel's
  interface, on the path's rows gathered beforehand.  Shapes: start [R]
  int32; valid/comp [R, D] bool; sl [R, D] int32; es [R, D, K] int32;
  ea [R, D, K] bool; ns [R, D] int32 -> (e_new, ns_new) [R, D] int32.
- `score_backup(edge_score, edge_action, node_complete, node_score, pn,
  ps, start_score)`, the whole proven-score backup of a simulation step
  (the search's backup B): per board it reads the path's edge and node
  rows where they lie in the tree and writes the new edge and node scores
  back into the tree IN PLACE.  The JAX package builds the scan's inputs
  with one-hot einsums and writes back through dedup and one-hot deltas,
  a workaround for the TPU's lack of per-row gathers; updating the tree
  in place is the port's choice (a search owns its tree), and one launch
  replaces the gathers, the scan and the two `index_put_`s.  It takes one
  path per board (`leaf_batch = 1`); `score_backup_paths` takes several
  paths per board (`leaf_batch > 1`): one `score_scan` launch over their
  rows, then the JAX backup's claim dedup.

Both take any K, as the Pallas kernel does: K <= 32 edge slots run the
staged kernels (one lane a slot, the rows in registers), K > 32 the wide
kernels (the rows staged in shared memory, each lane a slot every 32),
chosen by K on the host.

Scores are packed uint16 values carried in int32.
"""

from __future__ import annotations

import ctypes

import torch

from ..search import score as S
from . import _build

NULL = -1  # empty edge slot (edge_action), empty path level (pn, ps)


def score_scan_plain(start, valid, sl, es, ea, comp, ns):
    """Plain PyTorch version: one level per loop iteration."""
    R, D = valid.shape
    K = es.shape[2]
    k_iota = torch.arange(K, device=es.device)[None, :]
    child = start.to(torch.int32)
    e_out = torch.empty((R, D), dtype=torch.int32, device=es.device)
    ns_out = torch.empty_like(e_out)
    for d in range(D - 1, -1, -1):
        vd = valid[:, d]
        esd = es[:, d].to(torch.int32)
        ead = ea[:, d]
        pscore = S.invert_up(child)
        slh = k_iota == sl[:, d, None]
        e_at_slot = torch.where(slh, esd, 0).sum(-1, dtype=torch.int32)
        e_new = torch.where(vd & S.is_proven(pscore), pscore, e_at_slot)
        row = torch.where(slh, e_new[:, None], esd)
        best = torch.where(ead, row, 0).amax(-1)
        all_proven = (S.is_proven(row) | ~ead).all(-1)
        provable = S.is_win(best) | (all_proven & comp[:, d] & S.is_proven(best))
        ns_new = torch.where(vd & provable, best, ns[:, d].to(torch.int32))
        child = torch.where(vd, ns_new, child)
        e_out[:, d] = e_new
        ns_out[:, d] = ns_new
    return e_out, ns_out


def _check(name, t, dtype, shape, device, what="score_scan"):
    if t.device != device:
        raise ValueError(f"{what}: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: {name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: {name} must be contiguous")


def score_scan(start, valid, sl, es, ea, comp, ns):
    """Backward minimax over selection paths: the CUDA kernel for CUDA
    tensors, `score_scan_plain` for CPU tensors."""
    if start.device.type == "cpu":
        return score_scan_plain(start, valid, sl, es, ea, comp, ns)
    if start.device.type != "cuda":
        raise ValueError(f"score_scan: unsupported device {start.device}")
    R, D = valid.shape
    K = es.shape[2]
    dev = start.device
    _check("start", start, torch.int32, (R,), dev)
    _check("valid", valid, torch.bool, (R, D), dev)
    _check("sl", sl, torch.int32, (R, D), dev)
    _check("es", es, torch.int32, (R, D, K), dev)
    _check("ea", ea, torch.bool, (R, D, K), dev)
    _check("comp", comp, torch.bool, (R, D), dev)
    _check("ns", ns, torch.int32, (R, D), dev)
    e_out = torch.empty((R, D), dtype=torch.int32, device=dev)
    ns_out = torch.empty_like(e_out)
    lib = _build.library()
    err = lib.ag_score_scan(
        start.data_ptr(), valid.data_ptr(), sl.data_ptr(), es.data_ptr(),
        ea.data_ptr(), comp.data_ptr(), ns.data_ptr(), e_out.data_ptr(),
        ns_out.data_ptr(), R, D, K, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "score_scan")
    score_scan.launches += 1
    return e_out, ns_out


score_scan.launches = 0


def score_backup_plain(edge_score, edge_action, node_complete, node_score, pn, ps, start_score):
    """Plain PyTorch version: gather the path's rows, `score_scan_plain`,
    then write each changed score back as new minus old with `index_put_`."""
    bsz, D = pn.shape
    valid = pn != NULL  # [B, D]
    nd = torch.where(valid, pn, 0)
    bb = torch.arange(bsz, device=pn.device)[:, None].expand(bsz, D)
    sl = torch.where(valid, ps, 0)
    es_rows = torch.where(valid[..., None], edge_score[bb, nd], 0)
    ea_rows = (edge_action[bb, nd] != NULL) & valid[..., None]
    comp_rows = node_complete[bb, nd] & valid
    ns_rows = torch.where(valid, node_score[bb, nd], 0)
    e_new, ns_new = score_scan_plain(
        start_score.to(torch.int32), valid, sl.to(torch.int32), es_rows, ea_rows, comp_rows,
        ns_rows,
    )
    e_old = es_rows.gather(2, sl[..., None]).squeeze(-1)
    # a path visits a node at most once, so each (node, slot) gets at most
    # one real claim; adding new - old lands it exactly
    edge_score.index_put_(
        (bb, nd, sl), torch.where(valid & (e_new != e_old), e_new - e_old, 0), accumulate=True,
    )
    node_score.index_put_(
        (bb, nd), torch.where(valid & (ns_new != ns_rows), ns_new - ns_rows, 0), accumulate=True,
    )


def score_backup(edge_score, edge_action, node_complete, node_score, pn, ps, start_score):
    """Proven-score backup of one path per board, in place on the tree:
    the CUDA kernel for CUDA tensors, `score_backup_plain` for CPU
    tensors.  edge_score, edge_action [B, N, K] int32 (edge_action NULL
    for an empty slot); node_complete [B, N] bool; node_score [B, N]
    int32; pn, ps [B, D] int64, the path's node and slot per level (NULL
    past the path); start_score [B] int32, the leaf's score."""
    B, N, K = edge_score.shape
    D = pn.shape[1]
    if pn.shape[0] != B:
        raise ValueError(
            f"score_backup: {pn.shape[0]} paths for {B} trees; one path per board only "
            "(S paths per board: score_backup_paths)"
        )
    dev = edge_score.device
    what = "score_backup"
    _check("edge_score", edge_score, torch.int32, (B, N, K), dev, what)
    _check("edge_action", edge_action, torch.int32, (B, N, K), dev, what)
    _check("node_complete", node_complete, torch.bool, (B, N), dev, what)
    _check("node_score", node_score, torch.int32, (B, N), dev, what)
    _check("pn", pn, torch.int64, (B, D), dev, what)
    _check("ps", ps, torch.int64, (B, D), dev, what)
    _check("start_score", start_score, torch.int32, (B,), dev, what)
    if dev.type == "cpu":
        score_backup_plain(edge_score, edge_action, node_complete, node_score, pn, ps, start_score)
        return
    if dev.type != "cuda":
        raise ValueError(f"score_backup: unsupported device {dev}")
    err = _build.library().ag_score_backup(
        edge_score.data_ptr(), edge_action.data_ptr(), node_complete.data_ptr(),
        node_score.data_ptr(), pn.data_ptr(), ps.data_ptr(), start_score.data_ptr(),
        B, N, D, K, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, what)
    score_backup.launches += 1


score_backup.launches = 0


def dedup_claims(key, new, old, valid):
    """Per board, the change each path position [B, P] claims for its
    `key` (an edge or a node) kept for the strongest claim only: a claim
    that changes nothing loses to any that changes something, then the
    higher packed score wins (ranked as the unsigned 16-bit value:
    Node::updateScore = max), then the earliest position (the reference's
    sequential task order).  Returns new - old for the winners that change
    their key, 0 elsewhere: at most one nonzero per (board, key)."""
    P = key.shape[1]
    changes = (new != old) & valid
    rank = new + (changes.to(new.dtype) << 17)
    p_iota = torch.arange(P, device=key.device)
    same = (key[:, :, None] == key[:, None, :]) & valid[:, None, :]
    beats = (rank[:, None, :] > rank[:, :, None]) | (
        (rank[:, None, :] == rank[:, :, None]) & (p_iota[None, :] < p_iota[:, None])[None])
    win = valid & ~(same & beats).any(-1)
    return torch.where(win & changes, new - old, 0)


def score_backup_paths(edge_score, edge_action, node_complete, node_score, pn, ps, start_score):
    """Proven-score backup of S paths per board, in place on the tree.
    edge_score, edge_action [B, N, K] int32; node_complete [B, N] bool;
    node_score [B, N] int32; pn, ps [B, S, D] int64, each path's node and
    slot per level (NULL past the path); start_score [B, S] int32, each
    leaf's score.  The scan runs on `score_scan` (its CUDA kernel for CUDA
    tensors, `score_scan_plain` for CPU tensors); the gathers, the claim
    dedup and the placement are tensor ops, as they are XLA ops outside
    the Pallas kernel in the reference package."""
    B, N, K = edge_score.shape
    S_, D = pn.shape[1], pn.shape[2]
    P = S_ * D
    dev = edge_score.device
    what = "score_backup_paths"
    _check("edge_score", edge_score, torch.int32, (B, N, K), dev, what)
    _check("edge_action", edge_action, torch.int32, (B, N, K), dev, what)
    _check("node_complete", node_complete, torch.bool, (B, N), dev, what)
    _check("node_score", node_score, torch.int32, (B, N), dev, what)
    _check("pn", pn, torch.int64, (B, S_, D), dev, what)
    _check("ps", ps, torch.int64, (B, S_, D), dev, what)
    _check("start_score", start_score, torch.int32, (B, S_), dev, what)
    valid = pn != NULL  # [B, S, D]
    nd = torch.where(valid, pn, 0)
    sl = torch.where(valid, ps, 0)
    bb = torch.arange(B, device=dev)[:, None, None]
    es_rows = torch.where(valid[..., None], edge_score[bb, nd], 0)  # [B, S, D, K]
    ea_rows = (edge_action[bb, nd] != NULL) & valid[..., None]
    comp_rows = node_complete[bb, nd] & valid
    ns_rows = torch.where(valid, node_score[bb, nd], 0)
    e_new, ns_new = score_scan(
        start_score.reshape(B * S_), valid.reshape(B * S_, D),
        sl.to(torch.int32).reshape(B * S_, D), es_rows.reshape(B * S_, D, K),
        ea_rows.reshape(B * S_, D, K), comp_rows.reshape(B * S_, D), ns_rows.reshape(B * S_, D),
    )
    valid_p = valid.reshape(B, P)
    nd_p, sl_p = nd.reshape(B, P), sl.reshape(B, P)
    e_old = es_rows.gather(3, sl[..., None]).reshape(B, P)
    e_delta = dedup_claims(nd_p * K + sl_p, e_new.reshape(B, P), e_old, valid_p)
    ns_delta = dedup_claims(nd_p, ns_new.reshape(B, P), ns_rows.reshape(B, P), valid_p)
    bp = torch.arange(B, device=dev)[:, None].expand(B, P)
    edge_score.index_put_((bp, nd_p, sl_p), e_delta, accumulate=True)
    node_score.index_put_((bp, nd_p), ns_delta, accumulate=True)


def scan_occupancy(D: int = 16, K: int = 32) -> dict:
    """What the current card gives the kernels launched at depth D with K
    edge slots, by entry point: blocks per SM, registers per thread, static
    shared memory per block (bytes), local memory per thread (bytes;
    spills), dynamic shared memory per block (bytes; the wide kernels stage
    their rows there, sized by K) and rows (warps) per block."""
    out = {}
    keys = ("blocks_per_sm", "registers", "smem_bytes", "local_bytes", "dyn_smem_bytes",
            "warps_per_block")
    for backup, name in ((0, "score_scan"), (1, "score_backup")):
        info = (ctypes.c_int * len(keys))()
        _build.check(_build.library().ag_score_scan_occupancy(backup, D, K, info),
                     "scan_occupancy")
        out[name] = dict(zip(keys, info))
    return out
