"""Proven-score minimax backward scan of the MCTS backup
(reference semantics: Tree::backup + Node::updateScore,
src/search/monte_carlo/Tree.cpp:299-351, Node.hpp:283-286).

Walking a selection path bottom-up, each level d refreshes the traversed
edge's packed 16-bit score from the child's score (`invert_up`) and then
re-minimaxes the node: WIN if any edge is WIN; LOSS/DRAW only when every
edge of a COMPLETE node is proven.

`score_scan` launches the CUDA kernel `csrc/score_scan.cu` (the port of the
Pallas kernel `alphagomoku_tpu/ops/score_scan.py:_kernel`) for CUDA
tensors and runs `score_scan_plain` for CPU tensors.  Shapes:
start [R] int32; valid/comp [R, D] bool; sl [R, D] int32;
es [R, D, K] int32; ea [R, D, K] bool; ns [R, D] int32 -> (e_new, ns_new)
[R, D] int32.  Scores are packed uint16 values carried in int32.
"""

from __future__ import annotations

import torch

from ..search import score as S
from . import _build


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


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"score_scan: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"score_scan: {name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"score_scan: {name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"score_scan: {name} must be contiguous")


def score_scan(start, valid, sl, es, ea, comp, ns):
    """Backward minimax over selection paths: the CUDA kernel for CUDA
    tensors, `score_scan_plain` for CPU tensors."""
    if start.device.type == "cpu":
        return score_scan_plain(start, valid, sl, es, ea, comp, ns)
    if start.device.type != "cuda":
        raise ValueError(f"score_scan: unsupported device {start.device}")
    R, D = valid.shape
    K = es.shape[2]
    if K > 32:
        raise ValueError(f"score_scan: K = {K} edges exceeds the kernel's 32 lanes")
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
