"""The port's score_backup (the search's proven-score backup, in place on
the tree): plain version bit-identical to the JAX composition (gather the
path's rows, `score_scan_reference`, write the new scores back), every
other entry of the tree untouched; CUDA kernel bit-identical to the plain
version (on a machine with a card).

The JAX package is imported inside the parity test, so that the card's
tests run where JAX is not installed:
    python -m pytest --noconftest -m cuda tests/test_torch_score_backup.py
"""

import numpy as np
import pytest
import torch

from alphagomoku_tpu_torch.ops import score_scan as TSS
from tests.test_torch_score_scan import random_inputs
from tests.test_torch_score_scan import to_torch as scan_to_torch

torch.set_num_threads(1)

NULL = -1
# (B, N, D, K, seed): boards, nodes per tree, path levels, edge slots
CASES = [(8, 40, 12, 16, 0), (16, 40, 16, 32, 1), (24, 40, 6, 8, 2), (12, 40, 16, 8, 3),
         (8, 60, 48, 32, 4)]
BENCH = (1280, 808, 16, 32, 5)
# K > 32, the wide kernels (each lane a slot every 32): K up to a 20x20
# board's cells, at D within one chunk of 16 and of 32 levels, and at the
# engine's D = 40
WIDE = [(8, 40, 12, 33, 7), (16, 30, 16, 81, 8), (8, 40, 32, 225, 9), (8, 60, 40, 81, 10),
        (4, 50, 40, 400, 11)]
# the wide kernels on the card at every K held, each at one level, either
# side of a 16-level chunk's edges, and the engine's 40
WIDE_K = [33, 64, 81, 225, 400]
WIDE_D = [1, 8, 16, 17, 32, 33, 40]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel)")
    return torch.device("cuda")


def random_tree(B, N, D, K, seed, holes=False):
    """A tree of B boards with N nodes of K edge slots and one path of D
    levels per board, as numpy arrays, from `random_inputs`' generator:
    the tree's rows are its [B, N(, K)] draws (inactive slots get NULL
    actions), the path its [B, D] draws (distinct nodes per board, NULL
    past the valid prefix, or at random levels with `holes`; the traversed
    slots are its `sl`)."""
    start, valid, sl, _, _, _, _ = random_inputs(B, D, K, seed, holes)
    _, _, _, es, ea, comp, ns = random_inputs(B, N, K, seed + 1000)
    rng = np.random.default_rng(seed + 2000)
    actions = np.where(ea, rng.integers(0, 225, size=ea.shape), NULL).astype(np.int32)
    nodes = np.argsort(rng.random((B, N)), axis=1)[:, :D]
    pn = np.where(valid, nodes, NULL).astype(np.int64)
    ps = np.where(valid, sl, NULL).astype(np.int64)
    return dict(edge_score=es.astype(np.int32), edge_action=actions, node_complete=comp,
                node_score=ns.astype(np.int32), pn=pn, ps=ps, start_score=start.astype(np.int32))


def to_torch(tree, device="cpu"):
    return {k: torch.from_numpy(v.copy()).to(device) for k, v in tree.items()}


def jax_backup(tree):
    """The JAX composition on numpy arrays: gather the path's rows, run
    `score_scan_reference`, write the new scores into copies of the tree."""
    import jax.numpy as jnp
    from alphagomoku_tpu.ops.score_scan import score_scan_reference

    pn, ps = tree["pn"], tree["ps"]
    valid = pn != NULL
    nd = np.where(valid, pn, 0)
    sl = np.where(valid, ps, 0).astype(np.int32)
    bb = np.arange(pn.shape[0])[:, None]
    es_rows = np.where(valid[..., None], tree["edge_score"][bb, nd], 0).astype(np.uint16)
    ea_rows = (tree["edge_action"][bb, nd] != NULL) & valid[..., None]
    comp_rows = tree["node_complete"][bb, nd] & valid
    ns_rows = np.where(valid, tree["node_score"][bb, nd], 0).astype(np.uint16)
    e_new, ns_new = score_scan_reference(*[jnp.asarray(a) for a in (
        tree["start_score"].astype(np.uint16), valid, sl, es_rows, ea_rows, comp_rows, ns_rows)])
    e_new, ns_new = np.asarray(e_new).astype(np.int32), np.asarray(ns_new).astype(np.int32)
    edge_score, node_score = tree["edge_score"].copy(), tree["node_score"].copy()
    b, d = np.nonzero(valid)
    edge_score[b, nd[b, d], sl[b, d]] = e_new[b, d]
    node_score[b, nd[b, d]] = ns_new[b, d]
    return edge_score, node_score


def run(fn, tree):
    t = dict(tree)
    fn(t["edge_score"], t["edge_action"], t["node_complete"], t["node_score"], t["pn"], t["ps"],
       t["start_score"])
    return t


@pytest.mark.parametrize("B,N,D,K,seed", CASES + WIDE[:2])
def test_plain_matches_jax_composition(B, N, D, K, seed):
    """Bit-identical to the JAX composition; only the path's traversed
    edges and nodes may change, and some do."""
    tree = random_tree(B, N, D, K, seed)
    ref_es, ref_ns = jax_backup(tree)
    out = run(TSS.score_backup_plain, to_torch(tree))
    assert np.array_equal(out["edge_score"].numpy(), ref_es)
    assert np.array_equal(out["node_score"].numpy(), ref_ns)
    for name in ("edge_action", "node_complete", "pn", "ps", "start_score"):
        assert np.array_equal(out[name].numpy(), tree[name])
    valid = tree["pn"] != NULL
    on_path_node = np.zeros(tree["node_score"].shape, bool)
    on_path_edge = np.zeros(tree["edge_score"].shape, bool)
    b, d = np.nonzero(valid)
    on_path_node[b, tree["pn"][b, d]] = True
    on_path_edge[b, tree["pn"][b, d], tree["ps"][b, d]] = True
    assert np.array_equal(ref_ns[~on_path_node], tree["node_score"][~on_path_node])
    assert np.array_equal(ref_es[~on_path_edge], tree["edge_score"][~on_path_edge])
    assert (ref_es != tree["edge_score"]).any() and (ref_ns != tree["node_score"]).any()


def test_cpu_dispatch_runs_the_plain_version_and_counts_no_launch():
    tree = random_tree(*CASES[0])
    before = TSS.score_backup.launches
    out = run(TSS.score_backup, to_torch(tree))
    ref = run(TSS.score_backup_plain, to_torch(tree))
    assert TSS.score_backup.launches == before
    for name in tree:
        assert torch.equal(out[name], ref[name])


def test_more_than_one_path_per_board_raises():
    t = to_torch(random_tree(*CASES[0]))
    t["pn"], t["ps"] = t["pn"].repeat(2, 1), t["ps"].repeat(2, 1)
    with pytest.raises(ValueError, match="one path per board"):
        run(TSS.score_backup, t)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,D,K,seed", CASES + [BENCH])
def test_kernel_matches_plain_on_card(B, N, D, K, seed, cuda_device):
    tree = random_tree(B, N, D, K, seed)
    out = run(TSS.score_backup, to_torch(tree, cuda_device))
    ref = run(TSS.score_backup_plain, to_torch(tree, cuda_device))
    torch.cuda.synchronize()
    for name in tree:
        assert torch.equal(out[name], ref[name]), name


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,D,K,seed", WIDE + [(1280, 200, 16, 81, 12), (256, 60, 40, 225, 13)])
def test_wide_kernels_match_plain_on_card(B, N, D, K, seed, cuda_device):
    """K > 32: score_backup on the tree and score_scan on the path's rows
    gathered, both bit-equal to their plain versions."""
    tree = random_tree(B, N, D, K, seed)
    out = run(TSS.score_backup, to_torch(tree, cuda_device))
    ref = run(TSS.score_backup_plain, to_torch(tree, cuda_device))
    for name in tree:
        assert torch.equal(out[name], ref[name]), name
    args = scan_to_torch(random_inputs(B, D, K, seed), cuda_device)
    got, want = TSS.score_scan(*args), TSS.score_scan_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("K", [33, 81, 225, 400])
def test_wide_kernels_keep_their_state_in_registers(K, cuda_device):
    for name, occ in TSS.scan_occupancy(40, K).items():
        assert occ["local_bytes"] == 0, (name, occ)
        assert occ["blocks_per_sm"] >= 1, (name, occ)


@pytest.mark.cuda
def test_kernel_matches_plain_on_every_start_score(cuda_device):
    """Every packed u16 value as the leaf score of a one-level path."""
    R = 1 << 16
    tree = random_tree(R, 1, 1, 32, 6)
    tree["pn"][:] = 0
    tree["ps"][:] = np.random.default_rng(6).integers(0, 32, size=(R, 1))
    tree["start_score"] = np.arange(R, dtype=np.int32)
    out = run(TSS.score_backup, to_torch(tree, cuda_device))
    ref = run(TSS.score_backup_plain, to_torch(tree, cuda_device))
    torch.cuda.synchronize()
    for name in tree:
        assert torch.equal(out[name], ref[name]), name


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 48])
def test_scan_kernels_keep_their_levels_in_registers(D, cuda_device):
    """No local memory (spills) in either entry point's kernel."""
    for name, occ in TSS.scan_occupancy(D).items():
        assert occ["local_bytes"] == 0, (name, occ)
        assert occ["blocks_per_sm"] >= 1, (name, occ)


def wide_pair_on_card(B, N, D, K, seed, device, holes=False):
    """score_backup on a random tree and score_scan on random rows, each
    against its plain version: the names of what differs."""
    tree = random_tree(B, N, D, K, seed, holes)
    out = run(TSS.score_backup, to_torch(tree, device))
    ref = run(TSS.score_backup_plain, to_torch(tree, device))
    differ = [name for name in tree if not torch.equal(out[name], ref[name])]
    args = scan_to_torch(random_inputs(B, D, K, seed, holes), device)
    got, want = TSS.score_scan(*args), TSS.score_scan_plain(*args)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        differ.append("score_scan")
    return differ


@pytest.mark.cuda
@pytest.mark.parametrize("D", WIDE_D)
@pytest.mark.parametrize("K", WIDE_K)
def test_wide_kernels_match_plain_at_every_depth(K, D, cuda_device):
    """Both wide entry points bit-equal to their plain versions at each K
    and D, on paths as drawn and on paths with holes."""
    for holes in (False, True):
        assert wide_pair_on_card(64, 48, D, K, 100 + K + D, cuda_device, holes) == [], holes


@pytest.mark.cuda
def test_wide_kernels_match_plain_at_the_9x9_step_shape(cuda_device):
    """R = 1,024 rows and paths at K = 81, D = 16: the 9x9 leaf-batch
    step's scan shape."""
    assert wide_pair_on_card(1024, 64, 16, 81, 16, cuda_device) == []


@pytest.mark.cuda
def test_wide_kernel_matches_plain_on_every_start_score(cuda_device):
    """test_kernel_matches_plain_on_every_start_score at K = 81 (the wide
    kernel)."""
    R = 1 << 16
    tree = random_tree(R, 1, 1, 81, 17)
    tree["pn"][:] = 0
    tree["ps"][:] = np.random.default_rng(17).integers(0, 81, size=(R, 1))
    tree["start_score"] = np.arange(R, dtype=np.int32)
    out = run(TSS.score_backup, to_torch(tree, cuda_device))
    ref = run(TSS.score_backup_plain, to_torch(tree, cuda_device))
    torch.cuda.synchronize()
    for name in tree:
        assert torch.equal(out[name], ref[name]), name
