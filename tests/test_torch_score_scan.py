"""The port's score_scan: plain version bit-identical to the JAX oracle and
to the Pallas kernel in interpret mode (the golden score_scan_interpret);
CUDA kernel bit-identical to the plain version (on a machine with a card).

The JAX package is imported inside the parity test, so that the card's
tests run where JAX is not installed:
    python -m pytest --noconftest -m cuda tests/test_torch_score_scan.py
"""

import numpy as np
import pytest
import torch

from alphagomoku_tpu_torch.ops import score_scan as TSS
from tests import torch_golden

torch.set_num_threads(1)

CASES = [(8, 12, 16, 0), (16, 16, 32, 1), (24, 6, 8, 2)]
# K > 32 (the wide kernels on the card): held against the live JAX oracle
# only, the golden score_scan_interpret holds CASES
WIDE_CASES = [(8, 12, 64, 5), (8, 33, 81, 6)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel)")
    return torch.device("cuda")


def random_inputs(B, D, K, seed, holes=False):
    """The random packed-score generator of tests/test_ops.py; `holes`
    leaves the valid levels unsorted, so that they are not a prefix."""
    rng = np.random.default_rng(seed)

    def rand_scores(shape):
        pv = rng.choice([0, 1, 2, 2, 2, 3], size=shape)
        ev = rng.integers(-200, 200, size=shape)
        dist = rng.integers(0, 30, size=shape)
        ev = np.where(pv == 3, -dist, np.where(pv == 2, ev, dist))
        return ((pv << 13) | (4000 + ev)).astype(np.uint16)

    start = rand_scores((B,))
    valid = rng.random((B, D)) < 0.7
    if not holes:
        valid = np.sort(valid, axis=1)[:, ::-1].copy()
    sl = rng.integers(0, K, size=(B, D)).astype(np.int32)
    es = rand_scores((B, D, K))
    ea = rng.random((B, D, K)) < 0.8
    ea[..., 0] = True
    comp = rng.random((B, D)) < 0.5
    ns = rand_scores((B, D))
    return start, valid, sl, es, ea, comp, ns


def to_torch(args, device="cpu"):
    start, valid, sl, es, ea, comp, ns = args
    i32 = lambda a: torch.from_numpy(a.astype(np.int32)).to(device)
    b = lambda a: torch.from_numpy(a).to(device)
    return i32(start), b(valid), i32(sl), i32(es), b(ea), b(comp), i32(ns)


def jax_score_scan_interpret() -> dict:
    """The Pallas kernel in interpret mode on every case (the reference
    side of the golden score_scan_interpret)."""
    import jax.numpy as jnp
    from alphagomoku_tpu.ops.score_scan import score_scan as jax_score_scan

    out = {}
    for B, D, K, seed in CASES:
        e, ns = jax_score_scan(*[jnp.asarray(a) for a in random_inputs(B, D, K, seed)],
                               interpret=True)
        out[f"{B}-{D}-{K}-{seed}.e"] = np.asarray(e).astype(np.int64)
        out[f"{B}-{D}-{K}-{seed}.ns"] = np.asarray(ns).astype(np.int64)
    return out


@pytest.mark.parametrize("B,D,K,seed", CASES + WIDE_CASES)
def test_plain_matches_jax_oracle_and_pallas_interpret(B, D, K, seed):
    """Bit-identical to the JAX oracle (live) and, for CASES, to the Pallas
    kernel in interpret mode (the golden score_scan_interpret)."""
    import jax.numpy as jnp
    from alphagomoku_tpu.ops.score_scan import score_scan_reference

    args = random_inputs(B, D, K, seed)
    ref_e, ref_ns = score_scan_reference(*[jnp.asarray(a) for a in args])
    e, ns = TSS.score_scan(*to_torch(args))
    pairs = [(ref_e, e), (ref_ns, ns)]
    if (B, D, K, seed) in CASES:
        golden = torch_golden.load("score_scan_interpret")
        pairs += [(golden[f"{B}-{D}-{K}-{seed}.e"], e), (golden[f"{B}-{D}-{K}-{seed}.ns"], ns)]
    for jax_out, port in pairs:
        assert np.array_equal(np.asarray(jax_out).astype(np.int64), port.numpy().astype(np.int64))


def test_cpu_dispatch_never_counts_a_launch():
    before = TSS.score_scan.launches
    TSS.score_scan(*to_torch(random_inputs(*CASES[0])))
    assert TSS.score_scan.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("B,D,K,seed", CASES + [(1280, 16, 32, 3)])
def test_kernel_matches_plain_on_card(B, D, K, seed, cuda_device):
    args = to_torch(random_inputs(B, D, K, seed), cuda_device)
    e, ns = TSS.score_scan(*args)
    pe, pns = TSS.score_scan_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(e, pe) and torch.equal(ns, pns)


@pytest.mark.cuda
def test_kernel_matches_plain_on_every_start_score(cuda_device):
    """Every packed u16 value as the child score of a one-level path: the
    kernel's invert_up and minimax agree with the plain version's."""
    R = 1 << 16
    _, _, sl, es, ea, comp, ns = random_inputs(R, 1, 32, 4)
    start = np.arange(R, dtype=np.uint16)
    valid = np.ones((R, 1), bool)
    args = to_torch((start, valid, sl, es, ea, comp, ns), cuda_device)
    e, ns_k = TSS.score_scan(*args)
    pe, pns = TSS.score_scan_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(e, pe) and torch.equal(ns_k, pns)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [32, 81])
def test_kernel_matches_plain_on_rows_with_holes(K, cuda_device):
    """Rows whose valid levels are not a prefix, at D = 40 (three wide
    chunks, two staged ones)."""
    args = to_torch(random_inputs(256, 40, K, 14, holes=True), cuda_device)
    e, ns = TSS.score_scan(*args)
    pe, pns = TSS.score_scan_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(e, pe) and torch.equal(ns, pns)


@pytest.mark.cuda
def test_wide_kernel_matches_plain_on_every_start_score(cuda_device):
    """test_kernel_matches_plain_on_every_start_score at K = 81 (the wide
    kernel)."""
    R = 1 << 16
    _, _, sl, es, ea, comp, ns = random_inputs(R, 1, 81, 15)
    start = np.arange(R, dtype=np.uint16)
    valid = np.ones((R, 1), bool)
    args = to_torch((start, valid, sl, es, ea, comp, ns), cuda_device)
    e, ns_k = TSS.score_scan(*args)
    pe, pns = TSS.score_scan_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(e, pe) and torch.equal(ns_k, pns)
