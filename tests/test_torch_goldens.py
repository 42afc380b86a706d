"""The goldens of tests/torch_golden re-derived live from the JAX package
(slow: the JAX searches and solves compile for minutes):

    JAX_PLATFORMS=cpu python -m pytest -m slow tests/test_torch_goldens.py

Integers and booleans must be equal; floats, network outputs among them,
within 1e-3 of the array's largest magnitude (XLA's CPU code may sum in
another order on another machine)."""

import numpy as np
import pytest

from tests import torch_golden
from tests.torch_golden.cases import CASES


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(CASES))
def test_golden_matches_jax_live(name):
    golden = torch_golden.load(name)
    live = CASES[name]()
    assert sorted(live) == sorted(golden)
    for key, want in golden.items():
        got = np.asarray(live[key])
        assert got.shape == want.shape, key
        if np.issubdtype(want.dtype, np.floating):
            scale = max(1e-6, float(np.abs(want).max()))
            assert np.abs(got.astype(np.float64) - want).max() <= 1e-3 * scale, key
        else:
            assert np.array_equal(got, want), key
