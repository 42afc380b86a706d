"""Goldens: the JAX package's outputs on fixed numpy inputs, committed so
that the port's tier-1 tests need not compile the JAX side.

`load(name)` reads `tests/torch_golden/<name>.npz`.  The JAX computation
behind each golden is registered in `cases.py`; regenerate them all with

    JAX_PLATFORMS=cpu python tests/torch_golden/make_goldens.py

and check them live against the JAX package with

    JAX_PLATFORMS=cpu python -m pytest -m slow tests/test_torch_goldens.py

This module imports numpy only, so the port's tests can read goldens on a
machine without JAX.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

DIR = Path(__file__).resolve().parent


def path(name: str) -> Path:
    return DIR / f"{name}.npz"


def load(name: str) -> dict[str, np.ndarray]:
    with np.load(path(name)) as data:
        return {k: data[k] for k in data.files}


def save(name: str, arrays: dict[str, np.ndarray]) -> None:
    np.savez_compressed(path(name), **{k: np.asarray(v) for k, v in arrays.items()})
