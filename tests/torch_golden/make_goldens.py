"""Write every golden of tests/torch_golden from the JAX package.

    JAX_PLATFORMS=cpu python tests/torch_golden/make_goldens.py [name ...]

With names, only those goldens are written.  Takes a few minutes on a CPU
(the JAX searches and solves compile first).
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from tests import torch_golden  # noqa: E402
from tests.torch_golden.cases import CASES  # noqa: E402


def main(names: list[str]) -> None:
    for name in names or CASES:
        t0 = time.perf_counter()
        torch_golden.save(name, CASES[name]())
        size = torch_golden.path(name).stat().st_size
        print(f"{name}: {size} bytes in {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
