"""The PyTorch port stands alone: every module of `alphagomoku_tpu_torch`
and `chip_smoke.py` import with jax, flax and the JAX package blocked, and
no source file of the port names them."""

import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "alphagomoku_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in PORT.rglob("*.py")
)

_BLOCKED_IMPORT = """
import sys
for name in ("jax", "jaxlib", "flax", "optax", "alphagomoku_tpu"):
    sys.modules[name] = None  # any import of these raises ImportError
import importlib
for mod in sys.argv[1:]:
    importlib.import_module(mod)
import runpy
runpy.run_path("chip_smoke.py", run_name="chip_smoke_import_check")
print("ok")
"""


def test_port_imports_without_jax():
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT, *MODULES],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
    assert len(MODULES) >= 15


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_names_no_jax(path):
    text = path.read_text()
    assert not re.search(r"alphagomoku_tpu\.", text), path
    assert not re.search(r"^\s*(import|from)\s+(jax|flax)\b", text, re.M), path
