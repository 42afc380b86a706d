"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` source is compiled for Hopper (`sm_90a`) by `nvcc`, one
process per source started together, and linked into one shared library
with a plain C interface under `build/torch_kernels/` at the repository
root.  The library name carries a hash of the sources and flags, so an
edited source rebuilds and an unchanged one is reused.  It is loaded with
`ctypes`; pointers and the CUDA stream are passed as `c_void_p`.

Nothing here runs at import time: the build happens at the first launch of
a kernel (or an explicit `library()` call), so a CPU-only machine without
`nvcc` imports the port freely.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("score_scan.cu", "convnext_trunk.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argument types (every one returns a cudaError_t)
SIGNATURES = {
    "ag_score_scan": [_P] * 9 + [_I, _I, _I, _P],
    "ag_score_backup": [_P] * 7 + [_I, _I, _I, _I, _P],
    "ag_score_scan_occupancy": [_I, _I, _I, _P],
    "ag_convnext_trunk": [_P] * 13 + [_I, _I, _I, _I, _I, _P],
    "ag_convnext_trunk_cluster": [_P] * 13 + [_I, _I, _I, _I, _I, _P],
    "ag_convnext_trunk_occupancy": [_I, _I, _I, _I, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path() -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libag_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile and link the kernels unless an up-to-date library exists.
    Raises RuntimeError with nvcc's output if a step fails.  The compiler's
    resource report (`-Xptxas -v`) is kept in `build.log` beside it."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in SOURCES:
        obj = BUILD_DIR / (Path(name).stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    log, objs, failed = [], [], []
    for name, obj, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {name}\n{out}")
        objs.append(str(obj))
        if proc.returncode != 0:
            failed.append(name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp = so.with_suffix(".tmp.so")
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *objs], capture_output=True, text=True
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}\n{link.stderr}")
    tmp.replace(so)
    (BUILD_DIR / "build.log").write_text("\n".join(log))
    return so


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.ag_error_string.argtypes = [ctypes.c_int]
    lib.ag_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a non-zero cudaError_t."""
    if err != 0:
        msg = library().ag_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: cudaError {err}: {msg}")
