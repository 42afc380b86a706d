"""Where the scan kernels' time goes on one GPU: copies of
`csrc/score_scan.cu` with its chain cut, beside two yardsticks.

    python3 -m alphagomoku_tpu_torch.tools.scan_phases DIR [DIR ...]

Each DIR is a checkout of this repo (or the repo itself).  Its
`alphagomoku_tpu_torch/csrc/score_scan.cu` is built whole and, where the
source marks its chain (`// >> chain` ... `// << chain`), once more with
the chain cut: each level then passes p on through a cheap mix of the same
inputs (`CHAIN_CUT`), so the stage-3 shuffles stay; and, where the source
has the wide kernels' per-warp depth dispatch (kL = 4, 8 or kWideD levels
a chunk, up to the deepest valid one), once more with every chunk run at
kWideD (`one_kL`, which computes the same results).  Built once from this
repo's own source: `floor`, a kernel with score_scan's grid that loads each
row's start score and stores its row, and `invert_chain`, a warp per row
that applies invert_up 16 or 64 times in a row to its start score (the
chain's own latency).  Every copy goes into a library of its own under
`build/scan_phases/`, built in parallel.

All are timed by their device time per launch as torch.profiler traces it
(`chip_smoke.kernel_device_ms`, 50 launches), on chip_smoke.py's inputs:
score_scan at R = 1280, D = 16, K = 32 (and at R = 128, where each SM
holds about one warp, so no warp waits for another's issue); score_backup
on chip_smoke's random trees at B = 1280, N = 808, with the paths as drawn
(`full`) and cut to their first 3 levels (`shallow`, as deep as the
flagship search's paths).  A checkout whose library has no score_backup
(one from before it existed) times score_scan only.  The wide kernels
(K > 32) are timed, in a checkout whose source has them (none before
they existed), on `WIDE_SCAN` and `WIDE_BACKUP`: score_scan on random rows at the 9x9
leaf-batch step's shape (R = 1,024, K = 81, D = 16) and on
chip_smoke.py phase 21's inputs (R = 1,280), and score_backup on phase
21's random trees (B = 1,280, 64 nodes).  Each whole
copy is checked bit-equal against the plain versions; the cut copies
compute wrong results and exist only to be timed.  The last line printed
is one JSON object with every reading, in microseconds.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
OUT_DIR = ROOT / "build" / "scan_phases"
SOURCE = Path("alphagomoku_tpu_torch") / "csrc" / "score_scan.cu"
# what a cut chain does at each level: the same inputs, mixed without the
# dependent arithmetic
CHAIN_CUT = ("    if (lane == d) seen = p;\n"
             "    p ^= f[d] ^ best_d[d] ^ inv_u[d] ^ inv_p[d] ^ inv_old[d];\n")
# the wide kernels' shapes: score_scan (R, K, D), score_backup (K, D), the
# inputs drawn as chip_smoke.py draws them (phase 21's seed K + D)
# (K = 81, D = 8 is the --selfcheck search's own depth)
WIDE_SCAN = ((1024, 81, 16), (1280, 33, 16), (1280, 33, 32), (1280, 81, 8), (1280, 81, 16),
             (1280, 81, 32), (1280, 225, 16), (1280, 225, 32), (1280, 400, 16))
WIDE_BACKUP = tuple((K, D) for _, K, D in WIDE_SCAN[1:])
# a wide chunk's call of its levels at a depth below kWideD
WIDE_DISPATCH = re.compile(r"\b(AG_WIDE(?:_BACKUP)?_LEVELS)\((?:4|8)\)")
# the yardsticks, appended to this repo's source (they use its invert_up
# and kWarps)
YARDSTICKS = r"""
namespace {
__global__ void __launch_bounds__(kWarps * 32) scan_floor_kernel(
    const int32_t* __restrict__ start, int32_t* __restrict__ out, int R, int D) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= R) return;
  const int lane = threadIdx.x & 31;
  const int s = start[row];
  if (lane < D) out[row * D + lane] = s;
}
template <int kReps>
__global__ void __launch_bounds__(kWarps * 32) invert_chain_kernel(
    const int32_t* __restrict__ start, int32_t* __restrict__ out, int R) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= R) return;
  int p = start[row];
#pragma unroll
  for (int i = 0; i < kReps; ++i) p = invert_up(p);
  if ((threadIdx.x & 31) == 0) out[row] = p;
}
}  // namespace

extern "C" int ag_scan_floor(const void* start, void* out, int R, int D, void* stream) {
  scan_floor_kernel<<<(R + kWarps - 1) / kWarps, kWarps * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(start), static_cast<int32_t*>(out), R, D);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ag_invert_chain(const void* start, void* out, int R, int reps, void* stream) {
  auto kernel = reps == 64 ? &invert_chain_kernel<64> : &invert_chain_kernel<16>;
  kernel<<<(R + kWarps - 1) / kWarps, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(start), static_cast<int32_t*>(out), R);
  return static_cast<int>(cudaGetLastError());
}
"""


def cut_chain(source: str) -> str:
    """`source` with the marked chain replaced by CHAIN_CUT."""
    out, inside = [], False
    for ln in source.splitlines(keepends=True):
        tag = ln.strip()
        if tag == "// >> chain":
            inside = True
            out.append(CHAIN_CUT)
        elif tag == "// << chain":
            inside = False
        elif not inside:
            out.append(ln)
    return "".join(out)


def one_kl(source: str) -> str:
    """`source` with the wide kernels' depth dispatch taken out: each
    branch runs the chunk's full kWideD levels."""
    return WIDE_DISPATCH.sub(r"\1(kWideD)", source)


def variants(checkout: Path) -> dict[str, str]:
    """The copies built from one checkout's source."""
    src = (checkout / SOURCE).read_text()
    found = {"whole": src}
    if "// >> chain" in src:
        found["no_chain"] = cut_chain(src)
    if WIDE_DISPATCH.search(src):
        found["one_kL"] = one_kl(src)
    return found


def build(sources: dict[str, str]) -> dict[str, Path]:
    """Build each source into a library of its own (in parallel)."""
    from alphagomoku_tpu_torch.ops import _build

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu = OUT_DIR / f"{name}.cu"
        cu.write_text(text)
        so = OUT_DIR / f"{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", str(cu), "-o", str(so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{log[-3000:]}")
        regs = re.findall(r"Used \d+ registers[^\n]*", log)
        print(f"{name}: ptxas {regs}", flush=True)
        libs[name] = so
    return libs


def _fn(lib, name: str, argtypes):
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checkouts", type=Path, nargs="+")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("scan_phases: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from alphagomoku_tpu_torch.ops import _build
    from alphagomoku_tpu_torch.ops import score_scan as SSM

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    sources = {"yardsticks": (ROOT / SOURCE).read_text() + YARDSTICKS}
    for i, d in enumerate(args.checkouts):
        for name, text in variants(d.resolve()).items():
            sources[f"{i}_{d.resolve().name}_{name}"] = text
    has_wide = {name: "score_scan_wide_kernel" in text and "score_backup_wide_kernel" in text
                for name, text in sources.items()}
    libs = {name: ctypes.CDLL(str(so)) for name, so in build(sources).items()}

    dev = torch.device("cuda")
    R, D, K, N = cs.BATCH, 16, 32, 808
    scan_args = [torch.from_numpy(a).to(dev) for a in cs.random_scan_inputs(R, D, K, seed=0)]
    ref_e, ref_ns = SSM.score_scan_plain(*scan_args)
    names = ("edge_score", "edge_action", "node_complete", "node_score", "pn", "ps",
             "start_score")
    full = {k: torch.from_numpy(v).to(dev)
            for k, v in cs.random_backup_inputs(R, N, D, K, seed=1).items()}
    shallow = {k: t.clone() for k, t in full.items()}
    shallow["pn"][:, 3:] = -1
    shallow["ps"][:, 3:] = -1
    ref_tree = {k: t.clone() for k, t in full.items()}
    SSM.score_backup_plain(*(ref_tree[k] for k in names))
    stream = torch.cuda.current_stream().cuda_stream
    e = torch.empty((R, D), dtype=torch.int32, device=dev)
    n = torch.empty_like(e)
    us = {}
    wide_scan = {}
    for rows, k, d in WIDE_SCAN:
        a = [torch.from_numpy(x).to(dev)
             for x in cs.random_scan_inputs(rows, d, k, seed=1 if rows == 1024 else k + d)]
        wide_scan[rows, k, d] = a, SSM.score_scan_plain(*a)
    wide_backup = {}
    for k, d in WIDE_BACKUP:
        tree = {name: torch.from_numpy(v).to(dev) for name, v in
                cs.random_backup_inputs(R, cs.WIDE_NODES, d, k, k + d).items()}
        ref = {name: t.clone() for name, t in tree.items()}
        SSM.score_backup_plain(*(ref[name] for name in names))
        wide_backup[k, d] = tree, ref

    def device_us(call, kernel: str) -> float:
        if call() != 0:
            raise SystemExit(f"{kernel}: launch failed")
        return cs.kernel_device_ms(call, kernel, reps=50) * 1e3

    for name, lib in libs.items():
        if name == "yardsticks":
            continue
        scan = _fn(lib, "ag_score_scan", _build.SIGNATURES["ag_score_scan"])
        row = {}
        for rows in (R, 128):
            def call(rows=rows):
                return scan(*[a.data_ptr() for a in scan_args], e.data_ptr(), n.data_ptr(),
                            rows, D, K, stream)
            row[f"score_scan_R{rows}"] = device_us(call, "score_scan_kernel")
        torch.cuda.synchronize()
        row["score_scan_bit_equal"] = bool(torch.equal(e, ref_e) and torch.equal(n, ref_ns))
        if hasattr(lib, "ag_score_backup"):
            backup = _fn(lib, "ag_score_backup", _build.SIGNATURES["ag_score_backup"])
            for tag, tree in (("full", full), ("shallow", shallow)):
                t = {k: v.clone() for k, v in tree.items()}

                def bcall(t=t):
                    return backup(*[t[k].data_ptr() for k in names], R, N, D, K, stream)
                if tag == "full":
                    bcall()
                    torch.cuda.synchronize()
                    row["score_backup_bit_equal"] = all(torch.equal(t[k], ref_tree[k])
                                                        for k in names)
                row[f"score_backup_{tag}"] = device_us(bcall, "score_backup_kernel")
        if has_wide[name]:
            equal = True
            for (rows, k, d), (a, (want_e, want_ns)) in wide_scan.items():
                got_e = torch.empty((rows, d), dtype=torch.int32, device=dev)
                got_ns = torch.empty_like(got_e)

                def wcall(a=a, got_e=got_e, got_ns=got_ns, rows=rows, k=k, d=d):
                    return scan(*[x.data_ptr() for x in a], got_e.data_ptr(), got_ns.data_ptr(),
                                rows, d, k, stream)
                row[f"wide_scan_R{rows}_K{k}_D{d}"] = device_us(wcall, "score_scan_wide_kernel")
                torch.cuda.synchronize()
                equal &= bool(torch.equal(got_e, want_e) and torch.equal(got_ns, want_ns))
            backup = _fn(lib, "ag_score_backup", _build.SIGNATURES["ag_score_backup"])
            for (k, d), (tree, ref) in wide_backup.items():
                t = {name: v.clone() for name, v in tree.items()}

                def wbcall(t=t, k=k, d=d):
                    return backup(*[t[name].data_ptr() for name in names], R, cs.WIDE_NODES, d, k,
                                  stream)
                wbcall()
                torch.cuda.synchronize()
                equal &= all(torch.equal(t[name], ref[name]) for name in names)
                row[f"wide_backup_K{k}_D{d}"] = device_us(wbcall, "score_backup_wide_kernel")
            row["wide_bit_equal"] = equal
        us[name] = row
        print(f"{name}: {json.dumps(row)}", flush=True)

    lib = libs["yardsticks"]
    floor = _fn(lib, "ag_scan_floor", [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                + [ctypes.c_void_p])
    chain = _fn(lib, "ag_invert_chain", [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                + [ctypes.c_void_p])
    start = scan_args[0]
    row = {}
    for rows in (R, 128):
        row[f"floor_R{rows}"] = device_us(
            lambda rows=rows: floor(start.data_ptr(), e.data_ptr(), rows, D, stream),
            "scan_floor_kernel")
        for reps in (16, 64):
            row[f"invert_chain{reps}_R{rows}"] = device_us(
                lambda rows=rows, reps=reps: chain(start.data_ptr(), e.data_ptr(), rows, reps,
                                                   stream), "invert_chain_kernel")
    us["yardsticks"] = row
    print(f"yardsticks: {json.dumps(row)}", flush=True)
    print(json.dumps(us), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
