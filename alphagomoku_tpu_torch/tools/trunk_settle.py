"""Why the trunk kernel settles its products, and what that costs:
copies of the kernel that sum the products otherwise, each held against
the plain version and timed on one GPU, at both widths.

    python3 -m alphagomoku_tpu_torch.tools.trunk_settle

Copies of `alphagomoku_tpu_torch/csrc/convnext_trunk.cu`, each with one
change, are built into `build/trunk_settle/` (never into the package):
  as_is     the kernel as it is (settle bound kErr = u);
  tc_only   the settle path off: the tensor cores' sums alone;
  provable  kErr at the provable bound (K + K/16 + 40) u;
  half_u    kErr = u / 2;
  reversed  settle off and no tensor cores: each k16 step's 16 products
            summed on CUDA cores in descending k, that is the plain
            version's order reversed within each step (slow: it only
            shows what another order of the same f32 sums does).
Each runs the seeded 8x128 trunk (`chip_smoke.WIDE_SEED`, C = 128, L = 8)
and the network_23 trunk (C = 64, L = 6) on the stem's output of the
bench boards (B = 1280), as `trunk_phases` does; each result is held
against `fused_trunk_plain` under TRUNK_LIMITS (share of elements
differing, share over 2 ulps), over the whole batch and, as the engine
evaluates them, board by board (the first `PER_BOARD` boards each alone:
how many are over the limits, and the largest share differing).  A time
is CUDA events around 20 launches, median of 3, at B = 1280 and at B = 1.
First, how often `torch.matmul` in f32 leaves the plain version's
k-ascending sum, on each trunk's first w1 at 225, 400 and all rows.  The settle variants are also built with
a counter of the outputs they sum again (`settled`, over all 2*B*H*W*C*L
product outputs of one launch); the times come from the builds without
it.  The last line printed is one JSON object with every reading.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

from .trunk_phases import ROOT, time_variant, trunk_inputs

OUT_DIR = ROOT / "build" / "trunk_settle"
SOURCE = ROOT / "alphagomoku_tpu_torch" / "csrc" / "convnext_trunk.cu"
K_ERR = "constexpr float kErr = 5.9604645e-8f;"
EXACT = "static constexpr bool kExact = true;"
MMA_DOC = "// d += a (16x16, row) * b (16x8, col)"

_REVERSED_MMA = r"""__device__ __forceinline__ float bf16_half(uint32_t r, int hi) {
  return hi ? __uint_as_float(r & 0xffff0000u) : __uint_as_float(r << 16);
}
// the m16n8k16 product of the fragments on CUDA cores: each output's 16
// products (exchanged by shuffles) summed from k = 15 down to 0
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int k = 15; k >= 0; --k) {
    const int src = (k & 7) >> 1, hi = k >> 3, e = k & 1;
    const uint32_t ra0 = __shfl_sync(~0u, hi ? a[2] : a[0], 4 * g + src);
    const uint32_t ra1 = __shfl_sync(~0u, hi ? a[3] : a[1], 4 * g + src);
    const uint32_t rb0 = __shfl_sync(~0u, hi ? b1 : b0, 8 * t + src);
    const uint32_t rb1 = __shfl_sync(~0u, hi ? b1 : b0, 8 * t + 4 + src);
    const float a0 = bf16_half(ra0, e), a1 = bf16_half(ra1, e);
    const float c0 = bf16_half(rb0, e), c1 = bf16_half(rb1, e);
    d[0] = fmaf(a0, c0, d[0]);
    d[1] = fmaf(a0, c1, d[1]);
    d[2] = fmaf(a1, c0, d[2]);
    d[3] = fmaf(a1, c1, d[3]);
  }
}

"""


def _replace(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"trunk_settle: the kernel source no longer has {old!r}")
    return text.replace(old, new)


def variants(src: str) -> dict[str, str]:
    no_settle = _replace(src, EXACT, "static constexpr bool kExact = false;")
    mma = no_settle.index(MMA_DOC)
    after = no_settle.index("__device__ __forceinline__ uint32_t pack_bf16")
    return {
        "as_is": src,
        "tc_only": no_settle,
        # (K + K/16 + 40) u at K = C = 128 (an upper bound at C = 64 too)
        "provable": _replace(src, K_ERR, "constexpr float kErr = 176 * 5.9604645e-8f * 1.01f;"),
        "half_u": _replace(src, K_ERR, "constexpr float kErr = 0.5f * 5.9604645e-8f;"),
        "reversed": no_settle[:mma] + _REVERSED_MMA + no_settle[after:],
    }


def counted(src: str) -> str:
    """`src` with a device counter of the outputs settle() sums again."""
    src = _replace(src, "namespace {\n", (
        "__device__ unsigned long long ag_settled;\n"
        "extern \"C\" unsigned long long ag_take_settled() {\n"
        "  unsigned long long v = 0, z = 0;\n"
        "  cudaMemcpyFromSymbol(&v, ag_settled, sizeof(v));\n"
        "  cudaMemcpyToSymbol(ag_settled, &z, sizeof(z));\n"
        "  return v;\n}\nnamespace {\n"))
    return _replace(src, "    flags &= flags - 1;\n",
                    "    flags &= flags - 1;\n    atomicAdd(&ag_settled, 1ull);\n")


def build(sources: dict[str, str]) -> dict[str, Path]:
    from alphagomoku_tpu_torch.ops import _build

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu, so = OUT_DIR / f"{name}.cu", OUT_DIR / f"{name}.so"
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", str(cu), "-o", str(so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{log[-3000:]}")
        libs[name] = so
    return libs


def run_once(so: Path, x, tw):
    import torch

    from alphagomoku_tpu_torch.ops import _build

    fn = ctypes.CDLL(str(so)).ag_convnext_trunk
    fn.argtypes = _build.SIGNATURES["ag_convnext_trunk"]
    fn.restype = ctypes.c_int
    out = torch.empty_like(x)
    b, h, w, c = x.shape
    err = fn(x.data_ptr(), *(t.data_ptr() for t in tw), out.data_ptr(), b, h, w, c,
             tw.dw.shape[0], torch.cuda.current_stream().cuda_stream)
    if err:
        raise SystemExit(f"{so}: launch failed, cudaError {err}")
    return out


PER_BOARD = 256
# the widths studied: the one-CTA kernels' (the wide entry's settle reads
# its weights from global memory, and the counter counts settle() alone)
ONE_CTA = ("C64", "C128")


def main() -> int:
    import torch

    from alphagomoku_tpu_torch.ops import convnext_fused as CF
    from alphagomoku_tpu_torch.utils.bf16 import agreement

    if not torch.cuda.is_available():
        print("trunk_settle: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    plain = variants(SOURCE.read_text())
    settling = ("as_is", "provable", "half_u")
    libs = build({**plain, **{f"{n}_counted": counted(plain[n]) for n in settling}})
    report = {}
    # the plain version's products sum k ascending (`_products`); how often
    # the library's f32 matmul leaves that order, at one board's rows (15x15,
    # 20x20) and at the batch's, on this checkpoint's and seed's weights
    for tag, x, tw in trunk_inputs(ONE_CTA):
        c = x.shape[-1]
        a = x.reshape(-1, c).float()
        for rows in (225, 400, a.shape[0]):
            ar = a[:rows] if rows <= a.shape[0] else a
            share = float(((ar @ tw.w1[0].float()) != CF._products(ar, tw.w1[0].float()))
                          .float().mean())
            report[f"{tag}.matmul_rows_{rows}"] = share
            print(f"{tag}: torch.matmul leaves the k-ascending sum in {share:.4f} of the f32 "
                  f"outputs at {rows} rows", flush=True)
    for tag, x, tw in trunk_inputs(ONE_CTA):
        ref = CF.fused_trunk_plain(x, tw)
        outputs = 2 * x.numel() * tw.dw.shape[0]
        x1 = x[:1].contiguous()
        for name in plain:
            out = run_once(libs[name], x, tw)
            held = agreement(ref, out, **CF.TRUNK_LIMITS)
            boards = [agreement(ref[i:i + 1], out[i:i + 1], **CF.TRUNK_LIMITS)
                      for i in range(PER_BOARD)]
            fast = name != "reversed"
            row = {"share_differ": held["share_differ"], "share_over_2ulps": held["share_over"],
                   "within_trunk_limits": held["ok"],
                   "boards_over_limits": sum(not b["ok"] for b in boards),
                   "max_board_share_differ": max(b["share_differ"] for b in boards),
                   "ms": time_variant(libs[name], x, tw) if fast else None,
                   "ms_b1": time_variant(libs[name], x1, tw) if fast else None}
            if name in settling:
                lib = ctypes.CDLL(str(libs[f"{name}_counted"]))
                lib.ag_take_settled.restype = ctypes.c_ulonglong
                lib.ag_take_settled()
                run_once(libs[f"{name}_counted"], x, tw)
                torch.cuda.synchronize()
                row["settled"] = lib.ag_take_settled() / outputs
            report[f"{tag}.{name}"] = row
            print(f"{tag} {name}: " + json.dumps(row), flush=True)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
