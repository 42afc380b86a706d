"""Phase split of the fused trunk kernel on one GPU: how much of its time
each phase takes, found by timing copies of the kernel with one phase cut.

    python3 -m alphagomoku_tpu_torch.tools.trunk_phases DIR [DIR ...]

Each DIR is a checkout of this repo (or the repo itself); its
`alphagomoku_tpu_torch/csrc/convnext_trunk.cu` is copied into
`build/trunk_phases/` once whole and once per phase with that phase's
lines taken out, each copy is built by `nvcc` into a library of its own,
and all are timed here at B = 1280 on 15x15 boards: C = 64, L = 6 with
the flagship `network_23` weights, C = 128, L = 8 with the seeded 8x128
network (`chip_smoke.WIDE_SEED`) and, where the checkout has the wide
entry, C = 256, L = 8 with the seeded 8x256 network (`SHAPES_SEED`), each
on the stem's output of the bench boards.  A time is CUDA events around
20 launches back to back, median of 3 (as `chip_smoke.py` times the
trunk), and the whole source is timed
before and after its cut copies.  A phase's share is (whole - cut) /
whole: what the kernel saves without that phase.  Shares need not sum to
1, since phases overlap (across warps, and across CTAs where two share an
SM).  The copies compute wrong results; they exist only to be timed.

Phases: `staging` (copying the layer's weights into shared memory),
`depthwise` (7x7 depthwise + folded BN), `products` (both pointwise
products, bias, relu, residual, and the SE sums taken with them), `se`
(the squeeze-excitation gate), `scale` (the channel scale).  A source
marks a phase's lines with `// >> name` and `// << name` (every such
region is cut); the earlier layout of the kernel (one CTA per board with a
5-cell relu tile per warp), whose source has no marks, is cut at its phase
comments (`UNMARKED_CUTS`).  The last line printed is one JSON object with
every reading.
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
OUT_DIR = ROOT / "build" / "trunk_phases"
PHASES = ("staging", "depthwise", "products", "se", "scale")
_BARRIER = "__syncthreads();"
# the unmarked earlier layout: phase -> (its first line's text, the text of
# the first line after it that the cut keeps)
UNMARKED_CUTS = {
    "staging": ("// stage this layer's taps", _BARRIER),
    "depthwise": ("// depthwise 7x7 + folded BN", _BARRIER),
    "products": ("// pointwise, warp-local", _BARRIER),
    "se": ("// squeeze-excitation gate", "// channel scale"),
    "scale": ("// channel scale", _BARRIER),
}


def cut(source: str, phase: str) -> str:
    """`source` without the lines of `phase`."""
    lines = source.splitlines(keepends=True)
    if f"// >> {phase}" in source:
        out, inside = [], False
        for ln in lines:
            tag = ln.strip()
            if tag == f"// >> {phase}":
                inside = True
            elif tag == f"// << {phase}":
                inside = False
            elif not inside:
                out.append(ln)
        return "".join(out)
    start, end = UNMARKED_CUTS[phase]
    i = next(k for k, ln in enumerate(lines) if start in ln)
    j = next(k for k in range(i + 1, len(lines))
             if (lines[k].strip() == end if end == _BARRIER else end in lines[k]))
    return "".join(lines[:i] + lines[j:])


def build_variants(checkout: Path, tag: str) -> dict[str, Path]:
    """Build the whole source and each phase-cut copy (in parallel)."""
    from alphagomoku_tpu_torch.ops import _build

    src = (checkout / "alphagomoku_tpu_torch" / "csrc" / "convnext_trunk.cu").read_text()
    out = OUT_DIR / tag
    out.mkdir(parents=True, exist_ok=True)
    variants = {"whole": src, **{f"no_{p}": cut(src, p) for p in PHASES}}
    procs = {}
    for name, text in variants.items():
        cu = out / f"{name}.cu"
        cu.write_text(text)
        so = out / f"{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", str(cu), "-o", str(so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{tag}/{name}: nvcc failed\n{log[-3000:]}")
        if name == "whole":
            regs = re.findall(r"Used \d+ registers.*", log)
            print(f"{tag}: ptxas {regs}", flush=True)
        libs[name] = so
    return libs


def trunk_inputs(tags=("C64", "C128", "C256")):
    """(tag, x, TrunkWeights) at each built width of `tags`, B = 1280."""
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from alphagomoku_tpu_torch.game import vectorized as V
    from alphagomoku_tpu_torch.game.types import CROSS, GameRules
    from alphagomoku_tpu_torch.models.convert import network_from_flax
    from alphagomoku_tpu_torch.models.networks import create_network, init_random_
    from alphagomoku_tpu_torch.ops import convnext_fused as CF
    from alphagomoku_tpu_torch.patterns import features as FEAT
    from alphagomoku_tpu_torch.utils import checkpoint

    dev = torch.device("cuda")
    tables = V.device_tables(GameRules.FREESTYLE)
    boards = torch.from_numpy(cs.bench_boards(cs.BATCH)).to(dev)
    stm = torch.full((cs.BATCH,), CROSS, dtype=torch.int8, device=dev)
    nets = {
        "C64": network_from_flax(checkpoint.load(cs.CKPT)),
        "C128": init_random_(create_network("ConvNextPVQMraw", blocks=8, filters=128),
                             torch.Generator().manual_seed(cs.WIDE_SEED)),
        "C256": init_random_(create_network("ConvNextPVQMraw", blocks=8, filters=256),
                             torch.Generator().manual_seed(cs.SHAPES_SEED)),
    }
    nets = {tag: nets[tag] for tag in tags}
    with torch.no_grad():
        planes = FEAT.unpack_raw_planes(FEAT.encode(tables, boards, stm))
        for tag, net in nets.items():
            net = net.to(dev).eval()
            x = net.stem_forward(planes).permute(0, 2, 3, 1).contiguous()
            yield tag, x, CF.pack_trunk_weights(net)


def time_variant(so: Path, x, tw) -> float:
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from alphagomoku_tpu_torch.ops import _build
    from alphagomoku_tpu_torch.ops import convnext_fused as CF

    lib = ctypes.CDLL(str(so))
    b, h, w, c = x.shape
    plan = CF.trunk_plan(c, h, w)
    wide = plan.entry == "convnext_trunk_wide_kernel"
    name = "ag_convnext_trunk_wide" if wide else "ag_convnext_trunk"
    fn = getattr(lib, name)
    fn.argtypes = _build.SIGNATURES[name]
    fn.restype = ctypes.c_int
    out = torch.empty_like(x)
    args = (x.data_ptr(), *(t.data_ptr() for t in tw), out.data_ptr(), b, h, w, c,
            tw.dw.shape[0], *((plan.ctas,) if wide else ()),
            torch.cuda.current_stream().cuda_stream)

    def launch():
        err = fn(*args)
        if err:
            raise SystemExit(f"{so}: launch failed, cudaError {err}")

    return cs.time_cuda(lambda: [launch() for _ in range(20)], reps=3) / 20


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checkouts", type=Path, nargs="+")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trunk_phases: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    libs = {f"{i}_{d.resolve().name}": build_variants(d.resolve(), f"{i}_{d.resolve().name}")
            for i, d in enumerate(args.checkouts)}
    report = {}
    for width, x, tw in trunk_inputs():
        for tag, variants in libs.items():
            if width == "C256" and not hasattr(ctypes.CDLL(str(variants["whole"])),
                                               "ag_convnext_trunk_wide"):
                continue  # a checkout from before the wide entry
            whole = [time_variant(variants["whole"], x, tw)]
            cuts = {p: time_variant(variants[f"no_{p}"], x, tw) for p in PHASES}
            whole.append(time_variant(variants["whole"], x, tw))
            ref = sum(whole) / 2
            row = {"whole_ms": whole, "cut_ms": cuts,
                   "share": {p: (ref - ms) / ref for p, ms in cuts.items()}}
            row["share"]["rest"] = 1.0 - sum(row["share"].values())
            report[f"{tag} {width}"] = row
            print(f"{tag} {width}: " + json.dumps(row), flush=True)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
