"""Whether named kernels of a source under `csrc/` compile to the same SASS
in two checkouts.

    python3 -m alphagomoku_tpu_torch.tools.sass_diff OLD_DIR NEW_DIR [KERNEL ...]
        [--source score_scan.cu | convnext_trunk.cu]

Each DIR is a checkout of this repo.  Its
`alphagomoku_tpu_torch/csrc/<source>` (default `score_scan.cu`) is
compiled to a cubin with the port's nvcc flags (`ops/_build.py`), under
`build/sass_diff/`, and disassembled with `cuobjdump -sass`.  Each KERNEL
(a part of the mangled name) must name one function in both; its
instructions are compared line by line.  The default kernels: for
`score_scan.cu` the K <= 32 instantiations, `score_scan_kernel<16>`,
`<32>`, `score_backup_kernel<16>`, `<32>`; for `convnext_trunk.cu` the
one-CTA trunk kernels `convnext_trunk_kernel<64>` and `<128>`.  Prints one
line per kernel and exits 1 if any differs.

The K <= 32 kernels and the wide ones share device helpers (the chain,
`finish_levels`; the `ld_*` loads; `invert_up`), so an edit made for the
wide kernels can change the narrow ones, which every search launches.
Run this against the parent checkout on any change to the shared code:
identical SASS shows the narrow kernels untouched without timing them.
The same holds for the one-CTA trunk kernels and the cluster entry of
`convnext_trunk.cu`, which share its device functions.
"""

from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
OUT_DIR = ROOT / "build" / "sass_diff"
CSRC = Path("alphagomoku_tpu_torch") / "csrc"
NARROW = ("score_scan_kernelILi16E", "score_scan_kernelILi32E", "score_backup_kernelILi16E",
          "score_backup_kernelILi32E")
DEFAULT_KERNELS = {
    "score_scan.cu": NARROW,
    "convnext_trunk.cu": ("convnext_trunk_kernelILi64E", "convnext_trunk_kernelILi128E"),
}


def functions(sass: str) -> dict[str, list[str]]:
    """cuobjdump -sass output split by function: mangled name -> its
    instruction lines (from the first `/*0000*/`), blanks collapsed, in
    order."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name is not None and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            # runs of blanks collapsed: cuobjdump pads the encoding's column
            # by more than the instruction (the padding follows the names)
            out[name].append(" ".join(line.split()))
    return out


def pick(funcs: dict[str, list[str]], part: str) -> tuple[str, list[str]]:
    hits = [n for n in funcs if part in n]
    if len(hits) != 1:
        raise SystemExit(f"{part}: {len(hits)} functions match: {hits}")
    return hits[0], funcs[hits[0]]


def sass_of(checkout: Path, tag: str, source: str = "score_scan.cu") -> dict[str, list[str]]:
    from alphagomoku_tpu_torch.ops import _build

    nvcc = _build._nvcc()
    cuobjdump = shutil.which("cuobjdump") or str(Path(nvcc).with_name("cuobjdump"))
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC", "-Xptxas", "-v")]
    cubin = OUT_DIR / f"{tag}_{Path(source).stem}.cubin"
    subprocess.run([nvcc, *flags, "-cubin", str(checkout / CSRC / source), "-o", str(cubin)],
                   check=True)
    return functions(subprocess.run([cuobjdump, "-sass", str(cubin)], check=True,
                                    capture_output=True, text=True).stdout)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old", type=Path)
    ap.add_argument("new", type=Path)
    ap.add_argument("kernels", nargs="*")
    ap.add_argument("--source", choices=sorted(DEFAULT_KERNELS), default="score_scan.cu")
    args = ap.parse_args()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    old = sass_of(args.old.resolve(), "old", args.source)
    new = sass_of(args.new.resolve(), "new", args.source)
    same_all = True
    for part in args.kernels or DEFAULT_KERNELS[args.source]:
        (old_name, a), (new_name, b) = pick(old, part), pick(new, part)
        same = a == b
        same_all &= same
        first = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
        print(f"{part}: {'identical' if same else 'DIFFERENT'} SASS, {len(a)} / {len(b)} "
              f"instructions" + ("" if same else f", first difference at line {first}: "
                                 f"{a[first] if first < len(a) else '-'} | "
                                 f"{b[first] if first < len(b) else '-'}"), flush=True)
    return 0 if same_all else 1


if __name__ == "__main__":
    sys.exit(main())
