"""Compare the machine code of kernel sources between two trees.

Builds each named source of ``painlessinferenceacceleration_tpu_torch/
csrc/`` from this tree and from another (an unpacked parent commit) with
the port's nvcc flags, disassembles both with ``cuobjdump -sass`` and
compares them kernel by kernel, after dropping what only names a function
(its mangled name, the anonymous namespace's hash). Prints one JSON line
per source: the kernels found on each side and those whose code differs.
Exits 1 when a kernel's code differs or a kernel is missing on one side.

    python3 tools/sass_diff.py --other build/parent [int4_gemm grouped_int4_gemm]

Needs ``nvcc`` and ``cuobjdump`` (the CUDA toolkit); writes its builds
under ``build/sass_diff/``.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))

from painlessinferenceacceleration_tpu_torch import _build  # noqa: E402

CSRC = Path("painlessinferenceacceleration_tpu_torch") / "csrc"


def kernels(lib: Path, cuobjdump: str) -> dict:
    """Mangled kernel name without its namespace hash -> its SASS lines."""
    text = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = re.sub(r"_GLOBAL__N__[0-9a-f_]+", "_GLOBAL__N_", m.group(1))
            out[name] = []
        elif name is not None and line.strip():
            out[name].append(re.sub(r"_GLOBAL__N__[0-9a-f_]+", "_GLOBAL__N_", line.strip()))
    return out


def build(root: Path, source: str, dest: Path) -> Path:
    dest.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(dest),
                    str(root / CSRC / f"{source}.cu")], check=True)
    return dest


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, required=True,
                    help="root of the other tree (holds painlessinferenceacceleration_tpu_torch/csrc)")
    ap.add_argument("sources", nargs="*", default=["int4_gemm", "grouped_int4_gemm"])
    args = ap.parse_args()
    cuobjdump = str(Path(_build._nvcc()).with_name("cuobjdump"))
    out_dir = HERE / "build" / "sass_diff"
    failed = False
    for source in args.sources:
        here = kernels(build(HERE, source, out_dir / f"{source}.this.so"), cuobjdump)
        other = kernels(build(args.other, source, out_dir / f"{source}.other.so"), cuobjdump)
        differ = sorted(k for k in here.keys() & other.keys() if here[k] != other[k])
        missing = sorted(here.keys() ^ other.keys())
        failed |= bool(differ or missing)
        print(json.dumps(dict(source=source, kernels_this=len(here), kernels_other=len(other),
                              identical=len(here.keys() & other.keys()) - len(differ),
                              differ=differ, missing_on_one_side=missing)))
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
