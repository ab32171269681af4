"""The instruction mix of the port's CUDA kernels, read from their machine
code, and the least time it lets a kernel take.

    python -m runmat_tpu_torch.sass [--kernel NAME]

Builds `csrc/*.cu` as the wrappers do (`ops/_build.py`), disassembles the
library with the CUDA toolkit's `cuobjdump -sass` and, for each kernel,
counts the instructions of its main loop: the span of its outermost
backward branch, which in the Threefry kernels is one counter block per
thread. It prints, per kernel, the loop's instructions by pipe and the
cycles one warp needs per iteration on one SM sub-partition (SMSP) of an
H100 (`loop_cycles`): the largest of one issue slot per instruction, two
cycles per integer-ALU instruction (16 lanes), two per FP64 instruction
(16 lanes) and eight per MUFU instruction (4 lanes). `chip_smoke.py` turns
that into a bound: warp iterations x `loop_cycles` over 4 SMSPs x 132 SMs
x the 1.98 GHz boost clock. Needs the card's toolkit (nvcc, cuobjdump).
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
from pathlib import Path

# the base opcode (before the first '.') -> pipe
PIPES = {
    "alu": {"IADD3", "LOP3", "SHF", "ISETP", "SEL", "PRMT", "LEA", "IABS",
            "BMSK", "FLO", "POPC", "IMNMX", "VIADD", "BREV", "SGXT", "FSETP",
            "FSEL", "FMNMX", "P2R", "R2P", "PLOP3"},
    "fma": {"FFMA", "FMUL", "FADD", "IMAD", "HFMA2", "FSWZADD"},
    "fp64": {"DADD", "DMUL", "DFMA", "DSETP"},
    "mufu": {"MUFU"},
    "memory": {"LDG", "STG", "LDS", "STS", "LD", "ST", "ATOMS", "ATOMG",
               "RED", "LDC", "ULDC", "LDGSTS"},
}
# cycles one warp instruction holds its pipe on one SMSP
PIPE_CYCLES = {"alu": 2, "fp64": 2, "mufu": 8}

_FUNC = re.compile(r"Function : (\S+)")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                   r"([A-Z][A-Z0-9_]*)(\.[A-Z0-9_.]+)?\s*([^;]*);")


def cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    from .ops._build import nvcc
    return str(Path(nvcc()).with_name("cuobjdump"))


def disassemble() -> str:
    from .ops._build import library, library_path
    library()
    return subprocess.run([cuobjdump(), "-sass", str(library_path())],
                          capture_output=True, text=True, check=True).stdout


def kernels(sass: str) -> dict:
    """{mangled name: [(address, opcode, operands)]}"""
    out: dict = {}
    current = None
    for line in sass.splitlines():
        m = _FUNC.search(line)
        if m:
            current = out.setdefault(m.group(1), [])
            continue
        m = _INSN.search(line)
        if m and current is not None:
            current.append((int(m.group(1), 16), m.group(2), m.group(4)))
    return out


def main_loop(insns: list) -> list:
    """The instructions of the outermost loop: from the target of the
    backward branch that spans the most code to that branch."""
    best = None
    for addr, op, operands in insns:
        if op != "BRA":
            continue
        m = re.search(r"0x([0-9a-f]+)", operands)
        if m is None:
            continue
        target = int(m.group(1), 16)
        if target < addr and (best is None
                              or addr - target > best[1] - best[0]):
            best = (target, addr)
    if best is None:
        return insns
    return [i for i in insns if best[0] <= i[0] <= best[1]]


def mix(loop: list) -> dict:
    counts = {p: 0 for p in PIPES}
    counts["other"] = 0
    for _, op, _ in loop:
        pipe = next((p for p, ops in PIPES.items() if op in ops), "other")
        counts[pipe] += 1
    total = len(loop)
    cycles = max([total] + [counts[p] * c for p, c in PIPE_CYCLES.items()])
    return {"instructions": total, **counts, "loop_cycles": cycles}


def loop_mixes() -> dict:
    """{mangled kernel name: the mix of its main loop}"""
    return {k: mix(main_loop(v)) for k, v in kernels(disassemble()).items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", default="", help="part of a kernel's name")
    args = ap.parse_args()
    for name, m in sorted(loop_mixes().items()):
        if args.kernel in name:
            print(json.dumps({"kernel": name, **m}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
