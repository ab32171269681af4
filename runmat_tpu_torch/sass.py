"""The instruction mix of the port's CUDA kernels, read from their machine
code, and the least time it lets a kernel take.

    python -m runmat_tpu_torch.sass [--kernel NAME]

Builds `csrc/*.cu` as the wrappers do (`ops/_build.py`), disassembles the
library with the CUDA toolkit's `cuobjdump -sass` and, for each kernel,
counts the instructions of its main loop: the span of its outermost
backward branch. One iteration of it stores `store_bytes` of output (a
counter block's two floats in the uniform f32 kernel, two blocks' four
values in the normal f32 kernel), so a call of n values of size b runs
n*b/store_bytes thread iterations. That count is what runs only where the
loop holds no code it may skip: a loop with a call or a local-memory access
(libm's range-check slow paths, such as the Payne-Hanek reduction of
sinf/cosf, or spilled registers) gets no bound (`warp_cycles` raises). The
Threefry kernels hold none. It prints, per kernel, the loop's instructions
by pipe and the cycles one warp needs per iteration on one SM
sub-partition (SMSP) of an H100 (`loop_cycles`): the largest of one issue
slot per instruction, two cycles per integer-ALU instruction (16 lanes),
two per FP64 instruction (16 lanes) and eight per MUFU instruction (4
lanes); and each kernel's loads, DFMAs and FFMAs (`load_order`).
`chip_smoke.py` and `rngbench.py` turn the loop into a bound: warp
iterations x `loop_cycles` over 4 SMSPs x 132 SMs x the 1.98 GHz boost
clock. `ptx_ops` counts a source's contracted float32 FMAs in its PTX.
Needs the card's toolkit (nvcc, cuobjdump).
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
# the least time the card could take (NVIDIA H100 SXM data sheet): HBM3 at
# 3.35 TB/s; warp cycles on 4 sub-partitions of each of 132 SMs at the
# 1.98 GHz boost clock
BYTES_PER_S = 3.35e12
WARP_CYCLES_PER_S = 4 * 132 * 1.98e9

_FUNC = re.compile(r"Function : (\S+)")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?"
                   r"([A-Z][A-Z0-9_]*)(\.[A-Z0-9_.]+)?\s*([^;]*);")
# bytes a global store writes per thread, by its width suffix
_STORE_BYTES = {".128": 16, ".64": 8}
# instructions after which a loop's static count may not be what runs
_MAY_SKIP = {"CALL", "STL", "LDL"}


def cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    from runmat_tpu_torch.ops._build import nvcc
    return str(Path(nvcc()).with_name("cuobjdump"))


def bound(nbytes: float, cycles: float = 0.0) -> tuple:
    """(bound_ms, bound_by): bytes over the memory rate against warp cycles
    over the card's rate for them, whichever is larger."""
    by_bytes = nbytes / BYTES_PER_S * 1e3
    by_ops = cycles / WARP_CYCLES_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def _library_tool(*args: str) -> str:
    from runmat_tpu_torch.ops._build import library, library_path
    library()
    return subprocess.run([cuobjdump(), *args, str(library_path())],
                          capture_output=True, text=True, check=True).stdout


def resources() -> dict:
    """{mangled name: {"REG": registers a thread, "STACK": bytes of its
    local-memory frame, ...}} from `cuobjdump -res-usage`."""
    out: dict = {}
    current = None
    for line in _library_tool("-res-usage").splitlines():
        m = re.search(r"Function (\S+?):?\s*$", line)
        if m:
            current = m.group(1)
            continue
        if current is not None and "REG:" in line:
            out[current] = {k: int(v) for k, v in
                            re.findall(r"([A-Z]+):(\d+)", line)}
            current = None
    return out


def resident_warps(registers: int, threads: int = 256) -> int:
    """Warps an SM holds of a kernel with `registers` a thread in blocks of
    `threads`: 64K registers, allocated 8 a thread at a time, and at most
    2048 threads."""
    per_block = -(-registers // 8) * 8 * threads
    blocks = min(65536 // per_block, 2048 // threads)
    return blocks * threads // 32


def disassemble() -> str:
    """The machine code of the package's library, built first if needed.
    The import is absolute, so `rngbench.py` reads the library of the
    checkout it imported."""
    return _library_tool("-sass")


def kernels(sass: str) -> dict:
    """{mangled name: [(address, opcode, modifiers, operands)]}"""
    out: dict = {}
    current = None
    for line in sass.splitlines():
        m = _FUNC.search(line)
        if m:
            current = out.setdefault(m.group(1), [])
            continue
        m = _INSN.search(line)
        if m and current is not None:
            current.append((int(m.group(1), 16), m.group(3),
                            m.group(4) or "", m.group(5)))
    return out


def _target(operands: str):
    m = re.search(r"0x([0-9a-f]+)", operands)
    return None if m is None else int(m.group(1), 16)


def main_loop(insns: list) -> list:
    """The instructions of the outermost loop: from the target of the
    backward branch that spans the most code to that branch."""
    best = None
    for addr, op, _, operands in insns:
        target = _target(operands) if op == "BRA" else None
        if target is None:
            continue
        if target < addr and (best is None
                              or addr - target > best[1] - best[0]):
            best = (target, addr)
    if best is None:
        return insns
    return [i for i in insns if best[0] <= i[0] <= best[1]]


def mix(loop: list) -> dict:
    counts = {p: 0 for p in PIPES}
    counts["other"] = 0
    store_bytes = 0
    for _, op, mods, _ in loop:
        pipe = next((p for p, ops in PIPES.items() if op in ops), "other")
        counts[pipe] += 1
        if op == "STG":
            store_bytes += next((b for suffix, b in _STORE_BYTES.items()
                                 if mods.endswith(suffix)), 4)
    cycles = max([len(loop)]
                 + [counts[p] * c for p, c in PIPE_CYCLES.items()])
    return {"instructions": len(loop), **counts, "loop_cycles": cycles,
            "store_bytes": store_bytes,
            "calls_or_local": sum(i[1] in _MAY_SKIP for i in loop)}


def warp_cycles(m: dict, n: int, itemsize: int) -> float:
    """Warp cycles of a call that writes n values of `itemsize` bytes with a
    kernel whose loop mix is `m`: n * itemsize / store_bytes thread
    iterations, 32 to a warp. Refuses a loop that holds a call or local
    memory: its static count need not be what runs."""
    if m["calls_or_local"]:
        raise ValueError(f"sass: the loop holds {m['calls_or_local']} calls "
                         f"or local-memory accesses; its count is no bound")
    return n * itemsize / m["store_bytes"] / 32 * m["loop_cycles"]


def find(mixes: dict, name: str, even: bool | None = None,
         device_counter: bool = False) -> tuple:
    """(mangled name, mix) of the kernel whose name holds `name`; where
    its template has an even/odd variant (`<bool kEvenM>`), the one for
    `even`; where it has a counter-source variant (`<int kFrom>`), the one
    that reads its counter from device memory or not."""
    found = [(k, m) for k, m in mixes.items() if name in k]
    if len(found) > 1 and even is not None and \
            any("ILb" in k for k, _ in found):
        found = [(k, m) for k, m in found
                 if ("ILb1E" if even else "ILb0E") in k]
    if len(found) > 1:
        found = [(k, m) for k, m in found
                 if f"Li{int(device_counter)}E" in k]
    if len(found) != 1:
        raise LookupError(f"sass: {len(found)} kernels match {name!r}")
    return found[0]


def tail_loads(insns: list) -> dict:
    """The tail of a kernel whose blocks count themselves at an arrival
    counter (`csrc/spcg.cu`): from its atomic add on, the loads through L2
    (`__ldcg`, `LDG ... STRONG.GPU`) issued before the first float64 add,
    which are in flight together, and all the tail's such loads and
    float64 adds in the code."""
    start = next((k for k, (_, op, _, _) in enumerate(insns)
                  if op in ("ATOM", "ATOMG")), None)
    if start is None:
        raise LookupError("sass: the kernel has no atomic add")
    tail = insns[start:]
    first_add = next((k for k, i in enumerate(tail) if i[1] == "DADD"),
                     len(tail))
    loads = [k for k, (_, op, mods, _) in enumerate(tail)
             if op == "LDG" and "STRONG.GPU" in mods]
    return {"loads_before_first_add": sum(k < first_add for k in loads),
            "loads": len(loads),
            "adds": sum(i[1] == "DADD" for i in tail)}


def load_order(insns: list) -> dict:
    """A kernel's loads from device memory (`LDG`, and `LD` through a
    generic address, as a relaxed load of one scalar compiles; `ldg128`
    the 16-byte ones), how many of them come before its first float64 FMA
    (`DFMA`) in the code, its DFMAs and its float32 FMAs (`FFMA`, which
    IEEE division and square root expand into): the optimizer update
    (`csrc/optim.cu`) issues its loads before the bias corrections'
    pows."""
    first = next((k for k, i in enumerate(insns) if i[1] == "DFMA"),
                 len(insns))
    loads = [(k, mods) for k, (_, op, mods, _) in enumerate(insns)
             if op in ("LDG", "LD")]
    return {"ldg": len(loads), "ldg_before_dfma": sum(k < first
                                                      for k, _ in loads),
            "ldg128": sum(".128" in mods for _, mods in loads),
            "dfma": sum(i[1] == "DFMA" for i in insns),
            "ffma": sum(i[1] == "FFMA" for i in insns)}


def ptx_ops(source: str, ops: tuple = ("fma.rn.f32", "div.rn.f32",
                                       "sqrt.rn.f32")) -> dict:
    """{kernel entry: {op: count}} in the PTX nvcc makes of `csrc/<source>`
    with the package's flags: where a float32 product and sum were
    contracted, the PTX holds an `fma.rn.f32` (ptxas keeps `mul.rn` and
    `add.rn` apart; the FFMAs of the machine code may be an IEEE division's
    own)."""
    from runmat_tpu_torch.ops._build import BUILD_DIR, CSRC, nvcc
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"{Path(source).stem}.ptx"
    subprocess.run([nvcc(), "-arch=sm_90a", "-std=c++17", "-O3", "-ptx",
                    "-o", str(out), str(CSRC / source)], check=True,
                   capture_output=True, text=True)
    counts: dict = {}
    current = None
    for line in out.read_text().splitlines():
        m = re.search(r"\.entry\s+(\S+?)\(", line)
        if m:
            current = counts.setdefault(m.group(1), dict.fromkeys(ops, 0))
            continue
        if current is not None:
            m = re.match(r"\s*(?:@!?%p\d+\s+)?([a-z0-9.]+)\s", line)
            if m and m.group(1) in current:
                current[m.group(1)] += 1
    return counts


def loop_mixes() -> dict:
    """{mangled kernel name: the mix of its main loop}"""
    return {k: mix(main_loop(v)) for k, v in kernels(disassemble()).items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", default="", help="part of a kernel's name")
    args = ap.parse_args()
    res = resources()
    for name, insns in sorted(kernels(disassemble()).items()):
        if args.kernel in name:
            print(json.dumps({"kernel": name, **mix(main_loop(insns)),
                              **load_order(insns),
                              "resources": res.get(name, {})}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
