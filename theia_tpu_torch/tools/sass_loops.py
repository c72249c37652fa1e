"""Count the machine instructions of the port's kernels and of their loops.

    python -m theia_tpu_torch.tools.sass_loops [KERNEL ...]

Builds the kernels (``kernels/build.py``), disassembles the library with
``cuobjdump -sass`` (from the CUDA toolkit beside nvcc) and prints, for each
named kernel (as ``tools/timing.py`` names them, ``flash_fwd_bf16<64>`` by
default), its instruction count and, for each loop (a backward branch whose
span holds no EXIT: ptxas places cold code past the end and branches back
from there), the instructions from its head to its branch and their most
common opcodes. A loop's count is static: code under a branch inside it
counts whether it runs or not. Needs nvcc and cuobjdump, not a GPU.
"""

from __future__ import annotations

import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

from theia_tpu_torch.tools.timing import kernel_name

DEFAULT_KERNELS = ("flash_fwd_bf16<64>",)
_INSTRUCTION = re.compile(r"/\*([0-9a-f]{4,6})\*/\s+(.*?)\s*;")
_BRANCH = re.compile(r"\bBRA\b.*?0x([0-9a-f]+)")
_PREDICATE = re.compile(r"^@!?U?P\w+\s+")


def functions(sass: str) -> dict[str, str]:
    """``cuobjdump -sass`` output -> {kernel name: its disassembly}."""
    out = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        mangled, _, body = part.partition("\n")
        out[kernel_name(mangled.strip())] = body
    return out


def instructions(body: str) -> list[tuple[int, str]]:
    """(address, instruction text without its predicate guard) in order."""
    return [(int(a, 16), _PREDICATE.sub("", text)) for a, text in _INSTRUCTION.findall(body)]


def opcode(text: str) -> str:
    return text.split()[0]


def loops(ins: list[tuple[int, str]]) -> list[tuple[int, int, Counter]]:
    """(head address, branch address, opcode counts) of each backward
    branch's span that holds no EXIT."""
    out = []
    for address, text in ins:
        m = _BRANCH.search(text)
        if m and int(m.group(1), 16) < address:
            head = int(m.group(1), 16)
            counts = Counter(opcode(t) for a, t in ins if head <= a <= address)
            if "EXIT" not in counts:
                out.append((head, address, counts))
    return out


def report(name: str, body: str, top: int = 16) -> list[str]:
    ins = instructions(body)
    lines = [f"{name}: {len(ins)} instructions"]
    for head, end, counts in loops(ins):
        mix = ", ".join(f"{k} {v}" for k, v in counts.most_common(top))
        lines.append(f"  loop {head:#x}..{end:#x}: {sum(counts.values())} instructions; {mix}")
    return lines


def main() -> int:
    from theia_tpu_torch.kernels import build

    wanted = sys.argv[1:] or list(DEFAULT_KERNELS)
    lib = build.build()
    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True, capture_output=True, text=True).stdout
    found = functions(sass)
    missing = [k for k in wanted if k not in found]
    for kernel in wanted:
        if kernel in found:
            print("\n".join(report(kernel, found[kernel])))
    if missing:
        print(f"sass_loops: not in {lib.name}: {missing}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
