"""Hold the bf16 attention forward's division (``csrc/div_rn.cuh``) against
the IEEE division on one GPU, for every pair of 23-bit mantissas.

    python -m theia_tpu_torch.tools.check_div_rn

Builds ``check_div_rn.cu`` with nvcc into ``theia_tpu_torch/_build/`` and
runs it: 2^46 quotients, about a minute on an H100. Exits nonzero if any
quotient differs or the card or nvcc is missing.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

from theia_tpu_torch.kernels import build


def main() -> int:
    source = Path(__file__).resolve().with_name("check_div_rn.cu")
    binary = build.BUILD_DIR / "check_div_rn"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc_path(), *build.ARCH_FLAGS, "-std=c++17", "-O3", "-I", str(build.PACKAGE_DIR / "csrc"),
                    "-o", str(binary), str(source)], check=True)
    return subprocess.run([str(binary)]).returncode


if __name__ == "__main__":
    sys.exit(main())
