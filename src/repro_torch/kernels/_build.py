"""Build a kernel's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each kernel directory keeps its sources under ``csrc/`` with a plain C
interface.  They are compiled at first use on the card, for ``sm_90a``,
into ``src/repro_torch/_build/`` (listed in ``.gitignore``) under a name
keyed by the sources' content hash, so an edited source never loads a
stale library.  ptxas's report of each kernel's registers, shared memory
and spills (``-Xptxas -v``) is kept beside it (``ptxas_report``).  Nothing is built when a module is imported: the CPU tests
import every module and this machine may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "load_library", "ptxas_report"]

BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.is_file():
        return str(default)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; cannot build the kernels")


def load_library(name: str, sources: list[Path]) -> ctypes.CDLL:
    """Compile ``sources`` into ``_build/<name>-<hash>.so`` unless built, and load it."""
    digest = hashlib.sha256()
    for src in sources:
        digest.update(Path(src).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    so = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
    if not so.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {name} ({proc.returncode}):\n{proc.stderr}"
                )
            so.with_suffix(".ptxas.txt").write_text(proc.stderr)
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return ctypes.CDLL(str(so))


def ptxas_report(so: Path) -> list[dict]:
    """Per kernel of a built library: registers, static shared memory, spills,
    and whether ptxas serialized its wgmma (``wgmma_serialized``: each
    mma_async then waits for the one before, so nothing overlaps it)."""
    out, name, spill = [], None, (0, 0)
    text = Path(so).with_suffix(".ptxas.txt").read_text()
    serialized = set(re.findall(r"wgmma\.mma_async instructions are serialized.*?'(\S+?)'", text))
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spill = m.group(1), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            out.append({"kernel": name, "registers": int(m.group(1)),
                        "static_smem": int(smem.group(1)) if smem else 0,
                        "spill_stores": spill[0], "spill_loads": spill[1],
                        "wgmma_serialized": name in serialized})
            name = None
    return out
