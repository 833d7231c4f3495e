"""Build a kernel source of ``csrc/`` into a shared library with ``nvcc``.

Each kernel module (``ops/stage.py``, ``ops/resblock.py``) compiles its
own ``.cu`` file at first use into a git-ignored build directory, keyed
by a hash of the source, and binds it with ``ctypes``.  The library has
a plain C interface, so no PyTorch header is compiled.  Next to each
library a ``.log`` keeps what ``ptxas -v`` printed (registers, shared
memory and spills per kernel).
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
BUILD_DIR = PACKAGE_DIR.parent / "build" / "mimic3_tpu_torch"


def find_nvcc() -> str:
    """nvcc on PATH, else under $CUDA_HOME (default /usr/local/cuda)."""
    nvcc = shutil.which("nvcc")
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if nvcc is None and (home / "bin" / "nvcc").is_file():
        nvcc = str(home / "bin" / "nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def library_path(source: Path, build_dir: Path) -> Path:
    """``<build_dir>/lib<stem>_<hash of the source>.so``."""
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    return build_dir / f"lib{source.stem}_{digest}.so"


def compile_library(source: Path, out: Path) -> None:
    """Compile ``source`` for sm_90a into ``out`` (atomically) unless it
    exists.  Raises if nvcc is missing or the build fails."""
    if out.is_file():
        return
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [
        nvcc,
        "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-Xptxas", "-v",
        "-o", str(tmp), str(source),
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"building {source.name} failed:\n{proc.stderr}")
    os.replace(tmp, out)
