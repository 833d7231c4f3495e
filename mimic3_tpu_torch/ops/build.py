"""Build a kernel source of ``csrc/`` into a shared library with ``nvcc``.

Each kernel module (``ops/stage.py``, ``ops/resblock.py``) compiles its
own ``.cu`` file at first use into a git-ignored build directory, keyed
by a hash of the source and of every header it includes from ``csrc/``,
and binds it with ``ctypes``.  The library has
a plain C interface, so no PyTorch header is compiled.  Next to each
library a ``.log`` keeps what ``ptxas -v`` printed (registers, shared
memory and spills per kernel).  :func:`refuse_autograd` is the launchers'
shared guard against recording a launch in an autograd graph.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
import typing
from pathlib import Path

import torch

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


_INCLUDE_RE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def source_files(source: Path) -> typing.List[Path]:
    """``source`` and the headers it includes with ``#include "..."``,
    transitively, resolved beside the file that includes them."""
    files: typing.List[Path] = []
    todo = [source.resolve()]
    while todo:
        path = todo.pop()
        if path in files:
            continue
        files.append(path)
        for name in _INCLUDE_RE.findall(path.read_bytes()):
            todo.append((path.parent / name.decode()).resolve())
    return files


def library_path(source: Path, build_dir: Path) -> Path:
    """``<build_dir>/lib<stem>_<hash>.so``, the hash taken over the source
    and every header it includes, so a changed header is never served
    from a library built before the change."""
    digest = hashlib.sha256()
    for path in source_files(source):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return build_dir / f"lib{source.stem}_{digest.hexdigest()[:16]}.so"


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


def refuse_autograd(name: str, *tensors_or_trees) -> None:
    """Raise when autograd would record through a kernel launch.

    A kernel writes through ``ctypes`` into a preallocated output, which
    autograd takes for a constant: a gradient would be cut without a
    word.  So with grad mode on, an input or weight (a tensor, or the
    tensors of a parameter dict or list of them) that requires grad is
    refused; train with the plain path (``stage_max_channels=0``).
    """
    if not torch.is_grad_enabled():
        return

    def leaves(obj):
        if isinstance(obj, torch.Tensor):
            yield obj
        elif isinstance(obj, dict):
            for v in obj.values():
                yield from leaves(v)
        elif isinstance(obj, (list, tuple)):
            for v in obj:
                yield from leaves(v)

    if any(t.requires_grad for obj in tensors_or_trees for t in leaves(obj)):
        raise RuntimeError(
            f"{name}: an input or weight requires grad, and the kernel "
            "launch would cut the gradient; use the plain path to train"
        )
