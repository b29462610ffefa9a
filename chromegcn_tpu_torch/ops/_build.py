"""Build and load the port's hand-written CUDA kernels.

Each kernel library is one ``csrc/<name>.cu`` with a plain C interface
(``bsr_spmm``, ``gcn_fused``, ``gcn_fused_bwd``); it may include headers
from ``csrc/``. It is compiled with ``nvcc`` for ``sm_90a`` (Hopper) into a
shared library under ``build/kernels/`` at the repository root, at first
use, and loaded with ctypes. The library's file name carries a hash of its
source, of every ``csrc/`` header it includes, and of the nvcc flags, so an
edited kernel, header or flag is rebuilt and a stale build is never loaded.
Only the sources in this package are built.

Nothing here runs at import time: the CPU tests import every module of the
port on a machine without ``nvcc``.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional

from chromegcn_tpu_torch.utils import profiling

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Kernel launches per kernel name. Each wrapper adds one where it launches
# its kernel, and nowhere else, so a run can show that it went through the
# kernels (chip_smoke.py clears and reads these around the main path).
LAUNCHES: collections.Counter = collections.Counter()

_LOADED: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (neither on PATH nor under /usr/local/cuda/bin): "
            "the port's CUDA kernels cannot be built"
        )
    return nvcc


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.MULTILINE)


def sources(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and every file under ``csrc/`` it includes with
    ``#include "..."``, directly or through another header."""
    todo, seen = [(CSRC / f"{name}.cu").resolve()], []
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            dep = (path.parent / inc.decode()).resolve()
            if dep.is_file() and CSRC.resolve() in dep.parents:
                todo.append(dep)
    return seen


def library_path(name: str) -> Path:
    """The library's path, keyed on a hash of its sources (``sources``) and
    of NVCC_FLAGS, so a change to any of them is rebuilt and a stale build is
    never loaded."""
    h = hashlib.sha1()
    for path in sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update("\0".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(name: str) -> Optional[str]:
    """Compile kernel ``name``; returns nvcc's output (``-Xptxas -v`` reports
    registers, shared memory and spills), or None if it was already built.
    Raises RuntimeError if the build fails."""
    nvcc = find_nvcc()
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"kernel build failed: {name}: nvcc exited {proc.returncode}\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    (BUILD_DIR / f"lib{name}.log").write_text(log)
    return log


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if needed (cached); the
    first load in a process is a ``kernel_load`` span."""
    lib = _LOADED.get(name)
    if lib is None:
        with profiling.span("kernel_load", name=name):
            build(name)
            lib = ctypes.CDLL(str(library_path(name)))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _LOADED[name] = lib
    return lib


def check(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise if a kernel's C entry returned a CUDA error."""
    if code != 0:
        msg = lib.kernel_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code} ({msg})")
