"""Build the port's CUDA sources into shared libraries and load them.

Each `rave_tpu_torch/csrc/<name>.cu` has a plain C interface. At first use
it is compiled by `nvcc` for `sm_90a` into `build/kernels/` at the root of
the checkout (listed in .gitignore) and loaded with `ctypes`. The library
name carries a hash of the flags, the source and every header of `csrc/`
it includes (`#include "..."`, followed recursively), so an edited source
or header is rebuilt and a stale library is never loaded. Nothing here
runs at import time.

The libraries link only the CUDA runtime. The kernels' TMA descriptors are
made by `cuTensorMapEncodeTiled`, a function of the driver API: the source
reaches it at run time through the runtime's `cudaGetDriverEntryPoint`, so
no `-lcuda` is needed. No CUTLASS or CuTe header is used, so no CUTLASS
include path is passed.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc() -> str:
    """Path of nvcc: on PATH, else under the CUDA toolkit torch was told of."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def sources(name: str) -> list[Path]:
    """`csrc/<name>.cu` and the files of `csrc/` it includes, recursively,
    in the order first reached."""
    found, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            dep = (path.parent / inc.decode()).resolve()
            if dep.is_file() and CSRC in dep.parents:
                todo.append(dep)
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile `csrc/<name>.cu` unless an up-to-date library exists. The
    compiler's output (ptxas registers, shared memory, spills) is kept in a
    `.log` file beside the library."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {name}.cu:\n{proc.stdout}{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(name)))
