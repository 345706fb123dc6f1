"""Build the port's native sources into shared libraries and load them.

Each `rave_tpu_torch/csrc/<name>.cu` has a plain C interface. At first use
it is compiled by `nvcc` for `sm_90a` into `build/kernels/` at the root of
the checkout (listed in .gitignore) and loaded with `ctypes`. The library
name carries a hash of the flags, the source and every header of `csrc/`
it includes (`#include "..."`, followed recursively), so an edited source
or header is rebuilt and a stale library is never loaded. Nothing here
runs at import time. The host sources, `csrc/<name>.cc` (the ARS batch
sampler), go the same way through `g++` (`build_host`), their hash also
covering what `-march=native` means on the host (`host_target`).

A library is compiled into a file of its own process's name and moved
into place with `os.replace`, so ranks of one host that build at once each
load a whole library.

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


# the flags of rave_tpu/data/native.py's build of the same sampler
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")


def sources(name: str, suffix: str = ".cu") -> list[Path]:
    """`csrc/<name><suffix>` and the files of `csrc/` it includes,
    recursively, in the order first reached."""
    found, todo = [], [CSRC / f"{name}{suffix}"]
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


def library_path(name: str, flags=NVCC_FLAGS, suffix: str = ".cu", target: bytes = b"") -> Path:
    digest = hashlib.sha256(" ".join(flags).encode() + target)
    for path in sources(name, suffix):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _compile(name: str, suffix: str, compiler: str, flags, libs=(), target: bytes = b"") -> Path:
    out = library_path(name, flags, suffix, target)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [compiler, *flags, "-o", str(tmp), str(CSRC / f"{name}{suffix}"), *libs],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"{Path(compiler).name} failed to build {name}{suffix}:\n"
                           f"{proc.stdout}{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def build(name: str) -> Path:
    """Compile `csrc/<name>.cu` unless an up-to-date library exists. The
    compiler's output (ptxas registers, shared memory, spills) is kept in a
    `.log` file beside the library."""
    return _compile(name, ".cu", nvcc(), NVCC_FLAGS)


def build_host(name: str) -> Path:
    """Compile the host source `csrc/<name>.cc` with g++ unless an
    up-to-date library exists; raises with the compiler's output."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: csrc/{name}.cc cannot be built")
    return _compile(name, ".cc", gxx, GXX_FLAGS, ("-lpthread",), host_target(gxx))


def host_target(gxx: str) -> bytes:
    """What `-march=native` means on this host, as g++ resolves it: part of
    a host library's hash, so a checkout shared by machines of different
    CPUs never loads another CPU's build."""
    proc = subprocess.run([gxx, "-march=native", "-Q", "--help=target"], capture_output=True)
    return proc.stdout


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(name)))
