"""Build and locate the port's native artifact host (csrc/rtpu_host.cc).

The counterpart of rave_tpu/export/native_host.py. `rtpu_host` is the
port's nn~/VST analog (reference scripts/export.py:586 and the out-of-repo
nn_tilde C++ consumers): a Python-free program over libtorch that loads a
`.rtpu` artifact's TorchScript step programs (`<method>_step.ts`, written
by export.py beside the `.pt2`) and streams audio block by block on the
device the artifact was exported on, its state resident there between
blocks. Nothing is compiled at load: a TorchScript program runs the ATen
kernels its trace recorded. On the card each step program is served as one
CUDA graph, the counterpart of the JAX host's one compiled executable per
block: its first call warms the program up twice on a side stream and
captures it over static buffers (the state tensors, the block, the seed),
and every block after it is a copy in and a replay. On the CPU the steps
run eagerly through the TorchScript interpreter, writing the new state into
the same state tensors in place. `info` and every streaming command say
which ran (`steps: cuda graph, 1 capture, 32 replays`).

The program is compiled with g++ against the installed torch wheel at
first use (`ensure_host`) into `build/host/rtpu_host-<hash>` at the root of
the checkout (listed in .gitignore); the hash covers the source, the
command line and the torch version, so an edited source or another wheel
is rebuilt and a stale binary never runs. The build takes torch's include
and library paths from `torch.utils.cpp_extension`, the C++ standard that
module compiles extensions with, and `-D_GLIBCXX_USE_CXX11_ABI` as the
wheel was built. On a CUDA wheel it compiles the graph path
(`-DRTPU_HOST_CUDA_GRAPHS`) against the CUDA toolkit's headers
(`$CUDA_HOME/include`: `ATen/cuda/CUDAGraph.h` includes the runtime's), and
raises naming `CUDA_HOME` where they are not found, so a CUDA wheel never
gets a host without graphs; it links `libtorch_cuda` and `libc10_cuda`
with `--no-as-needed`: a linker that drops a library the host names no
symbol of leaves the CUDA backend unregistered (the first CUDA tensor
raises "Could not run ... with the CUDA backend"). A failed build raises
with g++'s output; there is no prebuilt binary.

`write_state` / `read_state` read and write the host's state files
(rtpu_host's `RTPUST01` layout: the magic, the leaf count, then each
leaf's byte size and raw bytes in the order of `aot.<method>.state_leaves`):
export.py writes each program's initial state so, and `--save-state` /
`--load-state` carry a stream's state across processes.

    python -m rave_tpu_torch.export.native_host    # build; print the path
"""
from __future__ import annotations

import hashlib
import inspect
import os
import re
import shutil
import struct
import subprocess
from pathlib import Path
from typing import List, Sequence

import torch

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "rave_tpu_torch" / "csrc" / "rtpu_host.cc"
BUILD_DIR = ROOT / "build" / "host"
STATE_MAGIC = b"RTPUST01"


def cxx_standard() -> str:
    """The `-std=` flag that torch.utils.cpp_extension compiles extensions with."""
    from torch.utils import cpp_extension

    found = re.search(r"-std=(c\+\+\d+)", inspect.getsource(cpp_extension))
    return f"-std={found.group(1) if found else 'c++17'}"


def build_command(out: Path) -> List[str]:
    """The g++ command that builds the host into `out`."""
    from torch.utils import cpp_extension

    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the artifact host cannot be built")
    lib = cpp_extension.TORCH_LIB_PATH
    cmd = [gxx, cxx_standard(), "-O2", "-DNDEBUG",
           f"-D_GLIBCXX_USE_CXX11_ABI={int(torch.compiled_with_cxx11_abi())}"]
    for inc in cpp_extension.include_paths():
        cmd += ["-isystem", inc]
    if torch.version.cuda is not None:
        cuda_include = Path(cpp_extension.CUDA_HOME or "") / "include"
        if cpp_extension.CUDA_HOME is None or not (cuda_include / "cuda_runtime_api.h").is_file():
            raise RuntimeError("the CUDA toolkit's headers are not found (CUDA_HOME): "
                               f"{SOURCE.name} cannot be built with its CUDA graphs")
        cmd += ["-DRTPU_HOST_CUDA_GRAPHS", "-isystem", str(cuda_include)]
    cmd += ["-o", str(out), str(SOURCE), "-L", lib]
    if torch.version.cuda is not None:
        cmd += ["-Wl,--no-as-needed", "-ltorch_cuda", "-lc10_cuda", "-Wl,--as-needed"]
    return cmd + ["-ltorch", "-ltorch_cpu", "-lc10", "-ldl", f"-Wl,-rpath,{lib}"]


def host_path() -> Path:
    """Where the host built from this source, command and torch lives."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(build_command(Path("rtpu_host"))).encode())
    digest.update(torch.__version__.encode())
    return BUILD_DIR / f"rtpu_host-{digest.hexdigest()[:16]}"


def ensure_host(timeout: float = 900.0) -> str:
    """The host's path, built first if this source has no binary yet; raises
    with g++'s output if the build fails."""
    out = host_path()
    if out.exists():
        return str(out)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(build_command(tmp), capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build {SOURCE.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent caller runs a whole binary
    return str(out)


def write_state(path, tensors: Sequence[torch.Tensor]) -> None:
    """`tensors` as a host state file, each leaf's bytes as it lies in memory."""
    parts = [STATE_MAGIC, struct.pack("<Q", len(tensors))]
    for t in tensors:
        raw = t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
        parts += [struct.pack("<Q", len(raw)), raw]
    Path(path).write_bytes(b"".join(parts))


def read_state(path, like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """A host state file as CPU tensors of the shapes and dtypes of `like`."""
    raw = Path(path).read_bytes()
    if raw[:8] != STATE_MAGIC:
        raise ValueError(f"{path} is not a host state file")
    (n,), pos, out = struct.unpack_from("<Q", raw, 8), 16, []
    if n != len(like):
        raise ValueError(f"{path} holds {n} state leaves, expected {len(like)}")
    for t in like:
        (size,) = struct.unpack_from("<Q", raw, pos)
        leaf = torch.frombuffer(bytearray(raw[pos + 8:pos + 8 + size]), dtype=torch.uint8)
        out.append(leaf.view(t.dtype).reshape(t.shape))
        pos += 8 + size
    return out


if __name__ == "__main__":
    print(ensure_host())
