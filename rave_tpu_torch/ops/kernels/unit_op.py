"""The fused unit as a registered torch op: csrc/unit_op.cc's build and its caller.

`torch.jit.trace` and `torch.export` record what goes through the
dispatcher. The ctypes launch of `dilated_unit._forward` does not: a trace
of it sees a pad and an empty buffer, never the kernel that fills it, and a
saved program would return uninitialised memory. So a model that is traced
or exported (`models/blocks.py::FusedDilatedResidual`) calls the unit as
the op `rave_tpu_torch::dilated_unit` instead, which a saved program holds
as one node per unit and runs wherever this library is loaded: the plain
version on the CPU, the Hopper kernel of csrc/dilated_unit.cu on the card
(the same C entry, launched as `_forward` launches it, under the plan that
`kernel_plan` picked on the exporting card, baked into the trace as ints).

The library is compiled by g++ against the installed torch at first use
(`load_unit_op`) into `build/kernels/librtpu_unit_op-<hash>.so` at the
root of the checkout (listed in .gitignore); the hash covers the source,
the command line (the kernel library's name in it, itself hashed) and the
torch version, so an edited source or another wheel is rebuilt. On a CUDA
wheel it links the kernel library that `build.build("dilated_unit")`
compiles with nvcc for sm_90a, found beside it at run time (rpath
$ORIGIN), so the two travel together; a kernel library that cannot be
built raises with nvcc's output, and a failed g++ build raises with its
own. On a CPU wheel it holds the CPU and Meta implementations only. The
library links torch (and, on a CUDA wheel, the kernel library); no
prebuilt binary exists. Nothing here builds or loads at import time.
"""
from __future__ import annotations

import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional

import torch

from rave_tpu_torch.ops.kernels import build

SOURCE = build.CSRC / "unit_op.cc"
NAME = "rtpu_unit_op"
NAMESPACE = "rave_tpu_torch"


def kernel_library() -> Optional[Path]:
    """The kernel library the op library links on a CUDA wheel (built by nvcc
    if it is not yet); None on a CPU wheel."""
    return build.build("dilated_unit") if torch.version.cuda is not None else None


def build_command(out: Path, kernel: Optional[Path]) -> List[str]:
    """The g++ command that builds the op library into `out`, linking
    `kernel` (the kernel library) when it is given."""
    from torch.utils import cpp_extension

    from rave_tpu_torch.export.native_host import cxx_standard

    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: csrc/{SOURCE.name} cannot be built")
    lib = cpp_extension.TORCH_LIB_PATH
    cmd = [gxx, cxx_standard(), "-O2", "-DNDEBUG", "-shared", "-fPIC",
           f"-D_GLIBCXX_USE_CXX11_ABI={int(torch.compiled_with_cxx11_abi())}"]
    for inc in cpp_extension.include_paths():
        cmd += ["-isystem", inc]
    if kernel is not None:
        if cpp_extension.CUDA_HOME is None:
            raise RuntimeError("the CUDA toolkit's headers are not found (CUDA_HOME): "
                               f"csrc/{SOURCE.name} cannot be built for the card")
        cmd += ["-DRTPU_UNIT_CUDA", "-isystem", str(Path(cpp_extension.CUDA_HOME) / "include")]
    cmd += ["-o", str(out), str(SOURCE), "-L", lib]
    if kernel is not None:
        cmd += ["-L", str(kernel.parent), f"-l:{kernel.name}", "-Wl,-rpath,$ORIGIN",
                "-ltorch_cuda", "-lc10_cuda"]
    return cmd + ["-ltorch", "-ltorch_cpu", "-lc10", f"-Wl,-rpath,{lib}"]


def library_path(kernel: Optional[Path]) -> Path:
    """Where the op library built from this source, command and torch lives."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(build_command(Path(NAME), kernel)).encode())
    digest.update(torch.__version__.encode())
    return build.BUILD_DIR / f"lib{NAME}-{digest.hexdigest()[:16]}.so"


def ensure_library() -> Path:
    """The op library's path, built first if this source has no library yet;
    raises with the compiler's output if a build fails."""
    kernel = kernel_library()
    out = library_path(kernel)
    if out.exists():
        return out
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(build_command(tmp, kernel), capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build {SOURCE.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def registered() -> bool:
    """Whether a library of this op is loaded in this process."""
    return hasattr(torch.ops.rave_tpu_torch, "dilated_unit")


@functools.cache
def load_unit_op() -> str:
    """Build the op library if needed, load it into this process, and return
    its path. A process holds one library of the namespace (a second copy's
    registration would raise): where one is loaded already, a portable
    program's copy, that one serves."""
    path = ensure_library()
    if not registered():
        torch.ops.load_library(str(path))
    return str(path)


def launches() -> int:
    """The CUDA kernel launches the loaded op library made since it was loaded."""
    return torch.ops.rave_tpu_torch.dilated_unit_launches()


def op_plan(x: torch.Tensor, w1: torch.Tensor, dilation: int, pad_left: int) -> List[int]:
    """The plan the op runs `x` under: `kernel_plan`'s on a CUDA tensor, as
    ints; empty on the CPU."""
    if x.device.type != "cuda":
        return []
    from rave_tpu_torch.nn.streaming import static_shape
    from rave_tpu_torch.ops.kernels.dilated_unit import kernel_plan

    B, C, T = static_shape(x)
    p = kernel_plan(B, C, T, static_shape(w1)[2], dilation, pad_left, x.dtype == torch.bfloat16,
                    x.device.index)
    return [int(v) for v in p]


def unit_op(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, dilation: int, pad_left: int,
            pad_right: int) -> torch.Tensor:
    """x [B, C, T]; w1 [C, C, K]; w2 [C, C] -> y [B, C, T] through the op
    (loaded first if it is not): the kernel on a CUDA tensor, the plain
    version on the CPU. No autograd: the traced programs run inference."""
    load_unit_op()
    return torch.ops.rave_tpu_torch.dilated_unit(x, w1, w2, dilation, pad_left, pad_right,
                                                 op_plan(x, w1, dilation, pad_left))
