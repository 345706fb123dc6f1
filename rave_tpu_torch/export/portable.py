"""Portable full-graph export: the offline forward as one saved program.

The counterpart of rave_tpu/export/portable.py, which writes the offline
forward `encode -> reparametrize -> decode` as an AOT-lowered StableHLO
module with the weights baked in, taking only `(x, seed)`, for any PJRT or
StableHLO consumer. The port writes the same forward as a TorchScript
program (`forward.ts`, `torch.jit.trace`: every `TracerWarning` an error,
`check_trace` on; export.py::trace_program) and as a `torch.export`
program (`forward.pt2`), for every family, stereo included:

    forward(x[batch, n_channels, n_signal] float32, seed int64) -> y

`seed` is an int64 scalar holding a uint32. The draws come from it as the
artifact's step programs draw theirs (utils/rng.py, counter-based): the
variational noise with `ENCODE_SALT`, the augmentation channels with
`DECODE_SALT`, the noise synth's uniforms with `SYNTH_SALT`. The layout is
the port's, channels before time; rave_tpu's program takes [batch, n_signal,
n_channels] (the manifest says so).

Each leaky-ReLU residual unit is one node of the registered op
`rave_tpu_torch::dilated_unit` (ops/kernels/unit_op.py): the saved program
launches the Hopper kernel on the card, under the plan picked on the
exporting card, and the plain version on the CPU. The op library (and, on
a CUDA wheel, the kernel library it links) is copied beside the programs; a
consumer loads it before the program: `torch.ops.load_library(<dir>/<op
library>)` then `torch.jit.load(<dir>/forward.ts)` in Python, dlopen then
`torch::jit::load` in C++. No Python package of the port is needed to run
it. Run it with TorchScript's graph optimizations off
(`torch.jit.optimized_execution(False)`; `setGraphExecutorOptimize(false)`
in C++): it then runs the ATen kernels it recorded from its first call,
where the profiling executor's first calls take tens of seconds at full
width and may fuse ops. The convolutions are traced with TF32 off (a trace records the backend
flags of each convolution), so the program computes in float32 wherever it
runs. A program exported on the card holds its weights there and runs only
there (`load_portable` refuses another device, naming both).

Not written: rave_tpu's best-effort TF SavedModel bridge, which it skips
where TensorFlow is absent (ROADMAP).
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Optional

import torch
from torch import nn

from rave_tpu_torch import config as config_lib
from rave_tpu_torch.export.artifact import DECODE_SALT, ENCODE_SALT, SYNTH_SALT
from rave_tpu_torch.export.export import trace_program
from rave_tpu_torch.factory import resolve_device
from rave_tpu_torch.models.blocks import LatentDraws
from rave_tpu_torch.nn.streaming import static_shape
from rave_tpu_torch.ops.kernels import unit_op
from rave_tpu_torch.train.loop import fp32_exact
from rave_tpu_torch.utils.checkpoint import load_run
from rave_tpu_torch.utils.rng import normal_from_seed, uniform_from_seed

FORMAT = "rtpu-torch-portable-v1"
LAYOUT = ("[batch, n_channels, n_signal] (channels before time); rave_tpu's portable "
          "program takes and returns [batch, n_signal, n_channels]")


class PortableForward(nn.Module):
    """`(x [B, C, T], seed) -> y [B, C, T']`: the model's offline forward
    with its draws made from `seed` (an int64 scalar holding a uint32)."""

    def __init__(self, model: nn.Module, cfg):
        super().__init__()
        self.model, self.cfg = model, cfg

    def forward(self, x: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
        cfg, model = self.cfg, self.model
        z = model.encode(x)
        B, _, T = static_shape(z)
        fam, draws = cfg.latent.family, LatentDraws()
        if fam == "variational":
            draws.eps = normal_from_seed(seed, (B, cfg.latent_size, T), ENCODE_SALT)
        aug = cfg.latent.noise_augmentation if fam in ("wasserstein", "discrete") else 0
        if aug:
            draws.noise = normal_from_seed(seed, (B, aug, T), DECODE_SALT)
        if fam == "wasserstein":  # its reparametrize also draws for the MMD, which y never reads
            zs = z if not aug else torch.cat([z, draws.noise.to(z.dtype)], dim=1)
        else:
            zs, _ = model.reparametrize(z, draws)
        shape = cfg.noise_shape(static_shape(x)[1], B, T)
        uniform = None if shape is None else uniform_from_seed(seed, shape, SYNTH_SALT)
        return model.decode(zs, uniform)


def unit_nodes(traced: torch.jit.ScriptModule) -> int:
    """The `rave_tpu_torch::dilated_unit` nodes of a traced program."""
    return sum(node.kind() == f"{unit_op.NAMESPACE}::dilated_unit"
               for node in traced.inlined_graph.nodes())


def _specs(tensors) -> list:
    return [{"shape": [int(d) for d in t.shape], "dtype": str(t.dtype).removeprefix("torch.")}
            for t in tensors]


def export_portable(run: str, n_signal: int = 131072, batch: int = 1,
                    output: Optional[str] = None, device: str | torch.device = "cuda") -> str:
    """Trace the offline forward of run `run` at `batch` x `n_signal` on
    `device` into `<output or run dir>/<name>_portable/` (`write_portable`);
    returns the directory."""
    cfg, model, n_channels, run_dir = load_run(run, device=resolve_device(device))
    return write_portable(cfg, model, n_channels, Path(output or run_dir), n_signal, batch)


def write_portable(cfg, model: nn.Module, n_channels: int, output: Path, n_signal: int,
                   batch: int) -> str:
    """`model` (eval mode, on its device) traced at `batch` x `n_signal` into
    `output/<name>_portable/`: `forward.ts`, `forward.pt2`, the op library
    (and the kernel library it links) where a unit is traced, and
    `manifest.json`; returns the directory. Nothing calls the traced program
    here: TorchScript's first calls, which profile and optimize its graph,
    take tens of seconds at full width."""
    device = next(model.parameters()).device
    module = PortableForward(model, cfg).eval()
    x = 0.1 * torch.randn(batch, n_channels, n_signal,
                          generator=torch.Generator().manual_seed(0)).to(device)
    seed = torch.tensor(0, dtype=torch.int64, device=device)
    out_dir = output / f"{cfg.name}_portable"
    out_dir.mkdir(parents=True, exist_ok=True)
    with torch.no_grad(), fp32_exact():
        traced = trace_program(module, (x, seed), out_dir / "forward.ts")
        program = torch.export.export(module, (x, seed), strict=False)
    torch.export.save(program, str(out_dir / "forward.pt2"))
    y = next(n for n in program.graph.nodes if n.op == "output").args[0][0].meta["val"]
    units = unit_nodes(traced)
    libraries = [Path(unit_op.load_unit_op()), unit_op.kernel_library()] if units else [None, None]
    for lib in libraries:
        if lib is not None:
            shutil.copyfile(lib, out_dir / lib.name)
    inputs = list(traced.graph.inputs())[1:]  # after the module itself
    manifest = {
        "format": FORMAT,
        "input": [batch, n_channels, n_signal],
        "layout": LAYOUT,
        "inputs": _specs([x, seed]),
        "outputs": _specs([y]),
        # the inputs the program reads: a family that draws nothing ignores the seed
        "kept_inputs": [i for i, v in enumerate(inputs) if v.uses()],
        "sampling_rate": cfg.sampling_rate,
        "config": config_lib.to_dict(cfg),
        "device": str(device),
        "device_name": (torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"),
        "programs": {"torchscript": "forward.ts", "export": "forward.pt2"},
        # what a consumer loads before the program (none where no unit is traced)
        "units": units,
        "op_library": None if libraries[0] is None else libraries[0].name,
        "kernel_library": None if libraries[1] is None else libraries[1].name,
        "seed": "int64 scalar holding a uint32",
        "torch": torch.__version__,
    }
    (out_dir / "manifest.json").write_text(json.dumps(manifest, indent=2))
    return str(out_dir)


def load_portable(path: str, device: str | torch.device = "cuda"):
    """(the TorchScript forward, the manifest) of the portable program in
    `path` on `device`, which must be the device it was exported on; its op
    library is loaded first unless one is loaded already."""
    path = Path(path)
    manifest = json.loads((path / "manifest.json").read_text())
    device = resolve_device(device)
    exported = torch.device(manifest["device"])
    if device.type != exported.type:
        raise RuntimeError(f"{path} was exported on {manifest['device']} "
                           f"({manifest['device_name']}) and runs only there, not on {device}")
    if manifest["op_library"] is not None and not unit_op.registered():
        torch.ops.load_library(str(path / manifest["op_library"]))
    return torch.jit.load(str(path / manifest["programs"]["torchscript"]),
                          map_location=device), manifest
