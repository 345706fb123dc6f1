"""Exporter: port run directory -> `.rtpu` artifact.

PyTorch port of rave_tpu/export/export.py (the reference's `rave export`,
scripts/export.py:492-599): loads the newest checkpoint's generator
(optionally its EMA weights), sets the user-facing latent size per family
(the variational space truncated to the requested fidelity; the discrete
family's is its number of quantizers, the spherical one's its angles),
writes the weights and the manifest, decodes a zero
latent at the stream batch as a smoke check, and exports the streaming step
programs with `torch.export`.

The step programs keep the JAX package's contract (its `_aot_lower`):

    encode_step(state, x[B, C, block], seed)   -> (z[B, L, frames], state')
    decode_step(state, z[B, L, frames], seed)  -> (y[B, C, block], state')
    forward_step(state, x, seed)               -> (y, state')

with the weights constant inside each program (each holds the weights of
the half it runs), the state explicit (the stream buffers start from
zeros, the AdaIN buffers from the model's; shapes and leaf names in the
manifest) and `seed` an int64 scalar holding a uint32. `forward_step`
decodes with `seed + 0x9E3779B9 mod 2^32`. With `prior`, the prior run's
config and newest weights are bundled (`prior.json`, `prior.pt`, the
manifest's `prior` is its `prior_config.json`, as the JAX package's) with a
fourth program,

    prior_step(state, x[1, D*R, 1], seed)       -> (next[1, D*R, 1], state')

one autoregressive step of the prior (artifact.py::PriorStep). A program
holds its weights on the device it was exported on; the manifest records it. Nothing fails
quietly: a failed smoke decode or program export raises, and a failed
export leaves no manifest `aot` section behind.

Each step program is also written as TorchScript, `<method>_step.ts`
(`torch.jit.trace` of the same module on the same example inputs, the
manifest's `aot.<method>.ts_file`), with its initial state as a host state
file (`state_file`: zeros, and the AdaIN buffers as the model holds them).
These are what the native host (csrc/rtpu_host.cc, the counterpart of the
StableHLO modules rave_tpu's `_aot_lower` writes for its host) loads. Not
the `.pt2`: libtorch runs a `.pt2` only through AOTInductor, an Inductor
compile whose generated kernels round otherwise, while a traced program
run with the graph executor's profiling and optimizations off calls the
ATen kernels of the eager step, so the host's outputs can be held bit for
bit to the Python artifact's. Whatever the trace reads on the host would be
baked in as a constant: every `TracerWarning` is an error here, and the
trace is checked (`check_trace`). A trace is specific to its shapes, as the
`.pt2` is to its block: one program per block shape.
"""
from __future__ import annotations

import json
import math
import warnings
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from rave_tpu_torch import config as config_lib
from rave_tpu_torch.export.artifact import FORMAT, STEP_METHODS, ExportedRAVE, stream_slots
from rave_tpu_torch.export.native_host import write_state
from rave_tpu_torch.factory import resolve_device
from rave_tpu_torch.utils.checkpoint import read_generator, read_prior


def truncated_latent_size(fidelity_curve: np.ndarray, fidelity: float, full: int) -> int:
    """The smallest power of two of latent dimensions whose explained
    variance passes `fidelity` (reference scripts/export.py:119-124)."""
    size = max(int(np.argmax(fidelity_curve > fidelity)), 1)
    return min(2 ** math.ceil(math.log2(size)), full)


def user_latent_size(cfg, fidelity_curve: np.ndarray, fidelity: float) -> int:
    """The artifact's latent size per family (rave_tpu/export/export.py:66-79):
    the variational space truncated to `fidelity`, the discrete family's
    number of quantizers, the spherical family's angles (one fewer than its
    latent), the wasserstein latent as it is."""
    fam = cfg.latent.family
    if fam == "variational":
        return truncated_latent_size(fidelity_curve, fidelity, cfg.latent_size)
    if fam == "discrete":
        return cfg.latent.num_quantizers
    return cfg.latent_size - (fam == "spherical")


def attributes(cfg) -> dict:
    """The manifest's AdaIN `attributes` and `attribute_ops`, as
    rave_tpu/export/export.py:165-195 writes them (the nn_tilde
    register_attribute analog, reference scripts/export.py:306-341): each
    attribute is a list of fills applied to every leaf of the stream state
    (`aot.<method>.state_leaves`) whose name ends with `leaf`; fill None is
    the user's value (a toggle), a constant a reset. Empty without AdaIN."""
    if not (cfg.encoder.use_adain or cfg.decoder.use_adain):
        return {"attributes": [], "attribute_ops": {}}
    return {
        "attributes": ["learn_target", "reset_target", "learn_source", "reset_source"],
        "attribute_ops": {
            "learn_target": [{"leaf": "learn_y", "fill": None}],
            "learn_source": [{"leaf": "learn_x", "fill": None}],
            "reset_target": [{"leaf": "mean_y", "fill": 0.0}, {"leaf": "std_y", "fill": 1.0},
                             {"leaf": "num_update_y", "fill": 0.0}],
            "reset_source": [{"leaf": "mean_x", "fill": 0.0}, {"leaf": "std_x", "fill": 1.0},
                             {"leaf": "num_update_x", "fill": 0.0}],
        },
    }


def _methods(n_channels: int, latent_size: int, ratio: int) -> dict:
    signal = lambda kind, n: [f"(signal) {kind} {i}" for i in range(n)]  # noqa: E731
    return {
        "encode": {"in_channels": n_channels, "in_ratio": 1, "out_channels": latent_size,
                   "out_ratio": ratio, "input_labels": signal("input", n_channels),
                   "output_labels": signal("latent", latent_size)},
        "decode": {"in_channels": latent_size, "in_ratio": ratio, "out_channels": n_channels,
                   "out_ratio": 1, "input_labels": signal("latent", latent_size),
                   "output_labels": signal("output", n_channels)},
        "forward": {"in_channels": n_channels, "in_ratio": 1, "out_channels": n_channels,
                    "out_ratio": 1, "input_labels": signal("input", n_channels),
                    "output_labels": signal("output", n_channels)},
    }


def export_model(
    run: str,
    streaming: bool = False,
    fidelity: float = 0.95,
    stereo: bool = False,
    use_ema: bool = False,
    channels: Optional[int] = None,
    target_sr: Optional[int] = None,
    output: Optional[str] = None,
    prior: Optional[str] = None,
    device: str | torch.device = "cuda",
) -> str:
    """Export the run `run` into `<output or run dir>/<name>[_streaming].rtpu`
    on `device`, with the prior run under `prior` bundled when given; returns
    the artifact's path."""
    device = resolve_device(device)
    cfg, weights, n_channels, run_dir = read_generator(run, use_ema)
    n_channels = channels or n_channels
    stream_batch = 2 if stereo else 1
    latent_size = user_latent_size(cfg, weights["fidelity"].numpy(), fidelity)
    ratio, block = cfg.decimation(), cfg.block_size()
    name = cfg.name + ("_streaming" if streaming else "")
    out_dir = Path(output or run_dir) / f"{name}.rtpu"
    out_dir.mkdir(parents=True, exist_ok=True)
    manifest_prior = None
    if prior is not None:  # reference scripts/export.py:543-558
        manifest_prior, prior_weights, _ = read_prior(prior)
        (out_dir / "prior.json").write_text(json.dumps(manifest_prior, indent=2))
        torch.save(prior_weights, out_dir / "prior.pt")
    manifest = {
        "format": FORMAT,
        "name": cfg.name,
        "streaming": streaming,
        "sampling_rate": cfg.sampling_rate,
        "target_sampling_rate": target_sr or cfg.sampling_rate,
        "n_channels": n_channels,
        "stream_batch": stream_batch,
        "stereo": stereo,
        "block_size": block,
        "latent_family": cfg.latent.family,
        # trained on the signal derivative: consumers integrate the output
        # back (reference scripts/train.py:160-161, dataset.py:24-29)
        "derivative": bool(cfg.data.derivative),
        "latent_size": int(latent_size),
        "full_latent_size": int(cfg.augmented_latent_size()),
        "latent_rate_hz": cfg.sampling_rate / ratio,
        "methods": _methods(n_channels, int(latent_size), ratio),
        "latency": None,  # from the loaded model, below
        **attributes(cfg),
        "config": config_lib.to_dict(cfg),
        "prior": manifest_prior,
        "version": 1,
    }
    torch.save(weights, out_dir / "weights.pt")
    (out_dir / "manifest.json").write_text(json.dumps(manifest, indent=2))
    art = ExportedRAVE(str(out_dir), device=device)
    enc, dec = art.model.encode_delay, art.model.decode_delay
    manifest["latency"] = {"encode_latent_frames": enc, "decode_samples": dec,
                           "total_samples": enc * ratio + dec}

    # the stereo smoke check (reference export.py:587-596): a zero latent at
    # the stream batch decodes to the declared channel layout
    y0 = art.decode(torch.zeros(stream_batch, int(latent_size), 8, device=device))
    if tuple(y0.shape[:2]) != (stream_batch, n_channels) or not bool(torch.isfinite(y0).all()):
        raise RuntimeError(f"smoke decode of a zero latent gave {tuple(y0.shape)} "
                           f"(finite: {bool(torch.isfinite(y0).all())}), expected "
                           f"({stream_batch}, {n_channels}, T)")

    manifest["aot"] = export_programs(art, out_dir)
    (out_dir / "manifest.json").write_text(json.dumps(manifest, indent=2))
    return str(out_dir)


def _specs(tensors) -> list:
    return [{"shape": [int(d) for d in t.shape], "dtype": str(t.dtype).removeprefix("torch.")}
            for t in tensors]


def trace_program(module, args, path: Path) -> torch.jit.ScriptModule:
    """`module` traced on `args` into the TorchScript file `path`, and the
    traced module; a `TracerWarning` (a value the trace would bake in) raises."""
    with warnings.catch_warnings():
        warnings.simplefilter("error", torch.jit.TracerWarning)
        warnings.filterwarnings("ignore", message=r".*torch\.jit\.trace.* is deprecated")
        traced = torch.jit.trace(module, args, strict=False, check_trace=True)
    traced.save(str(path))
    return traced


def export_programs(art: ExportedRAVE, out_dir: Path) -> dict:
    """`torch.export` each streaming step of `art` into `<method>_step.pt2`,
    and the prior's step into `prior_step.pt2` when it has one, each also
    traced into `<name>.ts` with its initial state in `<name>.state`; the
    manifest's `aot` section. Flat inputs are (state..., x, seed), flat
    outputs (y, state'...), the state in the order of `state_leaves`."""
    block, ratio, device = art.manifest["block_size"], art.cfg.decimation(), art.device
    x = torch.zeros(art.stream_batch, art.n_channels, block, device=device)
    z = torch.zeros(art.stream_batch, art.latent_size, block // ratio, device=device)
    programs = {f"{m}_step": (art.steps[m], art.state, z if m == "decode" else x,
                              stream_slots(art.model)) for m in STEP_METHODS}
    if art.has_prior:
        prior = art.prior_step.prior
        programs["prior_step"] = (art.prior_step, art.prior_state(),
                                  torch.zeros(1, prior.latent_size * prior.resolution, 1,
                                              device=device), art.prior_step.slots)
    seed = torch.tensor(0, dtype=torch.int64, device=device)
    report = {}
    with torch.no_grad():
        for name, (module, state0, x_in, slots) in programs.items():
            state = [s.clone() for s in state0]
            args = (state, x_in, seed)
            program = torch.export.export(module, args, strict=False)
            torch.export.save(program, str(out_dir / f"{name}.pt2"))
            trace_program(module, args, out_dir / f"{name}.ts")
            write_state(out_dir / f"{name}.state", state)
            y, new_state = module(*args)
            inputs = [*state, x_in, seed]
            outputs = [y, *new_state]
            n = len(state)
            report[name] = {
                "file": f"{name}.pt2",
                "ts_file": f"{name}.ts",
                "state_file": f"{name}.state",
                "device": str(device),
                "inputs": _specs(inputs),
                "outputs": _specs(outputs),
                # state round trip: output[state_outputs[i]] feeds
                # input[state_inputs[i]] on the next call
                "n_state": n,
                "state_inputs": list(range(n)),
                "state_outputs": list(range(1, 1 + n)),
                "state_leaves": [leaf for leaf, _, _ in slots],
                # torch.export keeps every input
                "kept_inputs": list(range(len(inputs))),
            }
    return report
