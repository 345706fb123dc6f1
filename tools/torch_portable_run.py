#!/usr/bin/env python3
"""Run portable programs (rave_tpu_torch/export/portable.py) with torch alone.

    python3 tools/torch_portable_run.py DIR [DIR ...] [--iters N] [--profile] [--out f.json]

Each DIR is a `<name>_portable/` directory written by `python -m
rave_tpu_torch.cli export_onnx`. This script is a consumer of it: it imports
torch and nothing of rave_tpu_torch (it checks `sys.modules` at the end),
loads the op library the manifest names with `torch.ops.load_library`,
then `forward.ts` with `torch.jit.load`, and runs it on the device the
program was exported on (another device is refused, naming both), with
TF32 off and TorchScript's graph optimizations off, so the program runs
the ATen kernels its trace recorded. The input is DIR/check.pt's `x` and
`seed` where that file exists (and its `y`, the live model's output, is the
reference), else a seeded normal input of the manifest's shape. Per program
it reports the output's shape and finiteness, its distance from `y`, the
distance of `forward.pt2` (`torch.export.load`) from the `.ts`, the `.ts`'s
device ms per forward over `--iters` timed calls (CUDA events on the card,
the host clock on the CPU), the op library's launch count across those
calls and the warm call before them, and with `--profile` the device kernels of one more call counted by
name (the unit's `prepare_weights_f32` and `unit_kernel`). One JSON line
per program is printed, and `--out` writes them all.
"""
import argparse
import json
import sys
import time
from pathlib import Path

import torch

UNIT_KERNELS = ("prepare_weights_f32", "prepare_weights_bf16", "unit_kernel")


def load(path: Path):
    """(the TorchScript program, the manifest, its device) of `path`."""
    manifest = json.loads((path / "manifest.json").read_text())
    device = torch.device(manifest["device"])
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{path} was exported on {manifest['device']} "
                         f"({manifest['device_name']}) and runs only there: no card here")
    if manifest["op_library"] is not None and not hasattr(torch.ops.rave_tpu_torch,
                                                          "dilated_unit"):
        torch.ops.load_library(str(path / manifest["op_library"]))
    return torch.jit.load(str(path / manifest["programs"]["torchscript"]),
                          map_location=device), manifest, device


def launches() -> int:
    return (torch.ops.rave_tpu_torch.dilated_unit_launches()
            if hasattr(torch.ops.rave_tpu_torch, "dilated_unit_launches") else 0)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def forward_ms(program, x, seed, device, iters: int) -> float:
    """Mean ms of one call over `iters` calls after a warm one."""
    program(x, seed)
    sync(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            program(x, seed)
        return (time.perf_counter() - t0) * 1e3 / iters
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        program(x, seed)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_counts(program, x, seed, units: int, attempts: int = 3) -> dict:
    """The device kernels of one call, counted by name: the unit's, and all.
    A trace can lose a kernel's record: a session that counts fewer weight
    preparations than `units` is tried again, up to `attempts` sessions, and
    the most counted in one session is kept."""
    from torch.profiler import ProfilerActivity, profile

    best = None
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            program(x, seed)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        counts = {**{k: sum(k in n for n in names) for k in UNIT_KERNELS},
                  "kernels": len(names), "sessions": attempt + 1}
        if best is None or counts["kernels"] > best["kernels"]:
            best = counts
        if counts["prepare_weights_f32"] + counts["prepare_weights_bf16"] >= units:
            break
    return best


def run(path: Path, iters: int, profile: bool) -> dict:
    program, manifest, device = load(path)
    check = path / "check.pt"
    if check.exists():
        saved = torch.load(check, map_location=device, weights_only=True)
        x, seed, want = saved["x"], saved["seed"], saved["y"]
    else:
        x = torch.randn(manifest["input"], generator=torch.Generator().manual_seed(0)).to(device)
        seed, want = torch.tensor(0, dtype=torch.int64, device=device), None
    before = launches()
    y = program(x, seed)
    sync(device)
    out = {"program": str(path), "name": manifest["config"].get("name"),
           "device": str(device), "shape": list(y.shape), "finite": bool(torch.isfinite(y).all()),
           "units": manifest["units"], "launches_first_call": launches() - before}
    if want is not None:
        out["max_abs_err_live"] = float((y - want).abs().max())
        out["bit_equal_live"] = bool(torch.equal(y, want))
    ep = torch.export.load(str(path / manifest["programs"]["export"]))
    y2 = ep.module()(x, seed)
    out["max_abs_err_pt2"] = float((y2 - y).abs().max())
    out["bit_equal_pt2"] = bool(torch.equal(y2, y))
    before = launches()
    out["ms"] = forward_ms(program, x, seed, device, iters)
    out["launches_timed"] = launches() - before  # the warm call's and the timed calls
    out["realtime_factor"] = (x.shape[0] * x.shape[-1] / manifest["sampling_rate"]
                              / (out["ms"] / 1e3))
    if profile and device.type == "cuda":
        out["profile"] = kernel_counts(program, x, seed, manifest["units"])
    return out


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("programs", nargs="+")
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--profile", action="store_true")
    p.add_argument("--out", default=None)
    a = p.parse_args()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    results = []
    with torch.no_grad(), torch.jit.optimized_execution(False):
        for path in a.programs:
            results.append(run(Path(path), a.iters, a.profile))
            print(json.dumps(results[-1]), flush=True)
    foreign = sorted(m for m in sys.modules if m.split(".")[0] in ("rave_tpu_torch", "rave_tpu"))
    print(json.dumps({"foreign_modules": foreign}), flush=True)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps({"programs": results, "foreign_modules": foreign},
                                          indent=1))
    if foreign:
        raise SystemExit(f"the consumer loaded the port: {foreign[:5]}")


if __name__ == "__main__":
    main()
