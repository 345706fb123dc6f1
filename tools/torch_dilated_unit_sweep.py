#!/usr/bin/env python3
"""Time the CUDA fused dilated unit's design choices, and the parent design, on one card.

    python3 tools/torch_dilated_unit_sweep.py [--out sweep.jsonl] [--parent DIR] [--quick]

from the root of a checkout, on a machine with a CUDA card and nvcc. At each
centered residual-unit shape of the v2 forward (fp32 at B=16, bf16 at B=8,
x 131072 samples) it times, by CUDA events (2 warm calls, then 20 queued
while the card sleeps, so that each is timed by its device work, not by
the host's; `chip_smoke.cuda_ms`):

  plain     : `fused_dilated_unit_reference` (cuDNN, TF32 off);
  committed : the wrapper, with the plan `plan` picks;
  parent    : with --parent, another checkout's kernel through that
              checkout's own wrapper (its ops/kernels/dilated_unit.py, bound
              to its csrc/dilated_unit.cu built by nvcc here), timed parent,
              committed, committed, parent and reported as the mean of each
              pair;
  variants  : the kernel's C entry point with every other plan that fits:
              fused or split, N per pass, 2-4 weight and 2 or 4 window
              stages and, in fp32, with or without the per-chunk flush.

Each run gives its max relative error against plain and, in fp32, against
the same formula in float64; and the bytes of weights the blocks read from
L2 per call (each 128-frame tile reads every weight once: (K+1) C^2 times
the element size, twice in fp32 for the TF32 hi/lo parts; the parent's
tiles of TT frames read (K+1) C^2 fp32 or bf16 values each). The last line
is a JSON summary per shape: plain, parent and committed ms, the bound of
`chip_smoke.unit_bound`, the L2 weight bytes, and the fastest variant.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [(96, 8192, (1, 3, 9)), (192, 2048, (1, 3, 9)), (384, 512, (1, 3, 9)),
          (768, 128, (1, 3))]
N_PER_PASS = {"fp32": (96,), "bf16": (96, 192)}


def load_parent(parent: Path, out_dir: Path):
    """The parent checkout's wrapper module, bound to its own kernel."""
    import importlib.util

    from rave_tpu_torch.ops.kernels import build

    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / "libparent.so"
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                           str(parent / "rave_tpu_torch" / "csrc" / "dilated_unit.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on the parent:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.dilated_unit_tile.argtypes = [ctypes.c_int] * 3
    lib.dilated_unit_bf16_tile.argtypes = [ctypes.c_int] * 5
    for fn in (lib.dilated_unit_forward, lib.dilated_unit_forward_bf16):
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    spec = importlib.util.spec_from_file_location(
        "parent_dilated_unit", parent / "rave_tpu_torch" / "ops" / "kernels" / "dilated_unit.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module._lib = lambda: lib  # its wrapper, its library
    return module


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/dilated_unit_sweep.jsonl")
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--quick", action="store_true", help="the committed plan and the parent only")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from chip_smoke import SLEEP_CYCLES_PER_CALL, unit_bound
    from rave_tpu_torch.nn.conv import get_padding
    from rave_tpu_torch.ops.kernels import dilated_unit as du

    if not torch.cuda.is_available():
        raise SystemExit("torch_dilated_unit_sweep: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    lib = du._lib()
    parent = load_parent(args.parent, ROOT / "build" / "sweep") if args.parent else None
    stream = torch.cuda.current_stream().cuda_stream

    def timed(fn, iters=20):  # device time per call, as chip_smoke.cuda_ms
        for _ in range(2):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES_PER_CALL * iters)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def rel(a, b):
        return float((a.double() - b.double()).abs().max() / b.double().abs().max())

    gen = torch.Generator(device="cuda").manual_seed(0)
    summary = []
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("w") as fh, torch.inference_mode():
        def emit(row):
            fh.write(json.dumps(row) + "\n")
            print(json.dumps(row), flush=True)

        for kind, B in (("fp32", 16), ("bf16", 8)):
            bf16, dtype = kind == "bf16", (torch.bfloat16 if kind == "bf16" else torch.float32)
            elem, parts = (2, 1) if bf16 else (4, 2)
            for C, T, dilations in SHAPES:
                x = torch.randn(B, C, T, device="cuda", generator=gen).to(dtype)
                w1 = (torch.randn(C, C, 3, device="cuda", generator=gen) / math.sqrt(3 * C)).to(dtype)
                w2 = (torch.randn(C, C, device="cuda", generator=gen) / math.sqrt(C)).to(dtype)
                for d in dilations:
                    left, right = get_padding(3, 1, d, "centered")
                    args_ = (x, w1, w2, d, left, right)
                    y_plain = du.fused_dilated_unit_reference(*args_)
                    y64 = du.fused_dilated_unit_reference(x.double(), w1.double(), w2.double(),
                                                          d, left, right)
                    plan = du.kernel_plan(B, C, T, 3, d, left, bf16)
                    tiles = B * -(-T // du.TILE)
                    base = {"kind": kind, "B": B, "C": C, "T": T, "d": d,
                            "plain_ms": timed(lambda: du.fused_dilated_unit_reference(*args_)),
                            "bound_ms": unit_bound([{"C": C, "T": T}], B, kind)["bound_ms"],
                            "l2_weight_bytes": tiles * 4 * C * C * elem * parts}
                    committed = lambda: du.fused_dilated_unit(*args_)  # noqa: E731
                    y = committed()
                    row = {**base, "variant": "committed", **plan._asdict(),
                           "err": rel(y, y_plain), "err64": rel(y, y64)}
                    if parent is not None:
                        def run_parent():
                            return parent.fused_dilated_unit(*args_)

                        yp = run_parent()
                        tile = (parent.kernel_tile_bf16(B, C, T, 3, d) if bf16
                                else parent.kernel_tile(C, 3, d))
                        par = [timed(run_parent)]
                        com = [timed(committed), timed(committed)]
                        par.append(timed(run_parent))
                        row.update(ms=sum(com) / 2, parent_ms=sum(par) / 2, parent_runs=par,
                                   runs=com, parent_tile=tile, parent_err=rel(yp, y_plain),
                                   parent_l2_weight_bytes=B * -(-T // tile) * 4 * C * C * elem)
                    else:
                        row["ms"] = timed(committed)
                    emit(row)
                    summary.append({k: row.get(k) for k in (
                        "kind", "C", "T", "d", "plain_ms", "parent_ms", "ms", "bound_ms",
                        "l2_weight_bytes", "parent_l2_weight_bytes", "err", "err64")})
                    if args.quick:
                        continue
                    best = (row["ms"], "committed")
                    wbuf = torch.empty((3 if bf16 else 8) * C * C, dtype=dtype, device="cuda")
                    hbuf = torch.empty_like(x)
                    yv = torch.empty_like(x)
                    for fused in (True, False):
                        for np_ in N_PER_PASS[kind]:
                            for stages, x_stages in ((2, 2), (3, 2), (4, 2), (4, 4)):
                                for flush in ((True, False) if not bf16 else (False,)):
                                    def launch():
                                        return lib.dilated_unit_forward(
                                            x.data_ptr(), w1.data_ptr(), w2.data_ptr(),
                                            yv.data_ptr(), wbuf.data_ptr(), hbuf.data_ptr(),
                                            B, C, T, 3, d, left, int(bf16), int(fused), np_,
                                            stages, x_stages, int(flush), stream)

                                    v = {**base, "variant": "plan", "fused": fused, "np": np_,
                                         "w_stages": stages, "x_stages": x_stages,
                                         "flush": flush}
                                    if launch() != 0:  # does not fit this card's shared memory
                                        torch.cuda.synchronize()
                                        v["refused"] = True
                                    else:
                                        v.update(ms=timed(launch), err=rel(yv, y_plain),
                                                 err64=rel(yv, y64))
                                        best = min(best, (v["ms"], f"fused={fused} np={np_} "
                                                          f"stages={stages}/{x_stages} "
                                                          f"flush={flush}"))
                                    emit(v)
                    summary[-1]["fastest"] = best[1]
                    summary[-1]["fastest_ms"] = best[0]
    print(json.dumps({"card": card, "shapes": summary}), flush=True)


if __name__ == "__main__":
    main()
