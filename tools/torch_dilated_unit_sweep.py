#!/usr/bin/env python3
"""Time the CUDA fused dilated unit's design choices side by side on one card.

    python3 tools/torch_dilated_unit_sweep.py [--out sweep.jsonl] [--batch 16]

from the root of a checkout, on a machine with a CUDA card and nvcc. It
builds rave_tpu_torch/csrc/dilated_unit.cu as committed and two variants
made from it by text edits (each edit must match the source exactly, or the
script stops):

  committed : the source as it is;
  no_flush  : the tensor-core products accumulate straight into the
              register sums, with no fp32 flush after every weight chunk;
  kc16      : 16 input channels of weights per pipeline step at the
              64- and 32-frame tiles (committed: 32).

At each centered residual-unit shape of the v2 forward at B x 131072
samples, every variant runs at every tile (64, 32, 16 frames) whose shared
memory fits; a tile that does not fit is recorded as refused. Each run
gives its time by CUDA events (2 warm launches, then 20), its max relative
error against the plain fp32 version (`fused_dilated_unit_reference`, TF32
off) and against the same formula in float64. The last lines name, per
shape, the tile the committed rule (`dilated_unit_tile`) picks and the
fastest committed tile.
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
TILES = (64, 32, 16)
VARIANTS = {
    "committed": [],
    "no_flush": [("float part[P::MI][P::NI][4] = {};", "auto& part = acc;", 1),
                 ("acc[mi][ni][r] += part[mi][ni][r];", ";", 1)],
    "kc16": [("KC = 32; };", "KC = 16; };", 2)],
}


def build_variant(name: str, edits, out_dir: Path) -> ctypes.CDLL:
    from rave_tpu_torch.ops.kernels import build

    src = (build.CSRC / "dilated_unit.cu").read_text()
    for old, new, count in edits:
        if src.count(old) != count:
            raise SystemExit(f"{name}: {old!r} occurs {src.count(old)} times, expected {count}")
        src = src.replace(old, new)
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
    cu.write_text(src)
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on {name}:\n{proc.stdout}{proc.stderr}")
    regs = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines() if "registers" in ln]
    print(f"built {name}: {' | '.join(regs)}", flush=True)
    lib = ctypes.CDLL(str(so))
    lib.dilated_unit_tile.argtypes = [ctypes.c_int] * 3
    lib.dilated_unit_tile.restype = ctypes.c_int
    lib.dilated_unit_forward.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.dilated_unit_forward.restype = ctypes.c_int
    return lib


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/dilated_unit_sweep.jsonl")
    ap.add_argument("--batch", type=int, default=16)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from rave_tpu_torch.nn.conv import get_padding
    from rave_tpu_torch.ops.kernels.dilated_unit import fused_dilated_unit_reference

    if not torch.cuda.is_available():
        raise SystemExit("torch_dilated_unit_sweep: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    libs = {name: build_variant(name, edits, ROOT / "build" / "sweep")
            for name, edits in VARIANTS.items()}
    stream = torch.cuda.current_stream().cuda_stream

    def timed(fn, iters=20):
        for _ in range(2):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def rel(a, b):
        return float((a.double() - b).abs().max() / b.abs().max())

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, picks = [], []
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("w") as fh, torch.inference_mode():
        for C, T, dilations in SHAPES:
            x = torch.randn(args.batch, C, T, device="cuda", generator=gen)
            w1 = torch.randn(C, C, 3, device="cuda", generator=gen) / math.sqrt(3 * C)
            w2 = torch.randn(C, C, device="cuda", generator=gen) / math.sqrt(C)
            w1t, w2t = w1.permute(2, 1, 0).contiguous(), w2.t().contiguous()
            for d in dilations:
                left, right = get_padding(3, 1, d, "centered")
                y_plain = fused_dilated_unit_reference(x, w1, w2, d, left, right)
                y64 = fused_dilated_unit_reference(x.double(), w1.double(), w2.double(),
                                                   d, left, right)
                plain_ms = timed(lambda: fused_dilated_unit_reference(x, w1, w2, d, left, right))
                base = {"C": C, "T": T, "d": d, "B": args.batch, "plain_ms": plain_ms,
                        "plain_err64": rel(y_plain, y64)}
                for name, lib in libs.items():
                    for tile in TILES:
                        y = torch.empty_like(x)

                        def launch():
                            return lib.dilated_unit_forward(
                                x.data_ptr(), w1t.data_ptr(), w2t.data_ptr(), y.data_ptr(),
                                args.batch, C, T, 3, d, left, tile, stream)

                        row = {**base, "variant": name, "tile": tile}
                        err = launch()
                        torch.cuda.synchronize()
                        if err != 0:  # the tile's shared memory does not fit this shape
                            row["refused"] = f"cudaError {err}"
                        else:
                            row.update(ms=timed(launch), err=rel(y, y_plain.double()),
                                       err64=rel(y, y64))
                        rows.append(row)
                        fh.write(json.dumps(row) + "\n")
                        print(json.dumps(row), flush=True)
                done = [r for r in rows if r["C"] == C and r["d"] == d
                        and r["variant"] == "committed" and "ms" in r]
                picks.append({"C": C, "d": d, "rule": libs["committed"].dilated_unit_tile(C, 3, d),
                              "fastest": min(done, key=lambda r: r["ms"])["tile"]})
    for p in picks:
        print(f"C={p['C']} d={p['d']}: rule picks {p['rule']}, fastest {p['fastest']}", flush=True)
    print(json.dumps({"card": card, "picks": picks}), flush=True)


if __name__ == "__main__":
    main()
