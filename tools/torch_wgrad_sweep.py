#!/usr/bin/env python3
"""The fused unit's weight gradients on the card: right, repeatable, and how fast, per plan.

    python3 tools/torch_wgrad_sweep.py [--out build/wgrad_sweep.json]
                                       [--plans "default;np=96;grid=tiles;grid=132"]
                                       [--check-only]

from the root of a checkout, on a machine with one CUDA card and nvcc. It
builds csrc/dilated_unit.cu (printing ptxas' registers and spills of the
weight-gradient kernel), then for fp32 and bf16:

  * checks the gradient's kernels (`backward_kernel_with_g`) against the
    plain closed form at the kernel's side of leaky'(h)'s kink, as
    chip_smoke.py's phase `grad` does (fp32 within KERNEL_TOL; bf16 no
    further from the fp32 referee than BF16_MARGIN x plain bf16), at the 11
    centered v2 shapes at B=8 and, per width, causal, B=1 and a ragged
    length; and that two calls at the v2 shapes give the same bits;
  * times, at the 11 v2 shapes at B=8, the whole backward (`_backward`,
    CUDA events, `chip_smoke.cuda_ms`) and the weight-gradient kernel alone
    (the device time of `wgrad_wgmma_kernel` under torch.profiler, over 5
    calls), for each of `--plans`: the plan's own (`default`), or the plan
    with the weight gradients' N or grid replaced (`patched` says how).

Every plan is checked as it is timed; a failed check is printed and
recorded, and the next plan runs. Writes one JSON file (after each plan)
and prints a line per shape and plan.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def wgrad_kernel_ms(fn, calls: int = 5) -> float:
    """Device ms per call of the weight-gradient kernel launched by `fn`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == DeviceType.CUDA and "wgrad_wgmma_kernel" in e.name)
    return us / 1e3 / calls


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/wgrad_sweep.json")
    ap.add_argument("--plans", default="default",
                    help="semicolon-separated plan overrides (see `patched`), or default")
    ap.add_argument("--check-only", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from rave_tpu_torch.nn.conv import get_padding
    from rave_tpu_torch.ops.kernels import build
    from rave_tpu_torch.ops.kernels import dilated_unit as du

    if not torch.cuda.is_available():
        raise SystemExit("torch_wgrad_sweep: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    lib = build.build("dilated_unit")
    ptxas = [ln.strip() for ln in lib.with_suffix(".log").read_text().splitlines()]
    wg = [ln for i, ln in enumerate(ptxas) if "wgrad" in " ".join(ptxas[max(0, i - 3):i + 1])
          and ("registers" in ln or "spill" in ln)]
    print(f"build {time.perf_counter() - t0:.1f} s; wgrad ptxas: " + " | ".join(wg), flush=True)
    du.smem_limit()

    plan_of = du.kernel_backward_plan
    override = {}

    def patched(B, C, T, K, d, left, bf16, index=0):
        """The plan with the weight gradients' `override`: "np=n" (N), "grid=tiles"
        (one block per tile) or "grid=n" (n blocks sharing the units),
        comma-joined, applied in order; "default" none."""
        p = plan_of(B, C, T, K, d, left, bf16, index)
        for item in filter(None, override.get("plan", "").split(",")):
            key, _, value = item.partition("=")
            if key == "np":
                np = int(value)
                tiles = du.wg_tiles(C, np, K + 1)
                p = p._replace(wg_np=np, wg_tiles=tiles, counters=2 * du.WG_COUNTERS * tiles,
                               wg_grid=du.wg_grid(tiles, p.wg_chunks),
                               wg_stages=min(du.WG_MAX_STAGES, (
                                   du.smem_limit(index) - du.wg_smem_bytes(np, 0, bf16))
                                   // (du.wg_stage_bytes(np, bf16) + 24)))
            elif key == "grid":
                p = p._replace(wg_grid=p.wg_tiles if value == "tiles" else
                               min(int(value), p.wg_tiles * p.wg_chunks))
        return p._replace(partials=2 * p.wg_grid * du.WG_ROWS * p.wg_np)

    du.kernel_backward_plan = patched
    gen = torch.Generator(device="cuda").manual_seed(10)
    v2 = [(C, T, d) for C, T, dils in cs.UNIT_SHAPES for d in dils]
    checks = [("main", cs.TRAIN_BATCH, C, T, d, "centered") for C, T, d in v2]
    for C, T, dils in cs.UNIT_SHAPES:
        checks += [("causal", cs.TRAIN_BATCH, C, T, dils[-1], "causal"),
                   ("b1", 1, C, T, dils[0], "centered"),
                   ("ragged", cs.TRAIN_BATCH, C, T - 21, dils[-1], "centered")]
    out = {"card": card, "ptxas": wg, "rows": []}
    path = ROOT / args.out
    path.parent.mkdir(parents=True, exist_ok=True)
    for dtype, name in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        for plan in args.plans.split(";"):
            override.update(plan="" if plan == "default" else plan)
            rows = []
            try:
                for case, B, C, T, d, mode in checks:
                    rows.append(sweep_row(cs, du, gen, case, B, C, T, d, mode, dtype,
                                          not args.check_only))
                    r = rows[-1]
                    p = du.kernel_backward_plan(B, C, du.tma_length(T, dtype), 3, d,
                                                get_padding(3, 1, d, mode)[0], name == "bf16")
                    r.update(dtype=name, plan=plan, wg_np=p.wg_np, wg_grid=p.wg_grid,
                             wg_stages=p.wg_stages, wg_tiles=p.wg_tiles)
                    worst = max(v for k, v in r.items() if k.endswith("rel_err"))
                    times = (f" bwd {r['bwd_ms']:.4f} wgrad {r['wgrad_ms']:.4f} ms"
                             if "wgrad_ms" in r else "")
                    print(f"{name} [{plan}] N={p.wg_np} G={p.wg_grid} S={p.wg_stages} "
                          f"{case} C={C} T={T} d={d} B={B} {mode}:{times} err {worst:.2e}",
                          flush=True)
            except RuntimeError as e:  # a failed check: recorded, and the next plan runs
                print(f"{name} [{plan}] FAILED: {e}", flush=True)
                rows.append({"dtype": name, "plan": plan, "failed": str(e)})
            out["rows"] += rows
            timed = [r for r in rows if "wgrad_ms" in r]
            if timed:
                print(f"== {name} [{plan}]: 22 units (each v2 shape twice) bwd "
                      f"{2 * sum(r['bwd_ms'] for r in timed):.4f} ms, wgrad "
                      f"{2 * sum(r['wgrad_ms'] for r in timed):.4f} ms", flush=True)
            path.write_text(json.dumps(out, indent=1))


def sweep_row(cs, du, gen, case, B, C, T, d, mode, dtype, timed: bool) -> dict:
    """One shape: chip_smoke's `backward_row` check; at the "main" shapes also
    two calls bit-equal and, if `timed`, the backward's and the weight
    gradients' device ms."""
    import torch

    from rave_tpu_torch.nn.conv import get_padding

    # backward_row's own timing runs only for its case "main"
    row = cs.backward_row(gen, "v2" if case == "main" else case, B, C, T, d, mode, dtype)
    row["case"] = case
    if case == "main":
        left, right = get_padding(3, 1, d, mode)
        x = torch.randn(B, C, T, device="cuda", generator=gen).to(dtype)
        w1, w2 = cs.unit_weights(C, gen, dtype)
        gy = torch.randn(B, C, T, device="cuda", generator=gen).to(dtype)
        a = (x, w1, w2, gy, d, left, right, (True, True, True))
        first, again = du._backward(*a), du._backward(*a)
        cs.check(all(torch.equal(u, v) for u, v in zip(first, again)),
                 f"C={C} d={d}: two calls are not bit-equal")
        row["repeat_bit_equal"] = True
        if timed:
            row["bwd_ms"] = cs.cuda_ms(lambda: du._backward(*a), 10)
            row["wgrad_ms"] = wgrad_kernel_ms(lambda: du._backward(*a))
    return row


if __name__ == "__main__":
    main()
