#!/usr/bin/env python3
"""How far two data-parallel ranks land from one process, over input seeds, for a checkout.

    python3 tools/torch_dp_spread.py [--root DIR] [--seeds 7,1,2,3] [--tag NAME] [--device cuda]
    python3 tools/torch_dp_spread.py --partition

on a machine with one CUDA card, from the root of this checkout. `chip_smoke.py`
phase `parallel` runs `rave_tpu_torch.parallel.mpworker` (v2 at full width,
deterministic cuDNN, log_epsilon 1e-3) in 2 gloo ranks of B=4 and in one
process of B=8, and holds step 0's loss and step 0's averaged generator
gradient (relative L2 over all parameters) of the ranks to the one
process's. This tool runs the same pair with the `rave_tpu_torch` package
of the checkout at `--root` (default: this one; a parent commit unpacked by
`git archive` works, `--root` is only read) for each of `--seeds` as the
worker's input seed X_SEED (7 is the worker's own). One process and one
torchrun serve all seeds: each seed is a call of the worker's `main` with
its X_SEED set, and step 0's gradients are taken from a wrapper around the
generator step, so the same measurement runs on a worker without
`--step0_grads`. It prints, per seed, each step's relative loss gap, step
0's gradient gap (relative L2) and the elements whose step 0 gradient sign
differs (Adam's first update is lr * sign(g), which is why later losses
part). Everything, the kernel libraries included, is written under this
checkout's `build/dp_spread/<tag>/`.

`--partition` holds the fused unit's gradient kernel at four v2 shapes at
B=8 against the sum of its two B=4 halves (dx must be bit-equal, dw1 and dw2
within their summation order), beside plain autograd through cuDNN, and
both against float64.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def grad_stats(got: dict, want: dict) -> dict:
    num = sum(float((got[n].double() - want[n].double()).square().sum()) for n in want)
    den = sum(float(want[n].double().square().sum()) for n in want)
    return {"grad_rel_l2": math.sqrt(num / den),
            "sign_flips": sum(int(((got[n] > 0) != (want[n] > 0)).sum()) for n in want),
            "elements": sum(want[n].numel() for n in want)}


def as_worker(seeds, out: Path, compare, worker_argv) -> None:
    """Inside one worker process (one process, or a torchrun rank): every
    seed through the worker's `main`, step 0's gradients dumped (one
    process) or compared with the one process's dump (rank 0 of the ranks)."""
    import torch
    import torch.distributed as dist

    import rave_tpu_torch.train.steps as steps_mod
    from rave_tpu_torch.ops.kernels import build as kernel_build
    from rave_tpu_torch.parallel import mesh, mpworker

    kernel_build.BUILD_DIR = out.parent / "kernels"  # not into --root's own build/
    build, shutdown = steps_mod.build_train_steps, mesh.shutdown
    mesh.shutdown = lambda: None  # one process group for all seeds
    for seed in seeds:
        where = out / f"seed{seed}"
        where.mkdir(parents=True, exist_ok=True)

        def wrapped_build(*a, _where=where, _seed=seed, **k):
            steps = build(*a, **k)
            gen, calls = steps["gen"], []

            def gen_step(state, *sa, **sk):
                m = gen(state, *sa, **sk)
                if not calls and (not dist.is_initialized() or dist.get_rank() == 0):
                    grads = {n: p.grad.detach().cpu() for n, p in state.model.named_parameters()}
                    if compare is None:
                        torch.save(grads, _where / "grads.pt")
                    else:
                        ref = compare / f"seed{_seed}" / "grads.pt"
                        (_where / "grad_stats.json").write_text(
                            json.dumps(grad_stats(grads, torch.load(ref))))
                calls.append(1)
                return m

            return {**steps, "gen": gen_step}

        steps_mod.build_train_steps = wrapped_build
        mpworker.X_SEED = seed
        mpworker.main([*worker_argv, "--out_dir", str(where)])
        torch.cuda.empty_cache()
    shutdown()


def spread(root: Path, seeds, tag: str, device: str = "cuda") -> None:
    sys.path.insert(0, str(HERE))
    import chip_smoke as c

    out = HERE / "build" / "dp_spread" / tag
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(root)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])}
    worker = ["--device", device, "--deterministic", *c.DP_WORKER_ARGS]
    me = [str(Path(__file__).resolve()), "--as_worker", "--seeds", ",".join(map(str, seeds))]
    one = [sys.executable, *me, "--out", str(out / "one"), "--",
           *worker, "--batch", str(c.DP_RANKS * c.DP_BATCH)]
    run = [str(a) for a in c.torchrun(c.DP_RANKS)[:-1]]  # a script, not `-m`
    two = [*run, *me, "--out", str(out / "two"), "--compare", str(out / "one"), "--",
           *worker, "--batch", str(c.DP_BATCH)]
    for cmd in (one, two):
        proc = subprocess.run(cmd, cwd=HERE, env=env, capture_output=True, text=True)
        if proc.returncode:
            raise SystemExit(f"{cmd[:6]}... exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    rows = []
    for seed in seeds:
        a = json.loads((out / "two" / f"seed{seed}" / "rank0.json").read_text())
        b = json.loads((out / "one" / f"seed{seed}" / "rank0.json").read_text())
        g = json.loads((out / "two" / f"seed{seed}" / "grad_stats.json").read_text())
        (out / "one" / f"seed{seed}" / "grads.pt").unlink()
        gaps = {k: abs(a[k] - b[k]) / abs(b[k]) for k in b
                if k.startswith("step") and "_loss_" in k}
        rows.append({"seed": seed, **gaps, **g})
        print(f"{root} seed {seed}: " + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())
              + f"; step 0 gradient rel L2 {g['grad_rel_l2']:.3e}, signs differing "
              f"{g['sign_flips']} of {g['elements']}", flush=True)
    worst = max(r["grad_rel_l2"] for r in rows)
    print(f"{root}: step 0 gradient rel L2 over {len(rows)} seeds: max {worst:.3e}, min "
          f"{min(r['grad_rel_l2'] for r in rows):.3e}", flush=True)
    (out / "spread.json").write_text(json.dumps({"root": str(root), "rows": rows}))


def partition() -> None:
    import torch

    sys.path.insert(0, str(HERE))
    from rave_tpu_torch.ops.kernels import dilated_unit as du

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False

    def rel_l2(a, b):
        return float((a.double() - b.double()).norm() / b.double().norm())

    def plain(x, w1, w2, gy, d):
        leaves = [t.detach().clone().requires_grad_() for t in (x, w1, w2)]
        return torch.autograd.grad(du.fused_dilated_unit_reference(*leaves, d, d, d), leaves, gy)

    gen = torch.Generator(device="cuda").manual_seed(0)
    for C, T, d in ((96, 8192, 9), (192, 2048, 3), (384, 512, 1), (768, 128, 3)):
        x, gy = (torch.randn(8, C, T, device="cuda", generator=gen) for _ in range(2))
        w1 = torch.randn(C, C, 3, device="cuda", generator=gen) / math.sqrt(3 * C)
        w2 = torch.randn(C, C, device="cuda", generator=gen) / math.sqrt(C)
        halves = [slice(0, 4), slice(4, 8)]
        k8 = du._backward(x, w1, w2, gy, d, d, d, (True,) * 3)
        k4 = [du._backward(x[h].contiguous(), w1, w2, gy[h].contiguous(), d, d, d, (True,) * 3)
              for h in halves]
        p8, p4 = plain(x, w1, w2, gy, d), [plain(x[h], w1, w2, gy[h], d) for h in halves]
        exact = du.fused_dilated_unit_backward_reference(*(t.double() for t in (x, w1, w2, gy)),
                                                         d, d, d)
        print(f"C={C} T={T} d={d}: kernel dx of the halves bit-equal "
              f"{torch.equal(k8[0], torch.cat([k[0] for k in k4]))}; B=8 against the halves' "
              f"sum, dw1 / dw2: kernel {rel_l2(k8[1], k4[0][1] + k4[1][1]):.2e} / "
              f"{rel_l2(k8[2], k4[0][2] + k4[1][2]):.2e}, cuDNN "
              f"{rel_l2(p8[1], p4[0][1] + p4[1][1]):.2e} / {rel_l2(p8[2], p4[0][2] + p4[1][2]):.2e}"
              f"; from float64, dx / dw1 / dw2: kernel " + " / ".join(
                  f"{rel_l2(a, b):.2e}" for a, b in zip(k8, exact)) + ", cuDNN " + " / ".join(
                  f"{rel_l2(a, b):.2e}" for a, b in zip(p8, exact)), flush=True)


def main() -> None:
    argv = sys.argv[1:]
    worker_argv = argv[argv.index("--") + 1:] if "--" in argv else []
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--seeds", default="7,1,2,3")
    ap.add_argument("--tag", default=None, help="build/dp_spread/<tag> (default: --root's name)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--partition", action="store_true")
    ap.add_argument("--as_worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--compare", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv[:argv.index("--")] if "--" in argv else argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.as_worker:
        as_worker(seeds, Path(args.out), args.compare and Path(args.compare), worker_argv)
    elif args.partition:
        partition()
    else:
        root = Path(args.root).resolve()
        spread(root, seeds, args.tag or root.name, args.device)


if __name__ == "__main__":
    main()
