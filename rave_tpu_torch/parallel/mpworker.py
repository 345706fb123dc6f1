"""Deterministic multi-process data-parallel worker (test and dry-run harness).

The port's counterpart of rave_tpu/parallel/mpworker.py: each rank takes
its rows of a seeded global batch (`put_batch`), the three step programs
(pre-warmup generator, adversarial generator, critic) run over the global
batch with the collectives of parallel/mesh.py, and every rank must end
with the same parameters. One process over the same global batch must
give the same numbers: tests/test_torch_parallel.py and chip_smoke.py
hold the ranks to each other and to it.

    python -m torch.distributed.run --nproc_per_node 2 \\
        -m rave_tpu_torch.parallel.mpworker --device cpu --batch 4

(`--batch` is per rank; without torchrun the worker is one process.) By
default the model is the JAX worker's `TINY` v2 at `N_SIGNAL` samples, its
weights seeded (seed 0) and its draws made by `draw_noise` from
`step_generator(1, i)` for step i; `--full` keeps the preset's widths.
`--state` loads the model's and critic's weights (a `torch.save`d
{"model": state_dict, "discriminator": state_dict}) and `--draws` the
steps' draws at the global batch (a list of `LatentDraws` fields), so that
a test can hand the worker the JAX package's. Each rank prints one line,
`MPWORKER {json}` (per-step losses and milliseconds, the unit's launches of
the forward and the gradient kernels, parameter checksums and a digest of
every parameter and buffer), and with
`--out_dir` writes it to `<out_dir>/rank<r>.json`. With `--step0_grads`
rank 0 also writes the generator's gradients of step 0, as the optimizer
took them (after the ranks' average), to `<out_dir>/step0_grads.pt`.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from pathlib import Path

# the JAX worker's overrides and length (rave_tpu/parallel/mpworker.py)
TINY = [
    "capacity=2",
    "discriminator.capacity=2",
    "discriminator.kind=multiscale",
    "discriminator.n_scales=1",
    "discriminator.n_layers=2",
    "discriminator.kernel_size=7",
    "latent_size=4",
    "ratios=[4,2]",
    "dilations=[[1],[1]]",
    "distance.scales=[256]",
    "train.phase_1_duration=2",
    "train.update_discriminator_every=2",
    "train.ema=0.99",
]
N_SIGNAL = 2048
SCHEDULE = [("gen", False), ("gen", True), ("dis", True)]
CROP_FRAMES = (1, 1)
X_SEED, DRAW_SEED = 7, 1


def digest(*modules) -> str:
    """sha256 of every parameter's and buffer's bytes, in module order."""
    h = hashlib.sha256()
    for m in modules:
        for name, t in list(m.named_parameters()) + list(m.named_buffers()):
            h.update(name.encode() + t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def run(args) -> dict:
    import numpy as np
    import torch

    from rave_tpu_torch.config import compose
    from rave_tpu_torch.factory import resolve_device
    from rave_tpu_torch.models.blocks import LatentDraws
    from rave_tpu_torch.ops.kernels import dilated_unit
    from rave_tpu_torch.parallel import mesh
    from rave_tpu_torch.train.loop import fp32_exact
    from rave_tpu_torch.train.state import create_train_state
    from rave_tpu_torch.train.steps import build_train_steps, draw_noise
    from rave_tpu_torch.utils.rng import step_generator

    device = mesh.init_from_env(resolve_device(args.device))
    world, rank = mesh.world_size(), mesh.rank()
    cfg = compose(args.config or ["v2"], ([] if args.full else TINY) + args.override)
    state = create_train_state(cfg, seed=0, device=device)
    if args.state:
        saved = torch.load(args.state, map_location=device, weights_only=True)
        state.model.load_state_dict(saved["model"])
        state.discriminator.load_state_dict(saved["discriminator"])
        if state.ema is not None:
            state.ema = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    mesh.replicate(state.model)
    mesh.replicate(state.discriminator)
    steps = build_train_steps(cfg, CROP_FRAMES)
    n_signal = cfg.data.n_signal if args.full else N_SIGNAL
    G = args.batch * world
    x_global = (np.random.default_rng(X_SEED).standard_normal((G, 1, n_signal)) * 0.1
                ).astype(np.float32)
    drawn = torch.load(args.draws, weights_only=False) if args.draws else None
    out = {"world_size": world, "rank": rank, "global_batch": G, "device": str(device),
           "x_checksum": float(np.abs(x_global).astype(np.float64).sum())}
    out["param0_checksum"] = float(sum(p.detach().double().abs().sum()
                                       for p in state.model.parameters()))
    xb = mesh.put_batch(x_global, device)
    ms, launches, launches_bwd = [], [], []
    cudnn = torch.backends.cudnn
    saved_flags = cudnn.deterministic, cudnn.benchmark
    if args.deterministic:
        cudnn.deterministic, cudnn.benchmark = True, False
    try:
        with fp32_exact():
            for i, (which, warmed) in enumerate(SCHEDULE):
                with mesh.sharded_batch():
                    if drawn is not None:
                        draws = LatentDraws(**{k: None if v is None else (
                            v.to(device) if k.endswith("idx") else mesh.rank_rows(v.to(device)))
                            for k, v in drawn[i].items()})
                    else:
                        draws = draw_noise(cfg, xb, step_generator(DRAW_SEED, i, device))
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                n0, b0, t0 = (dilated_unit.launches, dilated_unit.launches_backward,
                              time.perf_counter())
                if which == "gen":
                    m = steps["gen"](state, xb, warmed, draws=draws, quantize=args.quantize)
                    out[f"step{i}_loss_gen"] = float(m["loss_gen"])
                else:
                    m = steps["dis"](state, xb, draws=draws, quantize=args.quantize)
                    out[f"step{i}_loss_dis"] = float(m["loss_dis"])
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                ms.append((time.perf_counter() - t0) * 1e3)
                if i == 0 and args.step0_grads and rank == 0:
                    torch.save({n: p.grad.detach().cpu() for n, p in
                                state.model.named_parameters()},
                               Path(args.out_dir) / "step0_grads.pt")
                launches.append(dilated_unit.launches - n0)
                launches_bwd.append(dilated_unit.launches_backward - b0)
                out[f"step{i}_metrics"] = {k: float(v) for k, v in m.items()}
    finally:
        cudnn.deterministic, cudnn.benchmark = saved_flags
    out["ms"], out["launches"], out["launches_backward"] = ms, launches, launches_bwd
    out["checksum"] = float(sum(p.detach().double().abs().sum()
                                for p in state.model.parameters()))
    out["buffer_checksum"] = float(sum(b.detach().double().abs().sum()
                                       for b in state.model.buffers() if b.is_floating_point()))
    out["dis_checksum"] = float(sum(p.detach().double().abs().sum()
                                    for p in state.discriminator.parameters()))
    out["digest"] = digest(state.model, state.discriminator)
    if args.save_state:
        torch.save({"model": state.model.state_dict(),
                    "discriminator": state.discriminator.state_dict()}, args.save_state)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser("rave_tpu_torch.parallel.mpworker")
    p.add_argument("--config", action="append", default=[])
    p.add_argument("--override", action="append", default=[])
    p.add_argument("--full", action="store_true", help="the preset's widths, not TINY")
    p.add_argument("--batch", type=int, default=4, help="rows per rank")
    p.add_argument("--device", default="cuda")
    p.add_argument("--quantize", action="store_true")
    p.add_argument("--deterministic", action="store_true",
                   help="cuDNN's deterministic algorithms, no autotuning")
    p.add_argument("--state", default=None)
    p.add_argument("--draws", default=None)
    p.add_argument("--save_state", default=None)
    p.add_argument("--out_dir", default=None)
    p.add_argument("--step0_grads", action="store_true",
                   help="rank 0 writes step 0's generator gradients to <out_dir>/step0_grads.pt")
    args = p.parse_args(argv)
    if args.step0_grads and not args.out_dir:
        p.error("--step0_grads needs --out_dir")
    if args.out_dir:
        Path(args.out_dir).mkdir(parents=True, exist_ok=True)
    out = run(args)
    line = json.dumps(out)
    if args.out_dir:
        (Path(args.out_dir) / f"rank{out['rank']}.json").write_text(line)
    print("MPWORKER " + line, flush=True)
    from rave_tpu_torch.parallel import mesh

    mesh.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
