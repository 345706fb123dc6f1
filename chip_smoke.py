#!/usr/bin/env python3
"""Drive rave_tpu_torch's v2 serving path and training step once on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of a checkout, on a machine with a CUDA card, `nvcc` and no
jax. Phases, each printing one line (any failure raises and exits non-zero):

  1. device  : the card, from `nvidia-smi` (name, power limit);
  2. build   : csrc/dilated_unit.cu compiled by nvcc for sm_90a;
  3. kernel  : the fused dilated unit against its plain PyTorch version at
               every (C, T, d, pad) of the v2 forward at B=16 x 131072
               samples, fp32 with TF32 off; max relative error <= 1e-4;
               both times by CUDA events;
  4. offline : compose(["v2"]) at full width with seeded random weights:
               (a) B=16 x 131072 samples, finite, the right shape, exactly
               22 kernel launches per forward, and the realtime factor;
               (b) B=1 x 65536, GPU (kernel) against CPU (plain) <= 1e-3;
  5. stream  : compose(["v2","causal"]), 32 blocks of block_size() through
               step_encode -> step_decode against the causal offline
               encode/decode of the same signal (delay 0) <= 1e-3, and the
               p50 time per block;
  6. grad    : the wrapper raises on float64 and on C % 8 != 0, with
               autograd recording or not; the fused unit under autograd
               (kernel forward, plain recompute backward) against plain
               autograd through the plain version, at the 11 centered v2
               shapes at B=8: y, dx, dw1, dw2 each within 1e-4 of its max;
               fwd+bwd times of both;
  7. train   : compose(["v2"]) at full width, B = data.batch = 8 x
               data.n_signal = 131072, fp32: the receptive field (and the
               valid-signal crop) from the port's probe, then pre-warmup
               generator steps, and adversarial generator and critic steps
               picked by pick_phase past phase_1_duration; exactly 22
               kernel launches per step, finite losses, the params of what
               trains moved, the global step; mean ms per step per phase
               after one warm step, and peak memory. Then the same seeded
               weights at B=1 x 131072, one pre-warmup generator step and
               one critic step on the GPU (kernel) and on the CPU (plain):
               losses within 1e-4; gradients against a float64 CPU run no
               further than max(1e-3, twice the CPU float32 run's own
               distance from it) (v2's log-spectral loss leaves float32
               gradients ~3% from float64 on any device: PERF.md);
  8. the kernels' JSON line, then the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Per-shape details go to build/chip_smoke.json.
"""
from __future__ import annotations

import copy
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNEL_SOURCE = "rave_tpu_torch/csrc/dilated_unit.cu"
KERNEL_REPLACES = "rave_tpu/ops/kernels/dilated_unit.py:75"
SAMPLE_RATE = 44100
KERNEL_TOL, MODEL_TOL = 1e-4, 1e-3
LOSS_TOL, GRAD_FLOOR = 1e-4, 1e-3  # GPU vs CPU step: loss; gradient bound's floor
# (C, T, dilations) of the residual units at B=16 x 131072 samples; each
# shape runs once in the encoder and once in the decoder of a forward
UNIT_SHAPES = [(96, 8192, (1, 3, 9)), (192, 2048, (1, 3, 9)), (384, 512, (1, 3, 9)),
               (768, 128, (1, 3))]
BATCH, N_SIGNAL = 16, 131072
TRAIN_BATCH = 8  # data.batch of the v2 preset: the unit shapes above at half the batch


def rel_err(a, b, floor: float = 1e-12) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(floor))


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def refuses(call, error) -> bool:
    """True when `call()` raises `error` (a check that the wrapper refuses
    an input; any other exception propagates)."""
    try:
        call()
    except error:
        return True
    return False


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call, by CUDA events, after two warm calls."""
    import torch

    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device() -> str:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port has no CPU fallback here")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return card


def phase_build() -> dict:
    from rave_tpu_torch.ops.kernels import build, dilated_unit

    t0 = time.perf_counter()
    lib = build.build("dilated_unit")
    dilated_unit.kernel_tile(96, 3, 1)  # loads the library and binds it
    seconds = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in lib.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    info = {"seconds": seconds, "library": str(lib.relative_to(ROOT)), "nvcc": build.nvcc(),
            "flags": " ".join(build.NVCC_FLAGS), "ptxas": ptxas}
    print(f"build: {KERNEL_SOURCE} -> {info['library']} by {info['nvcc']} "
          f"[{info['flags']}] in {seconds:.2f} s; ptxas: {' | '.join(ptxas[:6])}", flush=True)
    return info


def phase_kernel() -> list:
    import torch

    from rave_tpu_torch.nn.conv import get_padding
    from rave_tpu_torch.ops.kernels.dilated_unit import (
        fused_dilated_unit, fused_dilated_unit_reference, kernel_tile,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for C, T, dilations in UNIT_SHAPES:
        x = torch.randn(BATCH, C, T, device="cuda", generator=gen)
        w1 = torch.randn(C, C, 3, device="cuda", generator=gen) / math.sqrt(3 * C)
        w2 = torch.randn(C, C, device="cuda", generator=gen) / math.sqrt(C)
        for d in dilations:
            for mode in ("centered", "causal"):
                left, right = get_padding(3, 1, d, mode)
                args = (x, w1, w2, d, left, right)
                with torch.inference_mode():
                    y_k = fused_dilated_unit(*args)
                    y_p = fused_dilated_unit_reference(*args)
                    torch.cuda.synchronize()
                    err, abs_err = rel_err(y_k, y_p), float((y_k - y_p).abs().max())
                    check(bool(torch.isfinite(y_k).all()), f"kernel output not finite at {C, T, d, mode}")
                    check(err <= KERNEL_TOL, f"kernel vs plain at C={C} T={T} d={d} {mode}: "
                                             f"rel err {err:.3e} > {KERNEL_TOL}")
                    ms = cuda_ms(lambda: fused_dilated_unit(*args), 20)
                    plain_ms = cuda_ms(lambda: fused_dilated_unit_reference(*args), 20)
                flop = 2 * 4 * C * C * T * BATCH
                rows.append({"C": C, "T": T, "d": d, "mode": mode, "tile": kernel_tile(C, 3, d),
                             "rel_err": err, "max_abs_err": abs_err, "ms": ms,
                             "plain_ms": plain_ms, "tflops": flop / ms / 1e9,
                             "plain_tflops": flop / plain_ms / 1e9})
    worst = max(r["rel_err"] for r in rows)
    summary = "; ".join(f"{r['C']}x{r['T']} d{r['d']} {r['mode'][:4]} {r['ms']:.3f}/{r['plain_ms']:.3f}"
                        for r in rows)
    print(f"kernel: {len(rows)} shapes, B={BATCH}, max rel err {worst:.2e} <= {KERNEL_TOL}; "
          f"kernel/plain ms: {summary}", flush=True)
    return rows


def phase_offline() -> dict:
    import torch

    from rave_tpu_torch.config import compose
    from rave_tpu_torch.factory import build_rave
    from rave_tpu_torch.ops.kernels import dilated_unit

    cfg = compose(["v2"])
    cpu_model = build_rave(cfg, seed=0).eval()
    model = copy.deepcopy(cpu_model).cuda()
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(BATCH, 1, N_SIGNAL, device="cuda", generator=gen) * 0.1
    T_lat = N_SIGNAL // cfg.decimation()
    eps = torch.randn(BATCH, cfg.latent_size, T_lat, device="cuda", generator=gen)
    with torch.inference_mode():
        model(x, eps=eps)  # warm (cuDNN heuristics, allocator)
        torch.cuda.synchronize()
        dilated_unit.launches = 0
        y = model(x, eps=eps)
        torch.cuda.synchronize()
        launches = dilated_unit.launches
        check(tuple(y.shape) == (BATCH, 1, N_SIGNAL), f"output shape {tuple(y.shape)}")
        check(bool(torch.isfinite(y).all()), "offline output is not finite")
        check(launches == 22, f"{launches} kernel launches in one forward, expected 22")
        iters = 5
        t0 = time.perf_counter()
        for _ in range(iters):
            model(x, eps=eps)
        torch.cuda.synchronize()
        sec = (time.perf_counter() - t0) / iters
        rtf = BATCH * N_SIGNAL / SAMPLE_RATE / sec

        # (b) the same weights and eps at B=1 x 65536: kernel on the GPU, plain on the CPU
        n = 65536
        xb = torch.randn(1, 1, n, generator=torch.Generator().manual_seed(2)) * 0.1
        eb = torch.randn(1, cfg.latent_size, n // cfg.decimation(),
                         generator=torch.Generator().manual_seed(3))
        y_cpu = cpu_model(xb, eps=eb)
        y_gpu = model(xb.cuda(), eps=eb.cuda()).cpu()
        err = rel_err(y_gpu, y_cpu)
        check(err <= MODEL_TOL, f"GPU vs CPU forward rel err {err:.3e} > {MODEL_TOL}")
    out = {"launches": launches, "forward_ms": sec * 1e3, "realtime_factor": rtf,
           "gpu_vs_cpu_rel_err": err}
    print(f"offline: v2 B={BATCH} x {N_SIGNAL}, {launches} kernel launches per forward, "
          f"{sec * 1e3:.2f} ms per forward = {rtf:.1f}x realtime; B=1 x {n} GPU vs CPU "
          f"rel err {err:.2e} <= {MODEL_TOL}", flush=True)
    return out


def phase_stream() -> dict:
    import torch

    from rave_tpu_torch.config import compose
    from rave_tpu_torch.factory import build_rave
    from rave_tpu_torch.nn.streaming import init_stream_state

    cfg = compose(["v2", "causal"])
    model = build_rave(cfg, stream_batch=1, seed=4).eval().cuda()
    check(model.encode_delay == 0 and model.decode_delay == 0, "causal delays are not 0")
    block, n_blocks, D = cfg.block_size(), 32, cfg.latent_size
    x = torch.randn(1, 1, block * n_blocks, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(5)) * 0.1
    with torch.inference_mode():
        init_stream_state(model, 1)
        zs, ys, times = [], [], []
        for i in range(n_blocks):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            z = model.step_encode(x[..., i * block:(i + 1) * block])
            y = model.step_decode(z[:, :D])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            zs.append(z)
            ys.append(y)
        z_st, y_st = torch.cat(zs, -1), torch.cat(ys, -1)
        z_off = model.encode(x)
        y_off = model.decode(z_off[:, :D])
        z_err, y_err = rel_err(z_st, z_off), rel_err(y_st, y_off)
        check(y_st.shape == y_off.shape == x.shape, f"stream shape {tuple(y_st.shape)}")
        check(bool(torch.isfinite(y_st).all()), "streaming output is not finite")
        check(z_err <= MODEL_TOL and y_err <= MODEL_TOL,
              f"stream vs offline rel err z {z_err:.3e}, y {y_err:.3e} > {MODEL_TOL}")
    p50 = statistics.median(times) * 1e3
    out = {"block": block, "blocks": n_blocks, "block_ms_p50": p50,
           "block_budget_ms": block / SAMPLE_RATE * 1e3, "z_rel_err": z_err, "y_rel_err": y_err}
    print(f"stream: v2 causal, {n_blocks} blocks of {block} samples, p50 {p50:.3f} ms per "
          f"block (budget {out['block_budget_ms']:.2f} ms); vs offline rel err z {z_err:.2e}, "
          f"y {y_err:.2e} <= {MODEL_TOL}", flush=True)
    return out


def phase_grad() -> list:
    import torch

    from rave_tpu_torch.nn.conv import get_padding
    from rave_tpu_torch.ops.kernels.dilated_unit import (
        fused_dilated_unit, fused_dilated_unit_reference,
    )

    # what the kernel does not take (non-fp32, C % 8 != 0) must raise on the
    # card, with autograd recording or not: no call quietly runs the plain version
    for C, dtype, error in ((8, torch.float64, TypeError), (12, torch.float32, ValueError)):
        w1 = torch.zeros(C, C, 3, device="cuda", dtype=dtype)
        w2 = torch.zeros(C, C, device="cuda", dtype=dtype)
        for grad in (False, True):
            x = torch.zeros(1, C, 16, device="cuda", dtype=dtype, requires_grad=grad)
            check(refuses(lambda: fused_dilated_unit(x, w1, w2, 1, 1, 1), error),
                  f"the wrapper took C={C} {dtype} (grad {grad}) instead of raising {error}")

    gen = torch.Generator(device="cuda").manual_seed(10)
    rows = []
    for C, T, dilations in UNIT_SHAPES:
        x = torch.randn(TRAIN_BATCH, C, T, device="cuda", generator=gen)
        w1 = torch.randn(C, C, 3, device="cuda", generator=gen) / math.sqrt(3 * C)
        w2 = torch.randn(C, C, device="cuda", generator=gen) / math.sqrt(C)
        g = torch.randn(TRAIN_BATCH, C, T, device="cuda", generator=gen)
        leaves = [t.requires_grad_() for t in (x, w1, w2)]
        for d in dilations:
            left, right = get_padding(3, 1, d, "centered")

            def fwd_bwd(fn):
                y = fn(*leaves, d, left, right)
                return (y, *torch.autograd.grad(y, leaves, g))

            got = fwd_bwd(fused_dilated_unit)
            want = fwd_bwd(fused_dilated_unit_reference)
            torch.cuda.synchronize()
            errs = {k: rel_err(a.detach(), b.detach())
                    for k, a, b in zip(("y", "dx", "dw1", "dw2"), got, want)}
            check(all(bool(torch.isfinite(a).all()) for a in got), f"grad not finite at {C, T, d}")
            check(max(errs.values()) <= KERNEL_TOL,
                  f"autograd.Function vs plain at C={C} T={T} d={d}: {errs} > {KERNEL_TOL}")
            ms = cuda_ms(lambda: fwd_bwd(fused_dilated_unit), 10)
            plain_ms = cuda_ms(lambda: fwd_bwd(fused_dilated_unit_reference), 10)
            rows.append({"C": C, "T": T, "d": d, **{f"{k}_rel_err": v for k, v in errs.items()},
                         "fwd_bwd_ms": ms, "plain_fwd_bwd_ms": plain_ms})
    worst = max(max(r[f"{k}_rel_err"] for k in ("y", "dx", "dw1", "dw2")) for r in rows)
    summary = "; ".join(f"{r['C']}x{r['T']} d{r['d']} {r['fwd_bwd_ms']:.3f}/{r['plain_fwd_bwd_ms']:.3f}"
                        for r in rows)
    print(f"grad: float64 and C=12 refused with and without autograd; {len(rows)} shapes, "
          f"B={TRAIN_BATCH}, y/dx/dw1/dw2 max rel err {worst:.2e} <= "
          f"{KERNEL_TOL}; fwd+bwd ms Function/plain: {summary}", flush=True)
    return rows


def _grad_errors(grads, ref) -> dict:
    """Per tensor: max abs difference over the reference's max (or 1e-4 where
    that is smaller: the hinge loss's last-bias gradients cancel to zero)."""
    return {n: rel_err(grads[n], ref[n].to(grads[n].dtype), floor=1e-4) for n in ref}


def phase_train() -> dict:
    import torch

    from rave_tpu_torch.config import compose
    from rave_tpu_torch.ops.kernels import dilated_unit
    from rave_tpu_torch.train.analysis import crop_frames, receptive_field
    from rave_tpu_torch.train.state import create_train_state, make_optimizers
    from rave_tpu_torch.train.steps import build_train_steps, pick_phase

    cfg = compose(["v2"])
    B, N, t = cfg.data.batch, cfg.data.n_signal, cfg.train
    t0 = time.perf_counter()
    rf = receptive_field(cfg, device="cuda")
    crop = crop_frames(cfg, rf)
    probe_s = time.perf_counter() - t0
    steps = build_train_steps(cfg, crop)
    state = create_train_state(cfg, seed=0, device="cuda")
    x = torch.randn(B, 1, N, device="cuda", generator=torch.Generator(device="cuda").manual_seed(6))
    x = x * 0.1
    noise = torch.Generator(device="cuda").manual_seed(7)
    snapshot = lambda m: [p.detach().clone() for p in m.parameters()]  # noqa: E731
    moved = lambda m, before: sum(not torch.equal(p, q)  # noqa: E731
                                  for p, q in zip(m.parameters(), before))
    gen0, dis0 = snapshot(state.model), snapshot(state.discriminator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = {"gen_prewarmup": [], "gen_adversarial": [], "dis": []}
    last, launches = {}, 0

    def one_step(which: str, warmed: bool) -> None:
        nonlocal launches
        step = state.step
        torch.cuda.synchronize()
        dilated_unit.launches = 0
        t1 = time.perf_counter()
        if which == "dis":
            m = steps["dis"](state, x, generator=noise)
        else:
            m = steps["gen"](state, x, warmed, generator=noise)
        torch.cuda.synchronize()
        name = "dis" if which == "dis" else ("gen_adversarial" if warmed else "gen_prewarmup")
        times[name].append(time.perf_counter() - t1)
        check(dilated_unit.launches == 22,
              f"{dilated_unit.launches} kernel launches in a {name} step, expected 22")
        launches += dilated_unit.launches
        check(state.step == step + 1, f"global step {state.step} after step {step}")
        bad = [k for k, v in m.items() if not math.isfinite(float(v))]
        check(not bad, f"{name} step: non-finite {bad}")
        last[name] = {k: float(v) for k, v in m.items()}

    for _ in range(5):
        one_step("gen", False)
    check(moved(state.model, gen0) > 0, "pre-warmup steps moved no generator param")
    check(moved(state.discriminator, dis0) == 0, "pre-warmup steps moved the critic")
    state.step = t.phase_1_duration
    dis1 = snapshot(state.discriminator)
    for _ in range(4 * t.update_discriminator_every):
        which, warmed, _ = pick_phase(cfg, state.step)
        one_step(which, warmed)
    check(len(times["dis"]) >= 2 and len(times["gen_adversarial"]) >= 2, f"phases {times}")
    check(moved(state.discriminator, dis1) > 0, "critic steps moved no critic param")
    check(state.step == t.phase_1_duration + 4 * t.update_discriminator_every, "global step")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    ms = {k: statistics.mean(v[1:]) * 1e3 for k, v in times.items()}

    # the same seeded weights at B=1: GPU (kernel) against CPU (plain), and a
    # float64 CPU run as the referee of both float32 gradients
    xb = torch.randn(1, 1, N, generator=torch.Generator().manual_seed(8)) * 0.1
    eb = torch.randn(1, cfg.latent_size, N // cfg.decimation(),
                     generator=torch.Generator().manual_seed(9))
    compare = {}
    for which in ("gen", "dis"):
        runs = []
        for device, dtype in (("cuda", torch.float32), ("cpu", torch.float32),
                              ("cpu", torch.float64)):
            st = create_train_state(cfg, seed=0, device=device)
            st.model.to(dtype)
            st.discriminator.to(dtype)
            st.gen_opt, st.dis_opt = make_optimizers(cfg, st.model, st.discriminator)
            if which == "dis":
                st.step = t.phase_1_duration
            xd, ed = xb.to(device, dtype), eb.to(device, dtype)
            m = steps["gen"](st, xd, False, eps=ed) if which == "gen" else steps["dis"](st, xd, eps=ed)
            module = st.model if which == "gen" else st.discriminator
            runs.append(({k: float(v) for k, v in m.items()},
                         {n: p.grad.cpu() for n, p in module.named_parameters()}))
        (m_gpu, g_gpu), (m_cpu, g_cpu), (_, g_64) = runs
        loss_err = max(abs(m_gpu[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-2) for k in m_cpu)
        gpu_vs_64, cpu_vs_64 = _grad_errors(g_gpu, g_64), _grad_errors(g_cpu, g_64)
        gpu_vs_cpu = _grad_errors(g_gpu, g_cpu)
        bound = max(GRAD_FLOOR, 2 * max(cpu_vs_64.values()))
        compare[which] = {"loss_rel_err": loss_err, "grad_gpu_vs_cpu": max(gpu_vs_cpu.values()),
                          "grad_gpu_vs_f64": max(gpu_vs_64.values()),
                          "grad_cpu_vs_f64": max(cpu_vs_64.values()), "grad_bound": bound,
                          "grad_gpu_vs_f64_median": statistics.median(gpu_vs_64.values()),
                          "grad_cpu_vs_f64_median": statistics.median(cpu_vs_64.values())}
    out = {"rf": list(rf), "crop_frames": list(crop), "probe_s": probe_s, "batch": B,
           "n_signal": N, "ms_per_step": ms, "steps": {k: len(v) for k, v in times.items()},
           "launches_per_step": 22, "launches": launches, "peak_gb": peak_gb,
           "last_metrics": last, "gpu_vs_cpu": compare}
    print(f"train: v2 B={B} x {N}, rf {rf} samples -> crop {crop} band frames (probe "
          f"{probe_s:.1f} s); ms per step (mean after one warm step): "
          + ", ".join(f"{k} {v:.1f} (x{len(times[k]) - 1})" for k, v in ms.items())
          + f"; 22 kernel launches per step, {launches} in all; peak {peak_gb:.2f} GiB; "
          + "; ".join(f"B=1 {k}: loss GPU vs CPU {c['loss_rel_err']:.1e}, grad GPU vs CPU "
                      f"{c['grad_gpu_vs_cpu']:.2e}, vs float64 GPU {c['grad_gpu_vs_f64']:.2e} "
                      f"CPU {c['grad_cpu_vs_f64']:.2e} (bound {c['grad_bound']:.2e})"
                      for k, c in compare.items()), flush=True)
    for k, c in compare.items():
        check(c["loss_rel_err"] <= LOSS_TOL, f"{k} step: GPU vs CPU loss {c['loss_rel_err']:.3e}")
        check(c["grad_gpu_vs_f64"] <= c["grad_bound"],
              f"{k} step: GPU gradients {c['grad_gpu_vs_f64']:.3e} from float64, bound "
              f"{c['grad_bound']:.3e}")
    return out


def main() -> None:
    if not (ROOT / KERNEL_SOURCE).is_file():
        raise SystemExit(f"chip_smoke: {KERNEL_SOURCE} not found; run from a checkout")
    sys.path.insert(0, str(ROOT))
    import torch

    card = phase_device()
    build_info = phase_build()
    rows = phase_kernel()
    offline = phase_offline()
    stream = phase_stream()
    grad = phase_grad()
    train = phase_train()
    foreign = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "rave_tpu"))
    check(not foreign, f"the port loaded the JAX package or jax: {foreign[:5]}")

    main_rows = [r for r in rows if r["mode"] == "centered"]  # the offline forward's units
    kernels = {"kernels": [{
        "name": "fused_dilated_unit", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": offline["launches"],
        "launches_train": train["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        # one forward's 22 unit calls: each centered shape in encoder and decoder
        "ms": 2 * sum(r["ms"] for r in main_rows),
        "plain_ms": 2 * sum(r["plain_ms"] for r in main_rows),
    }]}
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "build": build_info, "kernel_shapes": rows, "offline": offline,
         "stream": stream, "grad_shapes": grad, "train": train, **kernels}, indent=1))
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
