#!/usr/bin/env python3
"""Drive rave_tpu_torch's v2 serving path and training steps once on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of a checkout, on a machine with a CUDA card, `nvcc` and no
jax. Phases, each printing one line (any failure raises and exits non-zero):

  1. device  : the card, from `nvidia-smi` (name, power limit);
  2. build   : csrc/dilated_unit.cu compiled by nvcc for sm_90a;
  3. kernel  : the fused dilated unit against its plain PyTorch version at
               every (C, T, d, pad) of the v2 forward at B=16 x 131072
               samples, fp32 with TF32 off, and at each C a ragged length
               (T - 21: no whole 128-frame tile, padded for TMA's 16-byte
               rows) and B=1 (a grid that fills few SMs), and the centered
               shapes at B=2 (phase 11's validation and eval batches); max
               relative error <= 1e-4; both times by CUDA events;
  4. kernel_bf16 : the bf16 variant at the 22 unit shapes of a B=8 step
               (centered and causal), the 11 centered ones at B=16, and the
               ragged and B=1 shapes of phase 3; the referee is the plain
               version in fp32 on the same bf16 inputs and weights: the
               kernel may be no further from it than 1.1x the plain bf16
               version, and within 1e-2 of the plain bf16;
               (kernel and plain times are device times: `cuda_ms`);
  5. offline : compose(["v2"]) at full width with seeded random weights:
               (a) B=16 x 131072 samples, finite, the right shape, exactly
               22 kernel launches per forward, and the realtime factor;
               (b) B=1 x 65536, GPU (kernel) against CPU (plain) <= 1e-3;
  6. stream  : compose(["v2","causal"]), 32 blocks of block_size() through
               step_encode -> step_decode against the causal offline
               encode/decode of the same signal (delay 0) <= 1e-3, and the
               p50 time per block;
  7. grad    : the wrapper raises on float64, on mixed fp32/bf16, on C % 8
               in fp32 and C % 16 in bf16, and on a halo wider than a TMA
               box, with autograd recording or not;
               the fused unit under autograd (kernel forward, plain
               recompute backward) against plain autograd through the plain
               version at the 11 centered v2 shapes at B=8: in fp32 y, dx,
               dw1, dw2 each within 1e-4 of its max; in bf16 by the rule of
               phase 4 against plain fp32 autograd; fwd+bwd times;
  8. train   : compose(["v2"]) at full width, B = data.batch = 8 x
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
  9. train_bf16 : the same with train.bf16 and train.bf16_dis (the CLI's
               `--bf16`): 22 bf16 launches and no fp32 launch per step. Then
               at B=1 x 131072 from the same weights, bf16 against fp32 on
               the card for a pre-warmup generator step (at v2's
               log_epsilon and at 1e-3) and a critic step: losses within 5%,
               the global relative L2 distance of the gradients under the
               bounds of GRAD_BF16_BOUND (their reasons are in PERF.md);
 10. remat   : one fp32 pre-warmup step at B=8 x 131072 with and without
               train.remat from the same state and noise, cuDNN
               deterministic, after one warm step: losses equal to 1e-6,
               gradients to 1e-5 (global relative L2), 44 launches (forward
               and recompute) against 22, and a lower peak memory;
 11. loop    : the training driver through the port's command line, in
               process (`rave_tpu_torch.cli.main`): a seeded corpus of .wav
               tones, chirps and noise (104 records of 131072 samples, 2 of
               them the validation split) -> `preprocess` -> `train --config
               v2` at B=8 x 131072 with the device-resident dataset,
               pre-warmup, adversarial and critic steps, validation before
               and after the warmup, periodic and final checkpoints -> a
               second `train` with more steps that resumes -> a `--bf16
               --device_data off` run of all three programs through the host
               loader -> `eval`
               twice. Each step, validation and checkpoint save of the
               training loop is observed in process (it ends in a synchronize and
               records its time and its launches of each variant): exactly
               22 launches of the step's variant per step and 22 fp32 per
               validation or eval batch; finite losses; the PCA buffers set
               by the pre-warmup validation; the run dir's files and
               checkpoints; the resumed state bit-equal to its checkpoint
               and its first batch the one an unbroken device pipeline makes
               at that step; eval finite and the same twice. Prints loop ms
               per step by phase against phase `train`'s bare steps, the
               device-data batch's device ms, the checkpoint's seconds and
               MB, and the peak memory;
 12. the kernels' JSON line, then the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Per-shape details go to build/chip_smoke.json; the loop phase works in
build/loop (its corpus, db and run dirs).
"""
from __future__ import annotations

import contextlib
import copy
import io
import json
import math
import shutil
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
BF16_MARGIN, BF16_TOL = 1.1, 1e-2  # bf16 kernel vs the fp32 referee; vs plain bf16
BF16_LOSS_TOL = 0.05  # bf16 step losses against fp32 (rave_tpu's tests/test_train.py:140)
# bf16 vs fp32 step gradients, global relative L2 (their reasons: PERF.md, section 6)
GRAD_BF16_BOUND = {"gen": 2.0, "gen_eps1e-3": 0.2, "dis": 0.05}
REMAT_LOSS_TOL, REMAT_GRAD_TOL = 1e-6, 1e-5
# (C, T, dilations) of the residual units at B=16 x 131072 samples; each
# shape runs once in the encoder and once in the decoder of a forward
UNIT_SHAPES = [(96, 8192, (1, 3, 9)), (192, 2048, (1, 3, 9)), (384, 512, (1, 3, 9)),
               (768, 128, (1, 3))]
BATCH, N_SIGNAL = 16, 131072
TRAIN_BATCH = 8  # data.batch of the v2 preset: the unit shapes above at half the batch
# the H100's peaks (NVIDIA's data sheet, SXM, dense): fp32 at fp32 accuracy on
# the tensor cores is 3xTF32, a third of TF32's 495 TFLOP/s
PEAK_FLOPS = {"fp32": 495e12 / 3, "bf16": 989e12}
HBM_BYTES_PER_S = 3.35e12
SLEEP_CYCLES_PER_CALL = 1_000_000  # ~0.6 ms of the card's clock per timed call (cuda_ms)
# the loop phase: 104 records (2 in the validation split); a short warmup and a critic
# step every other step, so that a few steps run all three programs
LOOP_RECORDS, LOOP_FILES = 104, 4
LOOP_SCHEDULE = ["train.phase_1_duration=6", "train.update_discriminator_every=2",
                 "train.ema=0.999"]  # EMA on: validation and `eval --ema_weights` use it
LOOP_STEPS, LOOP_RESUME_STEPS = 12, 16
LOOP_BF16_STEPS, LOOP_BF16_WARMUP = 10, 4  # three or four steps of each program
LOOP_VAL_EVERY, LOOP_SAVE_EVERY = 6, 8
EVAL_METRICS = ("spectral_distance", "waveform_l1", "frechet_mel_distance")
LOOP_VAL_BATCH = 2  # the validation split of LOOP_RECORDS records, in one batch


def rel_err(a, b, floor: float = 1e-12) -> float:
    return float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(floor))


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
    """Mean device milliseconds per call, by CUDA events, after two warm
    calls. The card first sleeps while the host queues all the calls, so a
    call whose host work outlasts its device work is timed by the latter:
    this is the device's time per call, not the host's."""
    import torch

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


def unit_bound(rows, batch: int, dtype: str, backward: bool = False) -> dict:
    """The least time the card could take for the units of `rows` (one
    launch each): per launch the larger of its bytes (x read and y written
    once, both weights read once) over the HBM rate and its FLOP, 2 (K+1)
    C^2 T B, over the peak for the type; summed over the launches. With
    `backward`, forward and backward together: x and the output's gradient
    read, y and dx written, the weights read and their gradients written,
    and three times the forward's FLOP (y, dx and dw)."""
    elem = 4 if dtype == "fp32" else 2
    acts, weights, work = (4, 2, 3) if backward else (2, 1, 1)
    bytes_s = ops_s = bound_s = 0.0
    for r in rows:
        C, T, K = r["C"], r["T"], 3
        b = (acts * batch * C * T + weights * (K + 1) * C * C) * elem / HBM_BYTES_PER_S
        o = work * 2 * (K + 1) * C * C * T * batch / PEAK_FLOPS[dtype]
        bytes_s, ops_s, bound_s = bytes_s + b, ops_s + o, bound_s + max(b, o)
    return {"bound_ms": bound_s * 1e3, "bound_by": "operations" if ops_s >= bytes_s else "bytes",
            "bytes_ms": bytes_s * 1e3, "ops_ms": ops_s * 1e3}


def unit_weights(C: int, gen, dtype):
    import torch

    w1 = torch.randn(C, C, 3, device="cuda", generator=gen) / math.sqrt(3 * C)
    w2 = torch.randn(C, C, device="cuda", generator=gen) / math.sqrt(C)
    return w1.to(dtype), w2.to(dtype)


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
    dilated_unit.smem_limit()  # loads the library and binds it
    seconds = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in lib.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    info = {"seconds": seconds, "library": str(lib.relative_to(ROOT)), "nvcc": build.nvcc(),
            "flags": " ".join(build.NVCC_FLAGS), "ptxas": ptxas}
    print(f"build: {KERNEL_SOURCE} -> {info['library']} by {info['nvcc']} "
          f"[{info['flags']}] in {seconds:.2f} s; ptxas: {' | '.join(ptxas[:6])}", flush=True)
    return info


def kernel_cases(batch: int, modes) -> list:
    """(case, B, C, T, d, mode) of the kernel phases: every v2 unit shape at
    `batch` in each mode; then, at each C and its widest dilation, centered,
    a ragged length (T - 21) at `batch` and the main length at B=1."""
    cases = [("main", batch, C, T, d, mode) for C, T, dils in UNIT_SHAPES for d in dils
             for mode in modes]
    for C, T, dils in UNIT_SHAPES:
        cases += [("ragged", batch, C, T - 21, dils[-1], "centered"),
                  ("b1", 1, C, T, dils[-1], "centered")]
    return cases


def phase_kernel() -> list:
    import torch

    from rave_tpu_torch.nn.conv import get_padding
    from rave_tpu_torch.ops.kernels.dilated_unit import (
        fused_dilated_unit, fused_dilated_unit_reference, kernel_plan,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    # the loop's validation and eval batches: the 2 clips of the validation split
    val_cases = [("val", LOOP_VAL_BATCH, C, T, d, "centered") for C, T, dils in UNIT_SHAPES
                 for d in dils]
    for case, B, C, T, d, mode in kernel_cases(BATCH, ("centered", "causal")) + val_cases:
        x = torch.randn(B, C, T, device="cuda", generator=gen)
        w1, w2 = unit_weights(C, gen, torch.float32)
        left, right = get_padding(3, 1, d, mode)
        args = (x, w1, w2, d, left, right)
        with torch.inference_mode():
            y_k = fused_dilated_unit(*args)
            y_p = fused_dilated_unit_reference(*args)
            torch.cuda.synchronize()
            err, abs_err = rel_err(y_k, y_p), float((y_k - y_p).abs().max())
            check(bool(torch.isfinite(y_k).all()) and y_k.shape == x.shape,
                  f"kernel output not finite or of shape {tuple(y_k.shape)} at {B, C, T, d, mode}")
            check(err <= KERNEL_TOL, f"kernel vs plain at B={B} C={C} T={T} d={d} {mode}: "
                                     f"rel err {err:.3e} > {KERNEL_TOL}")
            ms = cuda_ms(lambda: fused_dilated_unit(*args), 20)
            plain_ms = cuda_ms(lambda: fused_dilated_unit_reference(*args), 20)
        flop = 2 * 4 * C * C * T * B
        rows.append({"case": case, "B": B, "C": C, "T": T, "d": d, "mode": mode,
                     "plan": kernel_plan(B, C, T, 3, d, left, False)._asdict(),
                     "rel_err": err, "max_abs_err": abs_err, "ms": ms,
                     "plain_ms": plain_ms, "tflops": flop / ms / 1e9,
                     "plain_tflops": flop / plain_ms / 1e9})
    worst = max(r["rel_err"] for r in rows)
    print(f"kernel: {len(rows)} shapes, max rel err {worst:.2e} <= {KERNEL_TOL}; "
          f"kernel/plain ms: {shape_summary(rows)}", flush=True)
    return rows


def shape_summary(rows) -> str:
    return "; ".join(f"{'' if r['case'] == 'main' else r['case'] + ' '}B{r['B']} {r['C']}x{r['T']} "
                     f"d{r['d']} {r['mode'][:4]} {r['ms']:.3f}/{r['plain_ms']:.3f}" for r in rows)


def phase_kernel_bf16() -> list:
    import torch

    from rave_tpu_torch.nn.conv import get_padding
    from rave_tpu_torch.ops.kernels.dilated_unit import (
        fused_dilated_unit, fused_dilated_unit_reference, kernel_plan,
    )

    gen = torch.Generator(device="cuda").manual_seed(20)
    rows = []
    cases = (kernel_cases(TRAIN_BATCH, ("centered", "causal"))
             + [c for c in kernel_cases(BATCH, ("centered",)) if c[0] == "main"])
    for case, B, C, T, d, mode in cases:
        x = torch.randn(B, C, T, device="cuda", generator=gen).bfloat16()
        w1, w2 = unit_weights(C, gen, torch.bfloat16)
        left, right = get_padding(3, 1, d, mode)
        args = (x, w1, w2, d, left, right)
        with torch.inference_mode():
            y_k = fused_dilated_unit(*args)
            y_p = fused_dilated_unit_reference(*args)
            y_32 = fused_dilated_unit_reference(x.float(), w1.float(), w2.float(), d, left, right)
            torch.cuda.synchronize()
            check(y_k.dtype == torch.bfloat16 and bool(torch.isfinite(y_k).all())
                  and y_k.shape == x.shape,
                  f"bf16 kernel output {y_k.dtype}, {tuple(y_k.shape)} or not finite at "
                  f"{B, C, T, d, mode}")
            err_k, err_p = rel_err(y_k, y_32), rel_err(y_p, y_32)
            err_kp = rel_err(y_k, y_p)
            check(err_k <= BF16_MARGIN * err_p and err_kp <= BF16_TOL,
                  f"bf16 kernel at B={B} C={C} T={T} d={d} {mode}: {err_k:.3e} from the fp32 "
                  f"referee (plain bf16 {err_p:.3e}), {err_kp:.3e} from plain bf16")
            ms = cuda_ms(lambda: fused_dilated_unit(*args), 20)
            plain_ms = cuda_ms(lambda: fused_dilated_unit_reference(*args), 20)
        rows.append({"case": case, "B": B, "C": C, "T": T, "d": d, "mode": mode,
                     "plan": kernel_plan(B, C, T, 3, d, left, True)._asdict(),
                     "rel_err_fp32": err_k, "plain_rel_err_fp32": err_p, "rel_err_plain": err_kp,
                     "max_abs_err": float((y_k.float() - y_p.float()).abs().max()),
                     "ms": ms, "plain_ms": plain_ms})
    worst = max(r["rel_err_plain"] for r in rows)
    ratio = max(r["rel_err_fp32"] / r["plain_rel_err_fp32"] for r in rows)
    summary = shape_summary(rows)
    print(f"kernel_bf16: {len(rows)} shapes; from the fp32 referee at most {ratio:.2f}x the plain "
          f"bf16's error (<= {BF16_MARGIN}); from plain bf16 <= {worst:.2e} (<= {BF16_TOL}); "
          f"kernel/plain bf16 ms: {summary}", flush=True)
    return rows


def phase_offline() -> dict:
    import torch

    from rave_tpu_torch.config import compose
    from rave_tpu_torch.factory import build_rave
    from rave_tpu_torch.ops.kernels import dilated_unit

    cfg = compose(["v2"])
    cpu_model = build_rave(cfg, seed=0, device="cpu").eval()
    model = copy.deepcopy(cpu_model).cuda()
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(BATCH, 1, N_SIGNAL, device="cuda", generator=gen) * 0.1
    T_lat = N_SIGNAL // cfg.decimation()
    eps = torch.randn(BATCH, cfg.latent_size, T_lat, device="cuda", generator=gen)
    with torch.inference_mode():
        model(x, eps=eps)  # warm (cuDNN heuristics, allocator)
        torch.cuda.synchronize()
        dilated_unit.launches = dilated_unit.launches_bf16 = 0
        y = model(x, eps=eps)
        torch.cuda.synchronize()
        launches = dilated_unit.launches
        check(tuple(y.shape) == (BATCH, 1, N_SIGNAL), f"output shape {tuple(y.shape)}")
        check(bool(torch.isfinite(y).all()), "offline output is not finite")
        check(launches == 22 and dilated_unit.launches_bf16 == 0,
              f"{launches} kernel launches ({dilated_unit.launches_bf16} bf16) in one forward, "
              f"expected 22 fp32")
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
    model = build_rave(cfg, stream_batch=1, seed=4, device="cuda").eval()
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


def phase_grad() -> dict:
    import torch

    from rave_tpu_torch.nn.conv import get_padding
    from rave_tpu_torch.ops.kernels.dilated_unit import (
        fused_dilated_unit, fused_dilated_unit_reference,
    )

    # what the kernel does not take must raise on the card, with autograd
    # recording or not: no call quietly runs the plain version
    f32, f64, b16 = torch.float32, torch.float64, torch.bfloat16
    refusals = [(8, f64, f64, 1, TypeError), (16, b16, f32, 1, TypeError),
                (12, f32, f32, 1, ValueError), (24, b16, b16, 1, ValueError),
                (8, f32, f32, 60, ValueError)]  # (C, dtype of x, of the weights, dilation, error)
    for C, x_dtype, w_dtype, d, error in refusals:
        w1 = torch.zeros(C, C, 3, device="cuda", dtype=w_dtype)
        w2 = torch.zeros(C, C, device="cuda", dtype=w_dtype)
        for grad in (False, True):
            x = torch.zeros(1, C, 16, device="cuda", dtype=x_dtype, requires_grad=grad)
            check(refuses(lambda: fused_dilated_unit(x, w1, w2, d, d, d), error),
                  f"the wrapper took C={C} x {x_dtype}, w {w_dtype}, d={d} (grad {grad}) "
                  f"instead of raising {error}")

    gen = torch.Generator(device="cuda").manual_seed(10)
    rows = {"fp32": [], "bf16": []}
    for C, T, dilations in UNIT_SHAPES:
        x = torch.randn(TRAIN_BATCH, C, T, device="cuda", generator=gen)
        w1, w2 = unit_weights(C, gen, torch.float32)
        g = torch.randn(TRAIN_BATCH, C, T, device="cuda", generator=gen)
        for dtype, name in ((f32, "fp32"), (b16, "bf16")):
            leaves = [t.detach().to(dtype).requires_grad_() for t in (x, w1, w2)]
            leaves32 = [t.detach().float().requires_grad_() for t in leaves]
            g_d = g.to(dtype)
            for d in dilations:
                left, right = get_padding(3, 1, d, "centered")

                def fwd_bwd(fn, inputs=leaves, grad=g_d):
                    y = fn(*inputs, d, left, right)
                    return (y, *torch.autograd.grad(y, inputs, grad))

                got = fwd_bwd(fused_dilated_unit)
                want = fwd_bwd(fused_dilated_unit_reference)
                torch.cuda.synchronize()
                check(all(bool(torch.isfinite(a).all()) and a.dtype == dtype for a in got),
                      f"{name} grad not finite or not {dtype} at {C, T, d}")
                keys = ("y", "dx", "dw1", "dw2")
                errs = {k: rel_err(a.detach(), b.detach()) for k, a, b in zip(keys, got, want)}
                row = {"C": C, "T": T, "d": d, **{f"{k}_rel_err": v for k, v in errs.items()}}
                if name == "fp32":
                    check(max(errs.values()) <= KERNEL_TOL,
                          f"autograd.Function vs plain at C={C} T={T} d={d}: {errs} > {KERNEL_TOL}")
                else:  # the referee: plain fp32 autograd on the same bf16 numbers
                    ref = fwd_bwd(fused_dilated_unit_reference, leaves32, g_d.float())
                    for k, a, b, r in zip(keys, got, want, ref):
                        e_f, e_p = rel_err(a.detach(), r.detach()), rel_err(b.detach(), r.detach())
                        row[f"{k}_rel_err_fp32"], row[f"{k}_plain_rel_err_fp32"] = e_f, e_p
                        check(e_f <= BF16_MARGIN * e_p and errs[k] <= BF16_TOL,
                              f"bf16 Function {k} at C={C} T={T} d={d}: {e_f:.3e} from the "
                              f"fp32 referee (plain bf16 {e_p:.3e}), {errs[k]:.3e} from plain")
                row["fwd_bwd_ms"] = cuda_ms(lambda: fwd_bwd(fused_dilated_unit), 10)
                row["plain_fwd_bwd_ms"] = cuda_ms(lambda: fwd_bwd(fused_dilated_unit_reference), 10)
                rows[name].append(row)
    for name, rs in rows.items():
        worst = max(max(r[f"{k}_rel_err"] for k in ("y", "dx", "dw1", "dw2")) for r in rs)
        summary = "; ".join(f"{r['C']}x{r['T']} d{r['d']} {r['fwd_bwd_ms']:.3f}/"
                            f"{r['plain_fwd_bwd_ms']:.3f}" for r in rs)
        print(f"grad {name}: {len(refusals)} refusals raised with and without autograd; "
              f"{len(rs)} shapes, B={TRAIN_BATCH}, y/dx/dw1/dw2 max rel err from plain "
              f"{worst:.2e}; fwd+bwd ms Function/plain: {summary}", flush=True)
    return rows


def _grad_errors(grads, ref) -> dict:
    """Per tensor: max abs difference over the reference's max (or 1e-4 where
    that is smaller: the hinge loss's last-bias gradients cancel to zero)."""
    return {n: rel_err(grads[n], ref[n].to(grads[n].dtype), floor=1e-4) for n in ref}


def _grad_distance(grads, ref) -> float:
    """Global relative L2 distance over every tensor: |g - ref| / |ref|."""
    num = sum(float((grads[n].double() - ref[n].double()).square().sum()) for n in ref)
    den = sum(float(ref[n].double().square().sum()) for n in ref)
    return math.sqrt(num / den)


def _train_run(cfg, crop, x, bf16: bool) -> dict:
    """5 pre-warmup generator steps, then 4 * update_discriminator_every
    steps picked by pick_phase past the warmup, from seed 0, on the card:
    the kernel launches of each step (22 of the expected variant, none of the
    other), finite losses, moved params, the global step; ms per step per
    phase (mean after the first) and the peak memory."""
    import torch

    from rave_tpu_torch.ops.kernels import dilated_unit
    from rave_tpu_torch.train.state import create_train_state
    from rave_tpu_torch.train.steps import build_train_steps, pick_phase

    t = cfg.train
    steps = build_train_steps(cfg, crop)
    state = create_train_state(cfg, seed=0, device="cuda")
    noise = torch.Generator(device="cuda").manual_seed(7)
    snapshot = lambda m: [p.detach().clone() for p in m.parameters()]  # noqa: E731
    moved = lambda m, before: sum(not torch.equal(p, q)  # noqa: E731
                                  for p, q in zip(m.parameters(), before))
    gen0, dis0 = snapshot(state.model), snapshot(state.discriminator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = {"gen_prewarmup": [], "gen_adversarial": [], "dis": []}
    last, launches = {}, 0
    kind = "bf16" if bf16 else "fp32"

    def one_step(which: str, warmed: bool) -> None:
        nonlocal launches
        step = state.step
        torch.cuda.synchronize()
        dilated_unit.launches = dilated_unit.launches_bf16 = 0
        t1 = time.perf_counter()
        if which == "dis":
            m = steps["dis"](state, x, generator=noise)
        else:
            m = steps["gen"](state, x, warmed, generator=noise)
        torch.cuda.synchronize()
        name = "dis" if which == "dis" else ("gen_adversarial" if warmed else "gen_prewarmup")
        times[name].append(time.perf_counter() - t1)
        n_bf16 = dilated_unit.launches_bf16
        n_kind = n_bf16 if bf16 else dilated_unit.launches - n_bf16
        check(n_kind == 22 and dilated_unit.launches == 22,
              f"{dilated_unit.launches} kernel launches ({n_bf16} bf16) in a {kind} {name} "
              f"step, expected 22 {kind}")
        launches += n_kind
        check(state.step == step + 1, f"global step {state.step} after step {step}")
        bad = [k for k, v in m.items() if not math.isfinite(float(v))]
        check(not bad, f"{kind} {name} step: non-finite {bad}")
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
    check(all(p.dtype == torch.float32 for p in state.model.parameters()), "masters not fp32")
    return {"ms_per_step": {k: statistics.mean(v[1:]) * 1e3 for k, v in times.items()},
            "steps": {k: len(v) for k, v in times.items()}, "launches_per_step": 22,
            "launches": launches, "peak_gb": torch.cuda.max_memory_allocated() / 2**30,
            "last_metrics": last}


def _step_once(cfg, crop, which: str, x, eps, device="cuda", dtype=None):
    """One pre-warmup generator step ("gen") or critic step ("dis") of `cfg`
    from the seed-0 state: (metrics, {name: gradient on the CPU})."""
    from rave_tpu_torch.train.state import create_train_state, make_optimizers
    from rave_tpu_torch.train.steps import build_train_steps

    steps = build_train_steps(cfg, crop)
    st = create_train_state(cfg, seed=0, device=device)
    if dtype is not None:
        st.model.to(dtype)
        st.discriminator.to(dtype)
        st.gen_opt, st.dis_opt = make_optimizers(cfg, st.model, st.discriminator)
    if which == "dis":
        st.step = cfg.train.phase_1_duration
    x, eps = x.to(device, dtype or x.dtype), eps.to(device, dtype or eps.dtype)
    m = steps["gen"](st, x, False, eps=eps) if which == "gen" else steps["dis"](st, x, eps=eps)
    module = st.model if which == "gen" else st.discriminator
    return ({k: float(v) for k, v in m.items()},
            {n: p.grad.cpu() for n, p in module.named_parameters()})


def _b1_inputs(cfg):
    import torch

    N = cfg.data.n_signal
    xb = torch.randn(1, 1, N, generator=torch.Generator().manual_seed(8)) * 0.1
    eb = torch.randn(1, cfg.latent_size, N // cfg.decimation(),
                     generator=torch.Generator().manual_seed(9))
    return xb, eb


def phase_train() -> dict:
    import torch

    from rave_tpu_torch.config import compose
    from rave_tpu_torch.ops.kernels import dilated_unit
    from rave_tpu_torch.train.analysis import crop_frames, receptive_field

    cfg = compose(["v2"])
    B, N = cfg.data.batch, cfg.data.n_signal
    t0 = time.perf_counter()
    rf = receptive_field(cfg, device="cuda")
    crop = crop_frames(cfg, rf)
    probe_s = time.perf_counter() - t0
    x = torch.randn(B, 1, N, device="cuda", generator=torch.Generator(device="cuda").manual_seed(6))
    x = x * 0.1
    dilated_unit.launches = dilated_unit.launches_bf16 = 0
    run = _train_run(cfg, crop, x, bf16=False)

    # the same seeded weights at B=1: GPU (kernel) against CPU (plain), and a
    # float64 CPU run as the referee of both float32 gradients
    xb, eb = _b1_inputs(cfg)
    compare = {}
    for which in ("gen", "dis"):
        (m_gpu, g_gpu), (m_cpu, g_cpu), (_, g_64) = (
            _step_once(cfg, crop, which, xb, eb, device, dtype)
            for device, dtype in (("cuda", torch.float32), ("cpu", torch.float32),
                                  ("cpu", torch.float64)))
        loss_err = max(abs(m_gpu[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-2) for k in m_cpu)
        gpu_vs_64, cpu_vs_64 = _grad_errors(g_gpu, g_64), _grad_errors(g_cpu, g_64)
        gpu_vs_cpu = _grad_errors(g_gpu, g_cpu)
        bound = max(GRAD_FLOOR, 2 * max(cpu_vs_64.values()))
        compare[which] = {"loss_rel_err": loss_err, "grad_gpu_vs_cpu": max(gpu_vs_cpu.values()),
                          "grad_gpu_vs_f64": max(gpu_vs_64.values()),
                          "grad_cpu_vs_f64": max(cpu_vs_64.values()), "grad_bound": bound,
                          "grad_gpu_vs_f64_median": statistics.median(gpu_vs_64.values()),
                          "grad_cpu_vs_f64_median": statistics.median(cpu_vs_64.values()),
                          "grad_gpu_vs_f64_global": _grad_distance(g_gpu, g_64)}
    out = {"rf": list(rf), "crop_frames": list(crop), "probe_s": probe_s, "batch": B,
           "n_signal": N, **run, "gpu_vs_cpu": compare}
    print(f"train: v2 B={B} x {N}, rf {rf} samples -> crop {crop} band frames (probe "
          f"{probe_s:.1f} s); ms per step (mean after one warm step): "
          + ", ".join(f"{k} {v:.1f} (x{run['steps'][k] - 1})" for k, v in run["ms_per_step"].items())
          + f"; 22 kernel launches per step, {run['launches']} in all; peak "
          + f"{run['peak_gb']:.2f} GiB; "
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


def _is_loss(name: str) -> bool:
    return name.startswith(("loss_", "multiband_", "fullband_", "regularization",
                            "feature_matching", "adversarial"))


def phase_train_bf16(crop) -> dict:
    import torch

    from rave_tpu_torch.config import compose
    from rave_tpu_torch.ops.kernels import dilated_unit

    flags = ["train.bf16=true", "train.bf16_dis=true"]
    cfg = compose(["v2"], flags)
    B, N = cfg.data.batch, cfg.data.n_signal
    x = torch.randn(B, 1, N, device="cuda", generator=torch.Generator(device="cuda").manual_seed(6))
    x = x * 0.1
    dilated_unit.launches = dilated_unit.launches_bf16 = 0
    run = _train_run(cfg, crop, x, bf16=True)

    # B=1 from the same seeded weights: bf16 against fp32, both on the card
    xb, eb = _b1_inputs(cfg)
    compare = {}
    for key, which, extra in (("gen", "gen", []), ("gen_eps1e-3", "gen", ["distance.log_epsilon=1e-3"]),
                              ("dis", "dis", [])):
        m32, g32 = _step_once(compose(["v2"], extra), crop, which, xb, eb)
        m16, g16 = _step_once(compose(["v2"], flags + extra), crop, which, xb, eb)
        check(all(g.dtype == torch.float32 and bool(torch.isfinite(g).all())
                  for g in g16.values()), f"bf16 {key} step: gradients not fp32 or not finite")
        losses = {k: abs(m16[k] - v) / max(abs(v), 1e-2) for k, v in m32.items() if _is_loss(k)}
        compare[key] = {"loss_rel_err": max(losses.values()), "worst_loss": max(losses, key=losses.get),
                        "grad_distance": _grad_distance(g16, g32),
                        "grad_bound": GRAD_BF16_BOUND[key],
                        "grad_max_rel": max(_grad_errors(g16, g32).values())}
    out = {"batch": B, "n_signal": N, **run, "bf16_vs_fp32": compare}
    print(f"train_bf16: v2 + {' '.join(flags)}, B={B} x {N}; ms per step (mean after one warm "
          f"step): " + ", ".join(f"{k} {v:.1f} (x{run['steps'][k] - 1})"
                                 for k, v in run["ms_per_step"].items())
          + f"; 22 bf16 launches and no fp32 per step, {run['launches']} in all; peak "
          + f"{run['peak_gb']:.2f} GiB; B=1 bf16 vs fp32: "
          + "; ".join(f"{k}: losses {c['loss_rel_err']:.2e} ({c['worst_loss']}) <= "
                      f"{BF16_LOSS_TOL}, grad distance {c['grad_distance']:.3e} <= "
                      f"{c['grad_bound']:g}" for k, c in compare.items()), flush=True)
    for k, c in compare.items():
        check(c["loss_rel_err"] <= BF16_LOSS_TOL,
              f"bf16 {k} step: losses {c['loss_rel_err']:.3e} from fp32 ({c['worst_loss']})")
        check(c["grad_distance"] <= c["grad_bound"],
              f"bf16 {k} step: gradients {c['grad_distance']:.3e} from fp32, bound {c['grad_bound']}")
    return out


def phase_remat(crop) -> dict:
    import torch

    from rave_tpu_torch.config import compose
    from rave_tpu_torch.ops.kernels import dilated_unit
    from rave_tpu_torch.train.state import create_train_state
    from rave_tpu_torch.train.steps import build_train_steps, draw_noise

    runs = {}
    torch.backends.cudnn.deterministic = True
    for name, remat in (("warm", False), ("plain", False), ("remat", True), ("plain_again", False)):
        cfg = compose(["v2"], [f"train.remat={str(remat).lower()}"])
        x = torch.randn(cfg.data.batch, 1, cfg.data.n_signal, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(6)) * 0.1
        eps = draw_noise(cfg, x, torch.Generator(device="cuda").manual_seed(7))
        state = create_train_state(cfg, seed=0, device="cuda")
        step = build_train_steps(cfg, crop)["gen"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        dilated_unit.launches = dilated_unit.launches_bf16 = 0
        t0 = time.perf_counter()
        m = step(state, x, False, eps=eps)
        torch.cuda.synchronize()
        runs[name] = {"ms": (time.perf_counter() - t0) * 1e3, "launches": dilated_unit.launches,
                      "peak_gb": (torch.cuda.max_memory_allocated() - base) / 2**30,
                      "metrics": {k: float(v) for k, v in m.items()},
                      "grads": {n: p.grad.detach().clone() for n, p in state.model.named_parameters()}}
        del state, step, m
    torch.backends.cudnn.deterministic = False
    del runs["warm"]  # cuDNN's and the allocator's first-call costs
    plain, remat, again = runs["plain"], runs["remat"], runs["plain_again"]

    def loss_err(a, b):
        return max(abs(a["metrics"][k] - v) / max(abs(v), 1e-2) for k, v in b["metrics"].items())

    out = {"loss_rel_err": loss_err(remat, plain),
           "grad_distance": _grad_distance(remat["grads"], plain["grads"]),
           "plain_again_loss_rel_err": loss_err(again, plain),
           "plain_again_grad_distance": _grad_distance(again["grads"], plain["grads"]),
           **{f"{k}_{f}": r[f] for k, r in runs.items() for f in ("ms", "launches", "peak_gb")}}
    print(f"remat: v2 fp32 pre-warmup step, B={TRAIN_BATCH} x {N_SIGNAL}: with remat vs "
          f"without, losses {out['loss_rel_err']:.2e} <= {REMAT_LOSS_TOL}, gradients "
          f"{out['grad_distance']:.2e} <= {REMAT_GRAD_TOL} (without vs without: "
          f"{out['plain_again_loss_rel_err']:.2e}, {out['plain_again_grad_distance']:.2e}); "
          f"launches {remat['launches']} vs {plain['launches']}; peak above the state "
          f"{remat['peak_gb']:.2f} vs {plain['peak_gb']:.2f} GiB; {remat['ms']:.1f} vs "
          f"{plain['ms']:.1f} ms (one step each)", flush=True)
    check(plain["launches"] == 22 and remat["launches"] == 44,
          f"launches {plain['launches']} without remat (22), {remat['launches']} with (44)")
    check(out["loss_rel_err"] <= REMAT_LOSS_TOL, f"remat losses {out['loss_rel_err']:.3e} apart")
    check(out["grad_distance"] <= REMAT_GRAD_TOL, f"remat gradients {out['grad_distance']:.3e} apart")
    check(remat["peak_gb"] < plain["peak_gb"], "remat did not lower the peak memory")
    return out


def write_corpus(folder: Path, seed: int = 11) -> None:
    """LOOP_FILES seeded .wav files of tones, chirps, noise and their mix,
    LOOP_RECORDS records of N_SIGNAL samples in all."""
    import numpy as np
    from scipy.io import wavfile

    folder.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    n = LOOP_RECORDS // LOOP_FILES * N_SIGNAL
    t = np.arange(n) / SAMPLE_RATE
    f0 = rng.uniform(80, 800, size=3)
    tone = sum(0.2 * np.sin(2 * np.pi * f * (1 + k) * t) / (1 + k) for k, f in enumerate(f0))
    chirp = 0.4 * np.sin(2 * np.pi * (60 + 40 * t) * t)
    noise = 0.15 * rng.standard_normal(n)
    for name, x in (("tones", tone), ("chirp", chirp), ("noise", noise),
                    ("mix", 0.5 * (tone + chirp) + 0.5 * noise)):
        wavfile.write(folder / f"{name}.wav", SAMPLE_RATE,
                      (np.clip(x, -1, 1) * 32767).astype(np.int16))


class LoopProbe:
    """Observes the training driver in process: its receptive-field probe,
    each step, validation, checkpoint save and restore end in a synchronize
    and record their wall time and their kernel launches of each variant; a
    restore also keeps a host copy of the state it restored. The launch
    counts are read, never reset, so the phase's totals stay those of the
    main path."""

    NAMES = ("receptive_field", "build_train_steps", "run_validation", "save_checkpoint",
             "restore_checkpoint")

    def __init__(self):
        from rave_tpu_torch.train import loop

        self.loop, self.events, self.keep_x_at = loop, [], None
        self.saved = {name: getattr(loop, name) for name in self.NAMES}

    def __enter__(self):
        loop = self.loop
        loop.receptive_field = self.observe("receptive_field", self.saved["receptive_field"])
        loop.run_validation = self.observe("validation", self.saved["run_validation"])
        loop.save_checkpoint = self.observe("save", self.saved["save_checkpoint"])
        loop.restore_checkpoint = self.observe("restore", self.saved["restore_checkpoint"])
        loop.build_train_steps = lambda *a, **k: {
            which: self.observe("step", fn, which)
            for which, fn in self.saved["build_train_steps"](*a, **k).items()}
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.loop, name, fn)

    @staticmethod
    def counts():
        from rave_tpu_torch.ops.kernels import dilated_unit

        return dilated_unit.launches - dilated_unit.launches_bf16, dilated_unit.launches_bf16

    def observe(self, kind: str, fn, which: str = ""):
        import torch

        def call(*args, **kwargs):
            torch.cuda.synchronize()
            (fp32, bf16), t0 = self.counts(), time.perf_counter()
            step = args[0].step if kind == "step" else None
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            after = self.counts()
            event = {"kind": kind, "start": t0, "end": t1, "ms": (t1 - t0) * 1e3,
                     "fp32": after[0] - fp32, "bf16": after[1] - bf16}
            if kind == "step":
                event["step"] = step
                event["phase"] = ("dis" if which == "dis" else
                                  "gen_adversarial" if args[2] else "gen_prewarmup")
                event["finite"] = all(math.isfinite(float(v)) for v in out.values())
                if step == self.keep_x_at:
                    event["x"] = args[1].clone()
            elif kind == "validation":
                event["batches"] = len(args[2])
                event["value"] = out[0]
            elif kind == "save":
                event["step"], event["mb"] = args[1].step, out.stat().st_size / 2**20
            elif kind == "restore" and out is not None:
                st = args[1]
                event["path"], event["state"] = out, host_copy({
                    "step": st.step, "model": st.model.state_dict(),
                    "discriminator": st.discriminator.state_dict(),
                    "gen_opt": st.gen_opt.state_dict(), "dis_opt": st.dis_opt.state_dict(),
                    "ema": st.ema})
            self.events.append(event)
            return out

        return call

    def take(self) -> list:
        events, self.events = self.events, []
        return events


def loop_ms(events) -> dict:
    """Mean loop ms per step by phase: from the end of one step to the end of
    the next (the loop's own work, data and logging included), over steps
    that follow a step of the same run with no validation or save between,
    after each phase's first step; and the bare step calls' mean over the same
    steps."""
    loop_times, bare, seen = {}, {}, set()
    for prev, ev in zip(events, events[1:]):
        if ev["kind"] != "step":
            continue
        if ev["phase"] not in seen:
            seen.add(ev["phase"])
            continue
        if prev["kind"] == "step":
            loop_times.setdefault(ev["phase"], []).append((ev["end"] - prev["end"]) * 1e3)
            bare.setdefault(ev["phase"], []).append(ev["ms"])
    return {k: {"loop_ms": statistics.mean(v), "step_ms": statistics.mean(bare[k]), "n": len(v)}
            for k, v in loop_times.items()}


def host_copy(tree):
    """A copy of a nest of dicts, lists and tensors, its tensors cloned to the host."""
    import torch

    if isinstance(tree, dict):
        return {k: host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_copy(v) for v in tree)
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    return tree


def unequal(a, b, path: str = "") -> list:
    """Paths where two nests of dicts, lists and tensors differ in any bit."""
    import torch

    if isinstance(a, dict):
        if a.keys() != b.keys():
            return [f"{path} keys"]
        return [p for k in a for p in unequal(a[k], b[k], f"{path}.{k}")]
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return [f"{path} length"]
        return [p for i, (x, y) in enumerate(zip(a, b)) for p in unequal(x, y, f"{path}[{i}]")]
    if torch.is_tensor(a):
        return [] if a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu()) else [path]
    return [] if a == b else [path]


def _cli(args) -> str:
    """Run a command of the port's CLI in this process; its standard output."""
    from rave_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = cli.main([str(a) for a in args])
    check(code == 0, f"cli {args[0]} exited {code}: {out.getvalue()[-2000:]}")
    return out.getvalue()


def _check_steps(events, kind: str, first: int, last: int) -> None:
    steps = [e for e in events if e["kind"] == "step"]
    check([e["step"] for e in steps] == list(range(first, last)),
          f"{kind} run took steps {[e['step'] for e in steps]}, expected {first}..{last - 1}")
    other = "fp32" if kind == "bf16" else "bf16"
    for e in steps:
        check(e[kind] == 22 and e[other] == 0, f"{kind} run, step {e['step']} ({e['phase']}): "
              f"{e['fp32']} fp32 and {e['bf16']} bf16 launches, expected 22 {kind}")
        check(e["finite"], f"{kind} run, step {e['step']}: non-finite metrics")
    for e in events:
        if e["kind"] == "validation":
            check(e["fp32"] == 22 * e["batches"] and e["bf16"] == 0,
                  f"validation over {e['batches']} batches: {e['fp32']} fp32 / {e['bf16']} bf16 "
                  "launches")
            check(math.isfinite(e["value"]), f"validation value {e['value']}")
        if e["kind"] == "receptive_field":
            check(e["fp32"] > 0 and e["fp32"] % 22 == 0 and e["bf16"] == 0,
                  f"receptive-field probe: {e['fp32']} fp32, {e['bf16']} bf16 launches")


def phase_loop(train_ms: dict, train_bf16_ms: dict) -> dict:
    import torch

    from rave_tpu_torch import config as config_lib
    from rave_tpu_torch.data.dataset import get_dataset, split_dataset
    from rave_tpu_torch.data.device_data import DeviceDataPipeline
    from rave_tpu_torch.ops.kernels import dilated_unit
    from rave_tpu_torch.train.loop import device_batches
    from rave_tpu_torch.utils import checkpoint

    work = ROOT / "build" / "loop"
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    write_corpus(work / "corpus")
    db, runs = work / "db", work / "runs"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dilated_unit.launches = dilated_unit.launches_bf16 = 0
    _cli(["preprocess", "--input_path", work / "corpus", "--output_path", db,
          "--num_signal", N_SIGNAL, "--sampling_rate", SAMPLE_RATE])
    common = ["--config", "v2", "--db_path", db, "--out_path", runs, "--batch", TRAIN_BATCH,
              "--n_signal", N_SIGNAL, "--device", "cuda"]
    for o in LOOP_SCHEDULE:
        common += ["--override", o]
    with LoopProbe() as probe:
        # fp32 with the device-resident dataset, then a resume with more steps
        out = _cli(["train", "--name", "loop", "--max_steps", LOOP_STEPS, "--val_every",
                    LOOP_VAL_EVERY, "--save_every", LOOP_SAVE_EVERY, "--device_data", "on",
                    *common])
        run_dir = Path(out.strip().splitlines()[-1].removeprefix("run dir: "))
        first = probe.take()
        probe.keep_x_at = LOOP_STEPS
        out2 = _cli(["train", "--name", "loop", "--max_steps", LOOP_RESUME_STEPS, "--val_every",
                     LOOP_VAL_EVERY, "--save_every", LOOP_SAVE_EVERY, "--device_data", "on",
                     *common])
        resumed = probe.take()
        probe.keep_x_at = None
        # bf16 through the host loader and the pinned, non-blocking prefetch
        out3 = _cli(["train", "--name", "loop_bf16", "--bf16", "--max_steps", LOOP_BF16_STEPS,
                     "--val_every", 1000, "--save_every", 1000, "--device_data", "off",
                     "--no_resume", *common, "--override",
                     f"train.phase_1_duration={LOOP_BF16_WARMUP}"])
        run_bf16 = Path(out3.strip().splitlines()[-1].removeprefix("run dir: "))
        bf16_events = probe.take()
    evals = []
    for ema in (False, False, True):
        before = LoopProbe.counts()
        ev = json.loads(_cli(["eval", "--run", run_dir, "--db_path", db, "--split", "val",
                              "--device", "cuda", *(["--ema_weights"] if ema else [])]
                             ).strip().splitlines()[-1])
        ev["fp32"], ev["bf16"] = (a - b for a, b in zip(LoopProbe.counts(), before))
        evals.append(ev)
    torch.cuda.synchronize()
    launches = {"fp32": dilated_unit.launches - dilated_unit.launches_bf16,
                "bf16": dilated_unit.launches_bf16}
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    # the runs: launches, steps, files, checkpoints, PCA
    _check_steps(first, "fp32", 0, LOOP_STEPS)
    _check_steps(resumed, "fp32", LOOP_STEPS, LOOP_RESUME_STEPS)
    _check_steps(bf16_events, "bf16", 0, LOOP_BF16_STEPS)
    check("native (C++) input pipeline is not ported" in out3, "bf16 run did not use the Loader")
    check([checkpoint.checkpoint_step(p) for p in checkpoint.list_checkpoints(str(run_bf16))]
          == [LOOP_BF16_STEPS], "the bf16 run's final checkpoint")
    check(f"resumed at step {LOOP_STEPS}" in out2, "the second run did not resume")
    for events in (first, bf16_events):
        phases = {e["phase"] for e in events if e["kind"] == "step"}
        check(phases == {"gen_prewarmup", "gen_adversarial", "dis"}, f"phases run: {phases}")
    cfg = config_lib.from_dict(json.loads((run_dir / "config.json").read_text()))
    warmup = cfg.train.phase_1_duration
    check(sum(e["kind"] == "validation" for e in first) == 2, "validations of the first run")
    vals = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    check([r["step"] for r in vals if "validation" in r]
          == [LOOP_VAL_EVERY, LOOP_STEPS, LOOP_RESUME_STEPS], f"validation rows {vals}")
    check({r["step"] for r in vals if "loss_gen" in r} >= {1, 2}, "no loss rows at steps 1, 2")
    check(all(math.isfinite(v) for r in vals for v in r.values()), "non-finite metrics row")
    check((run_dir / "status.json").is_file(), "no status.json")
    ckpts = [checkpoint.checkpoint_step(p) for p in checkpoint.list_checkpoints(str(run_dir))]
    check(ckpts == [LOOP_VAL_EVERY, LOOP_SAVE_EVERY, LOOP_STEPS, LOOP_RESUME_STEPS],
          f"checkpoints at {ckpts}")
    ckpt_pre = torch.load(checkpoint.latest_checkpoint(str(run_dir), LOOP_VAL_EVERY),
                          map_location="cpu", weights_only=True)["model"]
    check(LOOP_VAL_EVERY <= warmup and bool(ckpt_pre["fidelity"].gt(0).all())
          and not torch.equal(ckpt_pre["latent_pca"], torch.eye(cfg.latent_size)),
          "the pre-warmup validation left the PCA buffers unset")
    final = torch.load(checkpoint.latest_checkpoint(str(run_dir)), map_location="cpu",
                       weights_only=True)
    check(all(torch.equal(final["model"][k], ckpt_pre[k])
              for k in ("latent_pca", "latent_mean", "fidelity")),
          "the PCA buffers moved after the warmup")

    # resume: the state the second run restored, EMA included, bit-equal to its
    # checkpoint; the schedule continued
    restores = [e for e in first + resumed if e["kind"] == "restore" and "state" in e]
    check(len(restores) == 1 and restores[0] in resumed
          and checkpoint.checkpoint_step(restores[0]["path"]) == LOOP_STEPS,
          f"restores: {[(e['path'], e in resumed) for e in restores]}")
    restored = restores[0]["state"]
    saved = torch.load(restores[0]["path"], map_location="cpu", weights_only=True)
    bad = unequal(restored, saved)
    check(not bad and restored["step"] == LOOP_STEPS and restored["ema"] is not None,
          f"restore not bit-equal: {bad[:5]}")
    dataset = get_dataset(str(db), cfg.sampling_rate, N_SIGNAL)
    train_idx, _ = split_dataset(dataset)
    pipeline = DeviceDataPipeline(str(db), train_idx, TRAIN_BATCH, N_SIGNAL, SAMPLE_RATE,
                                  device="cuda")
    unbroken = device_batches(pipeline, 0)
    for _ in range(LOOP_STEPS + 1):  # the batches of steps 0 .. LOOP_STEPS
        x_unbroken = next(unbroken)
    x_resumed = next(e["x"] for e in resumed if e.get("x") is not None)
    check(torch.equal(x_resumed, x_unbroken),
          f"the resumed run's batch at step {LOOP_STEPS} is not the unbroken pipeline's")
    batch_ms = cuda_ms(lambda: pipeline.batch_at(LOOP_STEPS), 20)

    # eval: finite, repeatable, 22 fp32 launches per batch
    for k in EVAL_METRICS:
        check(all(math.isfinite(ev[k]) for ev in evals), f"eval {k} not finite")
    check(evals[0] == evals[1], f"eval differs between calls: {evals[:2]}")
    check(evals[2]["ema"] and evals[2]["spectral_distance"] != evals[0]["spectral_distance"],
          f"eval --ema_weights: {evals[2]}")
    for ev in evals:
        check(ev["n_clips"] == LOOP_VAL_BATCH, f"eval over {ev['n_clips']} clips")
        check(ev["fp32"] == 22 * ev["n_batches"] and ev["bf16"] == 0,
              f"eval launches {ev['fp32']} fp32, {ev['bf16']} bf16")
    accounted = sum(e["fp32"] for e in first + resumed + bf16_events) + sum(
        ev["fp32"] for ev in evals)
    check(launches["fp32"] == accounted and
          launches["bf16"] == sum(e["bf16"] for e in bf16_events),
          f"launches {launches} not all in the probe, the steps, validation and eval")

    saves = [e for e in first + resumed + bf16_events if e["kind"] == "save"]
    timing = {"fp32": loop_ms(first + resumed), "bf16": loop_ms(bf16_events)}
    out = {"records": LOOP_RECORDS, "run_dir": str(run_dir.relative_to(ROOT)),
           "checkpoints": ckpts, "launches": launches, "peak_gb": peak_gb,
           "loop_ms": timing, "bare_step_ms": {"fp32": train_ms, "bf16": train_bf16_ms},
           "device_batch_ms": batch_ms, "save_s": [e["ms"] / 1e3 for e in saves],
           "checkpoint_mb": [e["mb"] for e in saves], "eval": evals[0],
           "eval_ema": evals[2],
           "validation_ms": [e["ms"] for e in first + resumed if e["kind"] == "validation"],
           "probe_ms": [e["ms"] for e in first + resumed + bf16_events
                        if e["kind"] == "receptive_field"],
           "validation": [r["validation"] for r in vals if "validation" in r],
           "seconds": time.perf_counter() - t0}
    summary = "; ".join(f"{kind} {ph} {v['loop_ms']:.1f} (step {v['step_ms']:.1f}, x{v['n']}; "
                        f"phase train {out['bare_step_ms'][kind].get(ph, float('nan')):.1f})"
                        for kind, t in timing.items() for ph, v in sorted(t.items()))
    print(f"loop: cli preprocess {LOOP_RECORDS} records -> train v2 B={TRAIN_BATCH} x {N_SIGNAL} "
          f"steps 0..{LOOP_STEPS - 1} (device data), resumed to {LOOP_RESUME_STEPS}, bf16 "
          f"{LOOP_BF16_STEPS} steps (host loader) -> eval x2; 22 launches per step and per "
          f"validation/eval batch, {launches['fp32']} fp32 + {launches['bf16']} bf16 in all; "
          f"checkpoints {ckpts}; restore bit-equal (EMA included); validation {out['validation']}; eval "
          + ", ".join(f"{k} {evals[0][k]}" for k in EVAL_METRICS)
          + "; with --ema_weights " + ", ".join(f"{k} {evals[2][k]}" for k in EVAL_METRICS),
          flush=True)
    print(f"loop times: ms per step, loop (bare step call; phase train's bare step): {summary}; "
          f"device-data batch {batch_ms:.3f} ms (device); checkpoint save "
          f"{', '.join(f'{s:.2f}' for s in out['save_s'])} s of "
          f"{', '.join(f'{mb:.1f}' for mb in out['checkpoint_mb'])} MiB; validation "
          f"{', '.join(f'{ms:.1f}' for ms in out['validation_ms'])} ms; receptive-field probe "
          f"{', '.join(f'{ms:.0f}' for ms in out['probe_ms'])} ms; "
          f"peak {peak_gb:.2f} GiB; phase {out['seconds']:.1f} s", flush=True)
    shutil.rmtree(runs, ignore_errors=True)  # ~0.7 GB per checkpoint
    return out


def main() -> None:
    if not (ROOT / KERNEL_SOURCE).is_file():
        raise SystemExit(f"chip_smoke: {KERNEL_SOURCE} not found; run from a checkout")
    sys.path.insert(0, str(ROOT))
    import torch

    card = phase_device()
    build_info = phase_build()
    rows = phase_kernel()
    rows_bf16 = phase_kernel_bf16()
    offline = phase_offline()
    stream = phase_stream()
    grad = phase_grad()
    train = phase_train()
    train_bf16 = phase_train_bf16(tuple(train["crop_frames"]))
    remat = phase_remat(tuple(train["crop_frames"]))
    loop = phase_loop(train["ms_per_step"], train_bf16["ms_per_step"])
    foreign = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "rave_tpu"))
    check(not foreign, f"the port loaded the JAX package or jax: {foreign[:5]}")

    # one main-path call's 22 units: each centered shape in encoder and decoder
    main_rows = [r for r in rows if r["case"] == "main" and r["mode"] == "centered"] * 2
    main_bf16 = [r for r in rows_bf16 if r["case"] == "main" and r["mode"] == "centered"
                 and r["B"] == TRAIN_BATCH] * 2
    bound32, bound16 = unit_bound(main_rows, BATCH, "fp32"), unit_bound(main_bf16, TRAIN_BATCH, "bf16")
    bounds = {"fp32_b16_forward": bound32, "bf16_b8_forward": bound16,
              **{f"{k}_b8_fwd_bwd": unit_bound(grad[k] * 2, TRAIN_BATCH, k, backward=True)
                 for k in ("fp32", "bf16")}}
    print("bounds (22 units): " + "; ".join(f"{k} {b['bound_ms']:.3f} ms ({b['bound_by']})"
                                            for k, b in bounds.items()), flush=True)
    kernels = {"kernels": [{
        "name": "fused_dilated_unit", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": offline["launches"],
        "launches_train": train["launches"], "launches_remat_step": remat["remat_launches"],
        "launches_loop": loop["launches"]["fp32"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": sum(r["ms"] for r in main_rows), "plain_ms": sum(r["plain_ms"] for r in main_rows),
        "bound_ms": bound32["bound_ms"], "bound_by": bound32["bound_by"], "library_ms": None,
    }, {
        "name": "fused_dilated_unit_bf16", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": train_bf16["launches"],
        "launches_loop": loop["launches"]["bf16"],
        "max_abs_err": max(r["max_abs_err"] for r in rows_bf16),
        "ms": sum(r["ms"] for r in main_bf16), "plain_ms": sum(r["plain_ms"] for r in main_bf16),
        "bound_ms": bound16["bound_ms"], "bound_by": bound16["bound_by"], "library_ms": None,
    }]}
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "build": build_info, "kernel_shapes": rows, "kernel_bf16_shapes": rows_bf16,
         "bounds": bounds,
         "offline": offline, "stream": stream, "grad_shapes": grad, "train": train,
         "train_bf16": train_bf16, "remat": remat, "loop": loop, **kernels}, indent=1))
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
