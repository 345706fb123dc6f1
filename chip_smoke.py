#!/usr/bin/env python3
"""Drive rave_tpu_torch's serving paths and training steps once on one NVIDIA GPU.

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
               shapes at B=2 (phase 11's validation and eval batches); then
               the unit shapes of phase 18's forwards that v2's do not
               cover (`variant_unit_cases`: C = 48, 64, 128, 256, 512, whose
               output passes and, in bf16, input chunks are partial, up to
               C=64 at T=131072), centered at B=16, with a ragged length and
               B=1 at each new C; max relative error <= 1e-4; both times by
               CUDA events;
  4. kernel_bf16 : the bf16 variant at the 22 unit shapes of a B=8 step
               (centered and causal), the 11 centered ones at B=16, the
               ragged and B=1 shapes of phase 3, and the variants' shapes of
               phase 3 at B=8; the referee is the plain
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
               then v2_small and v2_nopqmf at full width with the same flags
               (`VARIANT_BF16`, without the valid-signal crop): 2 pre-warmup
               and 2 of each warmed program, their 22 bf16 launches per step,
               ms and peak, and at B=1 the pre-warmup step (log_epsilon 1e-3)
               and the critic step bf16 against fp32 under the same bounds;
               hybrid (mel input) with train.bf16 refused, as rave_tpu cannot
               take that step (ROADMAP C14);
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
 12. export  : phase 11's run through the port's command line: `export
               --streaming --ema_weights` and `export --stereo --sr 88200`
               (manifests: the latent size truncated from the run's
               fidelity buffer, ratios, latency, stream batch and rate, the
               step programs exported on the card; export seconds and MiB);
               `generate` of a seeded 30 s wav (ragged against the block):
               exactly 22 launches, the written wav within 1/32767 of
               `ExportedRAVE.forward` on the same input and seed; the
               artifact on the card against the same artifact on the CPU
               (plain unit) on a 3 s clip, offline and 8 streaming blocks,
               <= 1e-3; `forward_step.pt2` (`torch.export.load`) in lockstep
               with the eager streaming forward over 32 blocks, outputs and
               state <= 1e-5. Prints generate's realtime factor end to end
               and for the bare forward, the streaming p50 per block (eager
               and .pt2) against the block's budget, the peak memory, and the
               unit at the 30 s forward's 11 centered shapes at B=1 against
               its plain version (phase 3's machinery);
 13. prior   : the latent prior (run after phase 12, on phase 11's run and
               store), TF32 off: (a) the stock prior (prior_v1.gin: resolution
               32, res_size 512, skp_size 256, 10 layers) at latent_size 16
               (512 channels) at B=8 over the 128 latent frames of the 262144
               samples train_prior takes at v2's decimation: the forward on
               the card against the CPU (1e-3), 64 chained `step` calls
               against the offline logits (1e-4), one Adam step (ms, peak
               memory); (b) `cli train_prior --smoke_test --n_signal 524288`
               (2 steps, a decoded sample and a save after each; the loop's
               16-step run keeps most of its 128 dimensions, whose diagonal
               shift needs more than the default 128 frames): exactly 11 launches (one v2
               half) per `encode_latents` and per `decode_latents`, 44 in
               all, the latent size it chose; (c) `cli export --prior` (11
               launches: its smoke decode) and `cli generate --prior_seconds
               5` (11: one decode; the wav's length), `sample_prior(argmax=True)`
               on the card against the CPU (the card's chain fed to the CPU's
               prior gives the card's codes, float32 ties aside), `prior_step.pt2`
               bit-equal to the eager step over 32 steps, and the p50 of a
               prior step, eager and .pt2, under one latent frame's period
               (2048 / 44100 s = 46.44 ms: a live prior makes a frame per
               block); (d) the unit at every shape (b) and (c) gave it, as
               recorded there (the encoder's at B=8 x 524288 samples, the
               decoders' at B=1 over the validation sample's frames (128
               less the shift's D - 1), 8 and 108 latent frames), against
               its plain version (1e-4), one `encode_latents` batch of (b)
               and the decode of a prior sample on the card against the CPU
               (1e-3). Work in build/prior, deleted at its end;
 14. v1     : compose(["v1"]) at full width (capacity 64, latent 128, 16
               bands, ratios 4.4.4.2, BatchNorm, the noise synth on, the
               multiscale critic at capacity 64), TF32 off; v1 has no
               DilatedUnit, so every count of (a)-(d) is 0: (a) the forward
               at B=16 x 131072 in eval mode (BatchNorm on its running
               statistics), timed, and at B=1 x 65536 the card against the
               CPU (1e-3); (b) v1 causal streamed through step_encode and
               step_decode against the offline pass past the delays (1e-3);
               (c) one step of each program at B=8 x 131072 after a warm
               one (ms, peak memory), the first step of each at B=1 on the
               card against the CPU (losses and BatchNorm's running
               statistics 1e-4); (d) `cli train --config v1` on phase 11's
               store, resumed once (bit-equal, the running statistics
               included), `cli export --streaming`, `cli generate` of a 30 s
               file, the artifact on the card against the CPU (1e-3),
               `forward_step.pt2` bit-equal to the eager steps over 32
               blocks, the streaming p50, eager and .pt2, under the 46.44 ms
               budget; (e) `cli export_onnx --verify` of a 2-step `--config
               onnx` run (0 launches) and of phase 11's v2 run (its live
               forward's 22 launches exactly, the kernel held against its
               plain version at each shape they gave it, 1e-4), each
               verify within 1e-4. Work in build/v1, deleted at the end;
 15. spectral : compose(["v2", "spectral_discriminator"]) at full width (the
               multiscale critic beside EncodecConvNets on the complex STFTs at
               4096..256, capacity 32), TF32 off: at B=8 x 131072 a warm and
               a timed step of each program in fp32 and under `train.bf16` +
               `bf16_dis` (22 launches of the step's variant each, ms, peak
               memory), and one warm and one timed adversarial generator step
               of v2 with `distance.kind` `encodec`, `instantaneous` and
               `distance.num_mels=64` (22 each; 396 launches in all, 132 bf16);
               then the first step of each fp32 program and of each distance
               at B=1 x 65536 on the card against the CPU (every loss term
               within 1e-4, the instantaneous distance's phase terms too: the
               weighted form damps the near-silent bins whose phase cuFFT and
               the CPU could wrap apart), and the critic alone, forward and backward on the 16-row
               real+fake batch (device ms: whole, its multiscale and its
               spectral part; fp32 and bf16) beside its forward FLOP;
 16. import : a reference checkpoint at full width: v2's seeded weights (an
               orthogonal latent PCA, a mean, a fidelity curve) written under
               the reference's names as a `.ckpt` by tools/torch_reference_ckpt.py
               beside a `config.gin` that includes configs/v2.gin; `cli
               import_torch --config config.gin` (0 launches), `cli export
               --streaming` (11: its smoke decode) and `cli generate` of a 30 s
               file (22: one forward, at v2's B=1 shapes), counted from 0
               before the import; the imported model's encode-decode and its
               artifact's forward against the source weights' (the same
               weights saved as a port run and exported alike) within 1e-5
               (the weight norm re-decomposed in float32); the artifact's
               streaming p50 per 2048-sample block, eager and `.pt2`, under its
               46.44 ms; the unit against its plain version at each shape the
               path gave it (1e-4). Work in build/import, deleted at the end;
 17. discrete : compose(["discrete"]) at full width (capacity 96, latent 128,
               16 x 1024 codes, 128 noise channels, ratios 4.4.2.2), TF32
               off: the unit at the shapes only it reaches (C=768, T=256,
               d 1 and 3, at B=16 and B=8) against its plain version
               (1e-4); the forward at B=16 x 131072 (22 launches, timed) and
               at B=1 x 65536 the card against the CPU (encoder 1e-3; fed the
               card's latent, the CPU's quantizers pick the card's codes, float32
               ties aside: `check_codes`; the decode of one index tensor
               1e-3); at B=8 x
               131072 the k-means step timed alone, then pre-warmup,
               adversarial and critic steps (22 launches each, every
               program updating the codebooks), `codebook_health`, and the
               first step of each program at B=1 on the card against the
               CPU (losses 1e-3); `cli train --config discrete` on phase
               11's store resumed once (the restored state, codebooks and
               `inited` included, bit-equal to its checkpoint; health logged
               at each validation) and `cli eval`; `cli export --streaming`
               and `cli generate` of a 30 s file (22 launches), the artifact
               on the card against the CPU (latents 1e-3 and `check_codes`, the
               decode of one index tensor 1e-3), `forward_step.pt2` bit-equal to
               the eager steps over 32 blocks, the streaming p50 against
               the 1024-sample block's 23.22 ms; then v2 + wasserstein and
               v2 + spherical: one generator step each at B=8 x 131072 (22
               launches), the first step at B=1 and the artifact's codec
               halves (`EncodeSide`, `DecodeSide`) of the stepped model on
               the card against the CPU (1e-3); the phase aims at ~60 s;
 18. variants : v2_small (capacity 48, ratios 4.2.2.2, the noise synth with
               32 bands), v2_nopqmf (capacity 64, raw-waveform output,
               decoder ratios 8.8.8.4) and hybrid (mel input, hop 256,
               encoder ratios 2.2.2, a 2-layer GRU at the decoder's input)
               at full width, TF32 off, each: (a) the forward at B=16 x
               131072 with exactly 22, 22 and 14 launches, each unit's
               (C, T, dilation) as VARIANT_UNITS lists them, timed, and at
               B=1 x 65536 the card against the CPU (1e-3) on the same
               weights and draws (the variational eps, the noise synth's
               uniforms); (b) blocks of block_size() streamed through
               step_encode and step_decode against the offline encode and
               decode past the delays (1e-3; the noise synth's offline
               draws shifted by its lag), and the p50 of 32 streaming
               forward blocks against the block's budget; (c) the
               receptive-field crop, one step of each program at B=8 x
               131072 after a warm one (launches exact, ms, peak memory) and
               the first step of each at B=1 x 65536 on the card against the
               CPU (losses 1e-4); (d) `cli train --config <preset>` 3 steps
               (the three programs) on phase 11's store with the device
               dataset (v2_nopqmf's RandomCompress off for it), `cli export
               --streaming`, `cli generate` of a 30 s file (a forward's
               launches), the artifact on the card against the CPU (3 s clip
               offline, 8 streaming blocks; 1e-3) and `forward_step.pt2`
               against the eager steps over 32 blocks (1e-5), the streaming
               p50 eager and .pt2. hybrid trains without the valid-signal
               crop (ROADMAP C12). Work in build/variants, deleted at the end;
 19. v3     : compose(["v3"]) at full width (capacity 96, latent 128, ratios
               4.4.4.2, Snake, AdaIN before each residual unit, the descript
               critic with periods 2, 3, 5, 7, 11 and FFT sizes 2048, 1024,
               512), TF32 off. Its Snake units bypass the kernel, as the JAX
               package gates its Pallas kernel to leaky ReLU: every count of
               this phase is 0. (a) the forward at B=16 x 131072 in training
               mode and at B=8 in eval mode with learned AdaIN statistics
               (AdaIN holds 8 batch slots), timed; at B=1 x 65536 in eval
               mode the card against the CPU (1e-3), the transfer acting;
               (b) the receptive-field probe, then fp32 and `train.bf16` +
               `bf16_dis` steps of the three programs at B=8 x 131072 (ms per
               step, peak memory), the first step of each program at B=1 on
               the card against the CPU (losses 1e-3), and the critic alone,
               forward and backward on the 16-row real+fake batch, device ms
               split between its MPDs and MRDs; (c) `cli train --config v3` on
               phase 11's store resumed once (bit-equal, AdaIN included),
               AdaIN's calls recorded with the mode (training in the steps,
               eval in validation, eval and the probe), `cli eval` twice,
               equal; (d) `cli export --streaming`, `cli generate` of a 30 s
               file, the AdaIN attributes (learn a target, learn a source,
               transfer) on the card against the CPU call by call from the
               CPU's state (1e-3), then free-running from a fresh state on
               the card and on the CPU, each against its own fixed kernels in
               float64: the card's outputs with cuDNN off no further than 3x
               the CPU's, and the card as it serves (cuDNN) with no growth
               of the error over the 8 transfer blocks past the stream's
               reach (the receptive field's left side plus the delay, from
               the transfer's start: no block read sees the learning
               segments), later half against earlier half; the transfer
               moving the output, `forward_step.pt2` bit-equal to the eager
               steps over 32 blocks while the target learns (AdaIN's state
               included), the resets bringing the identity back, the
               streaming p50 under the 46.44 ms budget; (e) discrete_v3: the
               B=16 forward, the k-means step apart, one step of each program
               at B=8, B=1 losses card vs CPU (1e-3) and `check_codes`;
               work in build/v3, deleted at the end;
 20. the kernels' JSON line, then the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Per-shape details go to build/chip_smoke.json; the loop and export phases
work in build/loop (corpus, db, run dirs, artifacts, generated wavs), the
prior phase in build/prior, the v1 phase in build/v1, the import phase in
build/import, the discrete phase in build/discrete, the variants phase in
build/variants and the v3 phase in build/v3 (each deleted at its end).
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
# the export phase: generate's file, the card-vs-CPU clip and block counts
EXPORT_SECONDS, CLIP_SECONDS, GENERATE_SEED = 30.0, 3.0, 5
CPU_STREAM_BLOCKS, PROGRAM_BLOCKS, PROGRAM_TOL = 8, 32, 1e-5


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


def kernel_row(gen, case: str, B: int, C: int, T: int, d: int, mode: str) -> dict:
    """The fp32 kernel against its plain version on one seeded shape: the
    error (<= KERNEL_TOL) and both device times."""
    import torch

    from rave_tpu_torch.nn.conv import get_padding
    from rave_tpu_torch.ops.kernels.dilated_unit import (
        fused_dilated_unit, fused_dilated_unit_reference, kernel_plan,
    )

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
    return {"case": case, "B": B, "C": C, "T": T, "d": d, "mode": mode,
            "plan": kernel_plan(B, C, T, 3, d, left, False)._asdict(),
            "rel_err": err, "max_abs_err": abs_err, "ms": ms,
            "plain_ms": plain_ms, "tflops": flop / ms / 1e9,
            "plain_tflops": flop / plain_ms / 1e9}


def phase_kernel() -> list:
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    # the loop's validation and eval batches: the 2 clips of the validation split
    val_cases = [("val", LOOP_VAL_BATCH, C, T, d, "centered") for C, T, dils in UNIT_SHAPES
                 for d in dils]
    rows = [kernel_row(gen, *case) for case in kernel_cases(BATCH, ("centered", "causal"))
            + val_cases + variant_unit_cases(BATCH)]
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
             + [c for c in kernel_cases(BATCH, ("centered",)) if c[0] == "main"]
             + variant_unit_cases(TRAIN_BATCH))
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
    from rave_tpu_torch.models.blocks import LatentDraws
    from rave_tpu_torch.ops.kernels import dilated_unit

    cfg = compose(["v2"])
    cpu_model = build_rave(cfg, seed=0, device="cpu").eval()
    model = copy.deepcopy(cpu_model).cuda()
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(BATCH, 1, N_SIGNAL, device="cuda", generator=gen) * 0.1
    T_lat = N_SIGNAL // cfg.decimation()
    draws = LatentDraws(eps=torch.randn(BATCH, cfg.latent_size, T_lat, device="cuda",
                                        generator=gen))
    with torch.inference_mode():
        model(x, draws)  # warm (cuDNN heuristics, allocator)
        torch.cuda.synchronize()
        dilated_unit.launches = dilated_unit.launches_bf16 = 0
        y = model(x, draws)
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
            model(x, draws)
        torch.cuda.synchronize()
        sec = (time.perf_counter() - t0) / iters
        rtf = BATCH * N_SIGNAL / SAMPLE_RATE / sec

        # (b) the same weights and eps at B=1 x 65536: kernel on the GPU, plain on the CPU
        n = 65536
        xb = torch.randn(1, 1, n, generator=torch.Generator().manual_seed(2)) * 0.1
        eb = LatentDraws(eps=torch.randn(1, cfg.latent_size, n // cfg.decimation(),
                                         generator=torch.Generator().manual_seed(3)))
        y_cpu = cpu_model(xb, eb)
        y_gpu = model(xb.cuda(), eb.to("cuda")).cpu()
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


def _train_run(cfg, crop, x, bf16: bool, per_step: int = 22, prewarmup: int = 5,
               cycles: int = 4) -> dict:
    """`prewarmup` pre-warmup generator steps, then `cycles` *
    update_discriminator_every steps picked by pick_phase past the warmup,
    from seed 0, on the card: the kernel launches of each step (`per_step`
    of the expected variant, none of the other), finite losses, moved
    params, the global step; ms per step per phase (mean after the first)
    and the peak memory."""
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
        check(n_kind == per_step and dilated_unit.launches == per_step,
              f"{dilated_unit.launches} kernel launches ({n_bf16} bf16) in a {kind} {name} "
              f"step, expected {per_step} {kind}")
        launches += n_kind
        check(state.step == step + 1, f"global step {state.step} after step {step}")
        bad = [k for k, v in m.items() if not math.isfinite(float(v))]
        check(not bad, f"{kind} {name} step: non-finite {bad}")
        last[name] = {k: float(v) for k, v in m.items()}

    for _ in range(prewarmup):
        one_step("gen", False)
    check(moved(state.model, gen0) > 0, "pre-warmup steps moved no generator param")
    check(moved(state.discriminator, dis0) == 0, "pre-warmup steps moved the critic")
    state.step = t.phase_1_duration
    dis1 = snapshot(state.discriminator)
    for _ in range(cycles * t.update_discriminator_every):
        which, warmed, _ = pick_phase(cfg, state.step)
        one_step(which, warmed)
    check(len(times["dis"]) >= 2 and len(times["gen_adversarial"]) >= 2, f"phases {times}")
    check(moved(state.discriminator, dis1) > 0, "critic steps moved no critic param")
    check(state.step == t.phase_1_duration + cycles * t.update_discriminator_every,
          "global step")
    check(all(p.dtype == torch.float32 for p in state.model.parameters()), "masters not fp32")
    return {"ms_per_step": {k: statistics.mean(v[1:]) * 1e3 for k, v in times.items()},
            "steps": {k: len(v) for k, v in times.items()}, "launches_per_step": per_step,
            "launches": launches, "peak_gb": torch.cuda.max_memory_allocated() / 2**30,
            "last_metrics": last}


def _step_once(cfg, crop, which: str, x, eps, device="cuda", dtype=None):
    """One pre-warmup generator step ("gen") or critic step ("dis") of `cfg`
    from the seed-0 state: (metrics, {name: gradient on the CPU})."""
    from rave_tpu_torch.models.blocks import LatentDraws
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
    x, d = x.to(device, dtype or x.dtype), LatentDraws(eps=eps.to(device, dtype or eps.dtype))
    m = steps["gen"](st, x, False, draws=d) if which == "gen" else steps["dis"](st, x, draws=d)
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
    from rave_tpu_torch.train.steps import build_train_steps

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
    out = {"batch": B, "n_signal": N, **run, "bf16_vs_fp32": compare,
           "variants": {p: _variant_bf16(p, flags) for p in VARIANT_BF16}}
    hybrid = compose(["hybrid"], flags + VARIANT_OVERRIDES["hybrid"])
    check(refuses(lambda: build_train_steps(hybrid, (0, 0)), ValueError),
          "hybrid (mel input) with train.bf16 built its steps; rave_tpu has no such step")
    print(f"train_bf16: v2 + {' '.join(flags)}, B={B} x {N}; ms per step (mean after one warm "
          f"step): " + ", ".join(f"{k} {v:.1f} (x{run['steps'][k] - 1})"
                                 for k, v in run["ms_per_step"].items())
          + f"; 22 bf16 launches and no fp32 per step, {run['launches']} in all; peak "
          + f"{run['peak_gb']:.2f} GiB; B=1 bf16 vs fp32: "
          + "; ".join(f"{k}: losses {c['loss_rel_err']:.2e} ({c['worst_loss']}) <= "
                      f"{BF16_LOSS_TOL}, grad distance {c['grad_distance']:.3e} <= "
                      f"{c['grad_bound']:g}" for k, c in compare.items()), flush=True)
    for preset, v in out["variants"].items():
        r = v["run"]
        print(f"train_bf16 {preset}: B={B} x {N} ms per step (mean after one warm step) "
              + ", ".join(f"{k} {ms:.1f} (x{r['steps'][k] - 1})" for k, ms in
                          r["ms_per_step"].items())
              + f"; {r['launches_per_step']} bf16 launches and no fp32 per step, "
              f"{r['launches']} in all; peak {r['peak_gb']:.2f} GiB; B=1 bf16 vs fp32: "
              + "; ".join(f"{k}: losses {c['loss_rel_err']:.2e} ({c['worst_loss']}) <= "
                          f"{BF16_LOSS_TOL}, grad distance {c['grad_distance']:.3e} <= "
                          f"{c['grad_bound']:g}" for k, c in v["bf16_vs_fp32"].items())
              + "; hybrid + train.bf16 refused (ROADMAP C14)", flush=True)
    for what, cmp in [("v2", compare)] + [(p, v["bf16_vs_fp32"])
                                          for p, v in out["variants"].items()]:
        for k, c in cmp.items():
            check(c["loss_rel_err"] <= BF16_LOSS_TOL,
                  f"{what} bf16 {k} step: losses {c['loss_rel_err']:.3e} from fp32 "
                  f"({c['worst_loss']})")
            check(c["grad_distance"] <= c["grad_bound"],
                  f"{what} bf16 {k} step: gradients {c['grad_distance']:.3e} from fp32, bound "
                  f"{c['grad_bound']}")
    return out


def _variant_bf16(preset: str, flags) -> dict:
    """`preset` with `flags` (train.bf16 + bf16_dis) at full width: `_train_run`'s
    steps (2 pre-warmup, then 2 of each program past the warmup: exact bf16
    launches, finite, ms, peak), without the valid-signal crop (the probe is
    phase `variants`' work; the crop changes no program); then at B=1 x
    131072 from the seed-0 state, on the same draws, a pre-warmup generator
    step at log_epsilon 1e-3 and a critic step in bf16 against fp32 on the
    card, under phase 9's bounds."""
    import torch

    from rave_tpu_torch.config import compose
    from rave_tpu_torch.train.state import create_train_state
    from rave_tpu_torch.train.steps import build_train_steps, draw_noise

    crop_off = ["train.valid_signal_crop=false"]
    cfg = compose([preset], flags + crop_off)
    x = torch.randn(TRAIN_BATCH, 1, N_SIGNAL, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(6)) * 0.1
    run = _train_run(cfg, (0, 0), x, bf16=True, per_step=VARIANT_LAUNCHES[preset],
                     prewarmup=2, cycles=2)
    xb, _ = _b1_inputs(cfg)
    draws = draw_noise(compose([preset]), xb, torch.Generator().manual_seed(9)).to("cuda")
    xb = xb.to("cuda")

    def step(overrides, which):
        c = compose([preset], crop_off + overrides)
        st = create_train_state(c, seed=0, device="cuda")
        if which == "dis":
            st.step = c.train.phase_1_duration
        steps = build_train_steps(c, (0, 0))
        m = (steps["gen"](st, xb, False, draws=draws) if which == "gen"
             else steps["dis"](st, xb, draws=draws))
        module = st.model if which == "gen" else st.discriminator
        return ({k: float(v) for k, v in m.items()},
                {n: p.grad.detach().cpu() for n, p in module.named_parameters()})

    compare = {}
    for key, which, extra in (("gen_eps1e-3", "gen", ["distance.log_epsilon=1e-3"]),
                              ("dis", "dis", [])):
        m32, g32 = step(extra, which)
        m16, g16 = step(flags + extra, which)
        check(all(g.dtype == torch.float32 and bool(torch.isfinite(g).all())
                  for g in g16.values()), f"{preset} bf16 {key} step: gradients not fp32 or "
                                          "not finite")
        losses = {k: abs(m16[k] - v) / max(abs(v), 1e-2) for k, v in m32.items() if _is_loss(k)}
        compare[key] = {"loss_rel_err": max(losses.values()),
                        "worst_loss": max(losses, key=losses.get),
                        "grad_distance": _grad_distance(g16, g32),
                        "grad_bound": GRAD_BF16_BOUND[key]}
    return {"run": run, "bf16_vs_fp32": compare}


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
        draws = draw_noise(cfg, x, torch.Generator(device="cuda").manual_seed(7))
        state = create_train_state(cfg, seed=0, device="cuda")
        step = build_train_steps(cfg, crop)["gen"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        dilated_unit.launches = dilated_unit.launches_bf16 = 0
        t0 = time.perf_counter()
        m = step(state, x, False, draws=draws)
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


def _check_steps(events, kind: str, first: int, last: int, probe: bool = True,
                 per_step: int = 22) -> None:
    """The run took steps first..last-1, each launching `per_step` units of
    its variant (22; 0 for v3, whose Snake units bypass the kernel) and
    finite; each validation batch and the probe's forwards as many."""
    steps = [e for e in events if e["kind"] == "step"]
    check([e["step"] for e in steps] == list(range(first, last)),
          f"{kind} run took steps {[e['step'] for e in steps]}, expected {first}..{last - 1}")
    other = "fp32" if kind == "bf16" else "bf16"
    for e in steps:
        check(e[kind] == per_step and e[other] == 0,
              f"{kind} run, step {e['step']} ({e['phase']}): {e['fp32']} fp32 and "
              f"{e['bf16']} bf16 launches, expected {per_step} {kind}")
        check(e["finite"], f"{kind} run, step {e['step']}: non-finite metrics")
    for e in events:
        if e["kind"] == "validation":
            check(e["fp32"] == per_step * e["batches"] and e["bf16"] == 0,
                  f"validation over {e['batches']} batches: {e['fp32']} fp32 / {e['bf16']} bf16 "
                  "launches")
            check(math.isfinite(e["value"]), f"validation value {e['value']}")
        if e["kind"] == "receptive_field":  # no probe runs for the discrete family: (0, 0)
            check((e["fp32"] > 0) == (probe and per_step > 0) and e["fp32"] % 22 == 0
                  and e["bf16"] == 0,
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
    return out


def write_signal(path: Path, seconds: float, seed: int) -> int:
    """A seeded mono .wav of tones, a chirp and noise; its length in samples."""
    import numpy as np
    from scipy.io import wavfile

    rng = np.random.default_rng(seed)
    n = int(round(seconds * SAMPLE_RATE))
    t = np.arange(n) / SAMPLE_RATE
    f0 = rng.uniform(80, 800, size=3)
    x = sum(0.15 * np.sin(2 * np.pi * f * (1 + k) * t) / (1 + k) for k, f in enumerate(f0))
    x = x + 0.2 * np.sin(2 * np.pi * (60 + 30 * t) * t) + 0.05 * rng.standard_normal(n)
    wavfile.write(path, SAMPLE_RATE, (np.clip(x, -1, 1) * 32767).astype(np.int16))
    return n


def phase_export(run_dir: Path) -> dict:
    import numpy as np
    import torch
    from scipy.io import wavfile

    from rave_tpu_torch.data.audio_io import decode_file
    from rave_tpu_torch.export.artifact import ExportedRAVE
    from rave_tpu_torch.export.generate import load_signal
    from rave_tpu_torch.ops.kernels import dilated_unit
    from rave_tpu_torch.utils import checkpoint
    from rave_tpu_torch.utils.rng import normal_from_seed

    work = ROOT / "build" / "loop"
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # 1. the loop's run exported twice through the CLI
    arts = {}
    for key, flags in (("streaming_ema", ["--streaming", "--ema_weights"]),
                       ("stereo_88200", ["--stereo", "--sr", 2 * SAMPLE_RATE])):
        torch.cuda.synchronize()
        dilated_unit.launches = dilated_unit.launches_bf16 = 0
        t0 = time.perf_counter()
        text = _cli(["export", "--run", run_dir, "--output", work / "export" / key,
                     "--device", "cuda", *flags])
        torch.cuda.synchronize()
        path = Path(text.strip().splitlines()[-1].removeprefix("exported: "))
        arts[key] = {"path": path, "seconds": time.perf_counter() - t0,
                     "mib": sum(f.stat().st_size for f in path.iterdir()) / 2**20,
                     "launches": dilated_unit.launches,
                     "manifest": json.loads((path / "manifest.json").read_text())}
    cfg = json.loads((run_dir / "config.json").read_text())
    fid = torch.load(checkpoint.latest_checkpoint(str(run_dir)), map_location="cpu",
                     weights_only=True)["model"]["fidelity"].numpy()
    D, ratio = cfg["latent_size"], 2048  # v2: 16 bands x 4 x 4 x 4 x 2
    k = max(int(np.argmax(fid > 0.95)), 1)
    latent = min(2 ** math.ceil(math.log2(k)), D)
    for key, a in arts.items():
        m, stereo = a["manifest"], key.startswith("stereo")
        check(m["format"] == "rtpu-torch-v1" and m["latent_size"] == latent
              and m["full_latent_size"] == D, f"{key}: latent {m['latent_size']} of "
              f"{m['full_latent_size']}, expected {latent} of {D} from fidelity {fid.tolist()}")
        check((m["methods"]["encode"]["out_ratio"], m["methods"]["decode"]["in_ratio"],
               m["methods"]["forward"]["out_ratio"], m["block_size"]) == (ratio, ratio, 1, ratio),
              f"{key}: ratios {m['methods']}")
        lat = m["latency"]
        check(lat["encode_latent_frames"] > 0 and lat["decode_samples"] > 0 and
              lat["total_samples"] == lat["encode_latent_frames"] * ratio + lat["decode_samples"],
              f"{key}: latency {lat}")
        check((m["stream_batch"], m["target_sampling_rate"], m["streaming"])
              == ((2, 2 * SAMPLE_RATE, False) if stereo else (1, SAMPLE_RATE, True)),
              f"{key}: stream batch {m['stream_batch']}, rate {m['target_sampling_rate']}")
        check(all(e["device"].startswith("cuda") for e in m["aot"].values()), f"{key}: aot")
    latencies = [a["manifest"]["latency"] for a in arts.values()]
    check(latencies[0] == latencies[1], f"the two artifacts' latencies differ: {latencies}")

    # 2. generate through the CLI on a 30 s file (ragged against the block)
    art_path = arts["streaming_ema"]["path"]
    wav = work / "generate_in.wav"
    n = write_signal(wav, EXPORT_SECONDS, seed=21)
    torch.cuda.synchronize()
    dilated_unit.launches = dilated_unit.launches_bf16 = 0
    t0 = time.perf_counter()
    _cli(["generate", "--model", art_path, "--input", wav, "--out_path", work / "generated",
          "--seed", GENERATE_SEED, "--device", "cuda"])
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    launches = dilated_unit.launches
    check(launches == 22 and dilated_unit.launches_bf16 == 0,
          f"generate: {launches} launches ({dilated_unit.launches_bf16} bf16), expected 22 fp32")
    art = ExportedRAVE(str(art_path), device="cuda", seed=GENERATE_SEED)
    x = load_signal(decode_file(str(wav), SAMPLE_RATE, 1), 1, 1, art.block_size).cuda()
    y = art.forward(x)[0, 0, :n].clamp(-1, 1).cpu().numpy()
    sr, written = wavfile.read(work / "generated" / "generate_in_reconstructed.wav")
    wav_err = float(np.abs(written / 32767 - y).max())
    check(sr == SAMPLE_RATE and written.shape == (n,) and np.isfinite(y).all()
          and wav_err <= 1 / 32767 + 1e-7,
          f"generated wav ({sr} Hz, {written.shape}) {wav_err:.3e} from the artifact's forward")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        art.forward(x)
    torch.cuda.synchronize()
    forward_s = (time.perf_counter() - t0) / 3

    # 3. the card against the CPU (plain unit), same artifact and seeds
    clip = x[..., : -(-int(CLIP_SECONDS * SAMPLE_RATE) // art.block_size) * art.block_size]
    cpu = ExportedRAVE(str(art_path), device="cpu")
    y_gpu, y_cpu = art.forward(clip, seed=7).cpu(), cpu.forward(clip.cpu(), seed=7)
    offline_err = rel_err(y_gpu, y_cpu)
    art.reset_stream()
    B = art.block_size
    outs = [(art.forward(clip[..., i * B:(i + 1) * B], streaming=True, seed=50 + i).cpu(),
             cpu.forward(clip[..., i * B:(i + 1) * B].cpu(), streaming=True, seed=50 + i))
            for i in range(CPU_STREAM_BLOCKS)]
    stream_err = rel_err(torch.cat([a for a, _ in outs], -1), torch.cat([b for _, b in outs], -1))
    # the stereo artifact (two rows, resampled at both ends) likewise, and the
    # seeded draws themselves
    st_path = arts["stereo_88200"]["path"]
    st_gpu, st_cpu = ExportedRAVE(str(st_path), device="cuda"), ExportedRAVE(str(st_path), "cpu")
    xs = torch.randn(2, 1, 4 * st_gpu.block_size, generator=torch.Generator().manual_seed(8))
    ys_gpu = st_gpu.forward(xs.cuda() * 0.1, seed=9).cpu()
    stereo_err = rel_err(ys_gpu, st_cpu.forward(xs * 0.1, seed=9))
    draws = normal_from_seed(12345, (1, D, 4096), 1, device="cuda").cpu()
    draw_err = float((draws - normal_from_seed(12345, (1, D, 4096), 1)).abs().max())
    check(offline_err <= MODEL_TOL and stream_err <= MODEL_TOL and stereo_err <= MODEL_TOL
          and ys_gpu.shape == xs.shape and draw_err <= 1e-6,
          f"artifact GPU vs CPU rel err: offline {offline_err:.3e}, streaming {stream_err:.3e}, "
          f"stereo at 88.2 kHz {stereo_err:.3e} > {MODEL_TOL}; seeded draws {draw_err:.3e}")

    # 4. forward_step.pt2 in lockstep with the eager streaming forward; beside
    # them, the model's bare step pair (no codec, no seed, no state swap)
    program = art.load_program("forward")
    art.reset_stream()
    state = [s.clone() for s in art.state]
    eager_ms, program_ms, bare_ms, y_err, state_err = [], [], [], 0.0, 0.0
    for i in range(PROGRAM_BLOCKS):
        xb = x[..., i * B:(i + 1) * B]
        torch.cuda.synchronize()
        tb = time.perf_counter()
        with torch.no_grad():
            art.model.step_decode(art.model.step_encode(xb)[:, :D])
        torch.cuda.synchronize()
        bare_ms.append((time.perf_counter() - tb) * 1e3)
        t0 = time.perf_counter()
        y_e = art.forward(xb, streaming=True, seed=1000 + i)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        y_p, state = program(state, xb, torch.tensor(1000 + i, device="cuda"))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        eager_ms.append((t1 - t0) * 1e3)
        program_ms.append((t2 - t1) * 1e3)
        y_err = max(y_err, rel_err(y_p, y_e))
        state_err = max([state_err] + [rel_err(a, b, 1e-6) for a, b in zip(state, art.state)])
    check(y_err <= PROGRAM_TOL and state_err <= PROGRAM_TOL,
          f"forward_step.pt2 vs eager over {PROGRAM_BLOCKS} blocks: y {y_err:.3e}, state "
          f"{state_err:.3e} > {PROGRAM_TOL}")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    # 5. the unit at the 30 s forward's 11 centered shapes, B=1
    N = x.shape[-1]
    gen = torch.Generator(device="cuda").manual_seed(30)
    unit_rows = [kernel_row(gen, "export_b1", 1, C, N // (16 * 4 ** i), d, "centered")
                 for i, (C, _, dils) in enumerate(UNIT_SHAPES) for d in dils]
    p50 = {"eager": statistics.median(eager_ms), "program": statistics.median(program_ms),
           "bare_model_steps": statistics.median(bare_ms)}
    out = {"artifacts": {k: {kk: (str(v.relative_to(ROOT)) if kk == "path" else v)
                             for kk, v in a.items() if kk != "manifest"} for k, a in arts.items()},
           "latent_size": latent, "generate_launches": launches, "generate_s": generate_s,
           "forward_s": forward_s, "seconds_of_audio": n / SAMPLE_RATE,
           "realtime_factor_generate": n / SAMPLE_RATE / generate_s,
           "realtime_factor_forward": n / SAMPLE_RATE / forward_s, "wav_err": wav_err,
           "gpu_vs_cpu_rel_err": {"offline": offline_err, "stream": stream_err,
                                  "stereo_88200": stereo_err, "draws_abs": draw_err},
           "program_rel_err": {"y": y_err, "state": state_err}, "block_ms_p50": p50,
           "block_budget_ms": B / SAMPLE_RATE * 1e3, "peak_gb": peak_gb, "unit_b1": unit_rows,
           "seconds": time.perf_counter() - t_phase}
    print(f"export: cli export x2 (--streaming --ema_weights; --stereo --sr {2 * SAMPLE_RATE}) "
          + "; ".join(f"{k} {a['seconds']:.1f} s, {a['mib']:.1f} MiB" for k, a in arts.items())
          + f"; latent {latent} of {D}; generate {n / SAMPLE_RATE:.1f} s of audio: {launches} "
          f"launches, wav {wav_err:.2e} from forward; GPU vs CPU offline {offline_err:.2e}, "
          f"{CPU_STREAM_BLOCKS} blocks {stream_err:.2e}, stereo {stereo_err:.2e} <= {MODEL_TOL}, "
          f"draws {draw_err:.1e}; forward_step.pt2 vs "
          f"eager {PROGRAM_BLOCKS} blocks y {y_err:.2e}, state {state_err:.2e} <= {PROGRAM_TOL}",
          flush=True)
    print(f"export times: generate realtime factor {out['realtime_factor_generate']:.1f}x end "
          f"to end ({generate_s:.2f} s), {out['realtime_factor_forward']:.1f}x bare forward "
          f"({forward_s * 1e3:.1f} ms); streaming p50 per block eager {p50['eager']:.3f} ms, "
          f".pt2 {p50['program']:.3f} ms, the model's bare steps {p50['bare_model_steps']:.3f} "
          f"ms (budget {out['block_budget_ms']:.2f} ms); peak "
          f"{peak_gb:.2f} GiB; unit B=1 kernel/plain ms: {shape_summary(unit_rows)}; phase "
          f"{out['seconds']:.1f} s", flush=True)
    return out


# the discrete phase: the C=768 unit shapes only discrete reaches (T=256 at B=16 x 131072)
# the prior phase: the stock prior (prior_v1.gin) at latent_size 16 over the 128 latent
# frames of the 262144 samples train_prior takes at v2's decimation (2048)
PRIOR_LATENT, PRIOR_FRAMES, PRIOR_STREAM_STEPS = 16, 128, 64
PRIOR_PROGRAM_STEPS, PRIOR_TIMED_STEPS, PRIOR_SECONDS = 32, 64, 5.0
PRIOR_STREAM_TOL = 1e-4  # 64 chained steps against the offline logits
PRIOR_FRAME_MS = 2048 / SAMPLE_RATE * 1e3  # one latent frame of v2: a live prior's budget
# train_prior's clips: the loop's 16-step run keeps most of its 128 dimensions at fidelity
# 0.95, and the diagonal shift of D dimensions takes D - 1 of the clip's frames, so the
# default 262144 samples (128 frames) would leave one; 524288 leave at least 129
PRIOR_N_SIGNAL = 524288
# the units of one v2 encoder (or decoder): each shape's dilations once
UNITS_PER_HALF = sum(len(d) for _, _, d in UNIT_SHAPES)


def _stock_prior() -> dict:
    """(a) The stock prior at full width on the card: the forward at B=8 x 128
    frames against the same weights on the CPU, 64 chained steps against the
    offline logits, and one Adam step (ms, peak memory)."""
    import torch

    from rave_tpu_torch.nn.streaming import init_stream_state
    from rave_tpu_torch.prior.core import stack_one_hot
    from rave_tpu_torch.prior.model import build_prior, prior_loss

    prior = build_prior(PRIOR_LATENT, seed=0, device="cuda")
    cpu = build_prior(PRIOR_LATENT, seed=0, device="cpu")
    R = prior.resolution
    classes = torch.randint(0, R, (TRAIN_BATCH, PRIOR_LATENT, PRIOR_FRAMES),
                            generator=torch.Generator().manual_seed(12))
    x_cpu = stack_one_hot(classes, R)
    x = x_cpu.to("cuda")
    with torch.no_grad():
        logits = prior(x)
        err_cpu = rel_err(logits.cpu(), cpu(x_cpu))
        init_stream_state(prior, TRAIN_BATCH)
        chained = torch.cat([prior.step(x[..., t:t + 1]) for t in range(PRIOR_STREAM_STEPS)], -1)
        err_stream = rel_err(chained, logits[..., :PRIOR_STREAM_STEPS])
    check(logits.shape == x.shape and bool(torch.isfinite(logits).all()),
          f"prior logits {tuple(logits.shape)} or not finite")
    check(err_cpu <= MODEL_TOL, f"prior card vs CPU {err_cpu:.3e} > {MODEL_TOL}")
    check(err_stream <= PRIOR_STREAM_TOL,
          f"prior {PRIOR_STREAM_STEPS} chained steps vs offline {err_stream:.3e}")
    opt = torch.optim.Adam(prior.parameters(), lr=1e-4)
    times = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for _ in range(3):  # two warm steps, then the timed one
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = prior_loss(prior, x, PRIOR_LATENT)
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    check(math.isfinite(loss.item()), "prior loss not finite")
    return {"channels": PRIOR_LATENT * R, "receptive_field": prior.receptive_field,
            "params": sum(p.numel() for p in prior.parameters()), "card_vs_cpu": err_cpu,
            "stream_vs_offline": err_stream, "step_ms": times[-1], "loss": loss.item(),
            "peak_gb": (torch.cuda.max_memory_allocated() - base) / 2**30}


def v2_unit_shapes(batch: int, n_samples: int, mode: str = "centered") -> list:
    """(B, C, T, d, mode) of the units of one v2 encoder over `n_samples`
    samples, sorted; a decoder that writes `n_samples` has the same."""
    return sorted((batch, C, n_samples // (16 * 4 ** i), d, mode)
                  for i, (C, _, dils) in enumerate(UNIT_SHAPES) for d in dils)


class UnitShapes:
    """While open, records (B, C, T, d, mode) of every fused unit call on a
    CUDA tensor, in process: the shapes the path gives the kernel."""

    def __enter__(self):
        from rave_tpu_torch.models.blocks import FusedDilatedResidual

        self.cls, self.saved, self.seen = FusedDilatedResidual, FusedDilatedResidual.forward, []
        saved, seen = self.saved, self.seen

        def forward(mod, x):
            if x.is_cuda and mod.inner.activation == "leaky_relu":
                left, right = mod.inner.net.layers[1].pad
                seen.append((x.shape[0], x.shape[1], x.shape[2], mod.inner.dilation,
                             "centered" if left == right else "causal"))
            return saved(mod, x)

        self.cls.forward = forward
        return self

    def __exit__(self, *exc):
        self.cls.forward = self.saved


class PriorProbe:
    """Counts the unit's launches of each `encode_latents` and `decode_latents`
    call that `train_prior` makes (the frozen RAVE's halves), in process, and
    the unit shapes of each from `shapes` (a `UnitShapes`); keeps the first
    batch that `encode_latents` was given."""

    NAMES = ("encode_latents", "decode_latents")

    def __init__(self, shapes: UnitShapes):
        from rave_tpu_torch.prior import train

        self.module, self.calls = train, {name: [] for name in self.NAMES}
        self.saved = {name: getattr(train, name) for name in self.NAMES}
        self.shapes, self.first_x = shapes, None

    def __enter__(self):
        for name in self.NAMES:
            setattr(self.module, name, self.observe(name, self.saved[name]))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.module, name, fn)

    def observe(self, name: str, fn):
        import torch

        from rave_tpu_torch.ops.kernels import dilated_unit

        def call(*args, **kwargs):
            if name == "encode_latents" and self.first_x is None:
                self.first_x = args[2].clone()
            torch.cuda.synchronize()
            before, seen, t0 = dilated_unit.launches, len(self.shapes.seen), time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.calls[name].append({"launches": dilated_unit.launches - before,
                                     "ms": (time.perf_counter() - t0) * 1e3,
                                     "units": sorted(self.shapes.seen[seen:])})
            return out

        return call


def check_prior_codes(card_art, cpu_art, n: int, seed: int) -> dict:
    """`sample_prior(argmax=True)` on the card against the CPU: the card's
    chain of frames, fed to the CPU's prior (teacher-forced: causal, so its
    offline logits are the chained steps'), gives the card's pick at every
    step and dimension unless the two picks' CPU logits tie (CODE_TIE). The
    latents that each device samples on its own are compared (reported)."""
    import torch

    from rave_tpu_torch.prior.model import split_classes

    prior = card_art.prior_step.prior
    D, R = prior.latent_size, prior.resolution
    x = torch.zeros(1, D * R, 1, device="cuda")
    state, frames = card_art.prior_state(), []
    with torch.no_grad():
        for i in range(n + D - 1):
            x, state = card_art.prior_step(state, x, torch.tensor(0, device="cuda"), True)
            frames.append(x)
        card = torch.cat(frames, -1).cpu()
        inputs = torch.cat([torch.zeros(1, D * R, 1), card[..., :-1]], -1)
        logits = split_classes(cpu_art.prior_step.prior(inputs), D)  # [1, D, R, n + D - 1]
    picks_card, picks_cpu = split_classes(card, D).argmax(2), logits.argmax(2)
    bad = (picks_card != picks_cpu).nonzero()
    l_card = logits[0, bad[:, 1], picks_card[0, bad[:, 1], bad[:, 2]], bad[:, 2]].double()
    l_cpu = logits[0, bad[:, 1], picks_cpu[0, bad[:, 1], bad[:, 2]], bad[:, 2]].double()
    ties = int(((l_cpu - l_card).abs() <= CODE_TIE * (l_cpu.abs() + l_card.abs())).sum())
    check(len(bad) == ties, f"prior argmax codes: {len(bad)} differ on the card's chain, "
                            f"{ties} of them ties")
    z_card = card_art.sample_prior(n, seed=seed, argmax=True).cpu()
    z_cpu = cpu_art.sample_prior(n, seed=seed, argmax=True)
    return {"codes": int(picks_card.numel()), "codes_differ": len(bad), "code_ties": ties,
            "own_chain_z_rel_err": rel_err(z_card, z_cpu)}


def phase_prior(run_dir: Path, db: Path) -> dict:
    """The latent prior on phase `loop`'s v2 run and store; see the module docstring."""
    import numpy as np
    import torch
    from scipy.io import wavfile

    from rave_tpu_torch.export.artifact import ExportedRAVE, prior_step_seed
    from rave_tpu_torch.ops.kernels import dilated_unit
    from rave_tpu_torch.prior.train import encode_latents
    from rave_tpu_torch.utils.checkpoint import load_run

    t_phase = time.perf_counter()
    work = ROOT / "build" / "prior"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    stock = _stock_prior()

    # (b) train_prior --smoke_test: 2 steps, a validation sample and a save after each
    torch.cuda.synchronize()
    dilated_unit.launches = dilated_unit.launches_bf16 = 0
    t0 = time.perf_counter()
    shapes = UnitShapes().__enter__()  # closed after (c)'s generate
    with PriorProbe(shapes) as probe:
        out = _cli(["train_prior", "--run", run_dir, "--db_path", db, "--name", "smoke",
                    "--out_path", work, "--n_signal", PRIOR_N_SIGNAL, "--smoke_test",
                    "--device", "cuda"])
    train_s = time.perf_counter() - t0
    launches_train = dilated_unit.launches
    prior_run = Path(out.strip().splitlines()[-1].removeprefix("prior run dir: "))
    pcfg = json.loads((prior_run / "prior_config.json").read_text())
    enc, dec = probe.calls["encode_latents"], probe.calls["decode_latents"]
    check(len(enc) == 2 and len(dec) == 2, f"train_prior: {len(enc)} encodes, {len(dec)} decodes")
    check(all(c["launches"] == UNITS_PER_HALF for c in enc + dec),
          f"unit launches per encode_latents {[c['launches'] for c in enc]}, per decode "
          f"{[c['launches'] for c in dec]}; expected {UNITS_PER_HALF} each")
    check(launches_train == UNITS_PER_HALF * 4 and dilated_unit.launches_bf16 == 0,
          f"train_prior: {launches_train} launches")
    enc_units = v2_unit_shapes(TRAIN_BATCH, PRIOR_N_SIGNAL)
    # the validation sample: 128 frames generated, less the D - 1 that undoing the shift
    # takes (as rave_tpu/prior/train.py decodes it)
    val_frames = min(128, PRIOR_N_SIGNAL // 2048) - pcfg["latent_size"] + 1
    dec_units = v2_unit_shapes(1, val_frames * 2048)
    check(all(c["units"] == enc_units for c in enc) and all(c["units"] == dec_units for c in dec),
          f"unit shapes per encode_latents {[c['units'] for c in enc]}, per decode "
          f"{[c['units'] for c in dec]}; expected {enc_units} and {dec_units}")
    rows = [json.loads(r) for r in (prior_run / "metrics.jsonl").read_text().splitlines()]
    check([r["step"] for r in rows] == [1, 2]
          and all(math.isfinite(r["latent_prediction"]) for r in rows), f"prior rows {rows}")
    check(len(list((prior_run / "checkpoints").iterdir())) == 2, "prior checkpoints")

    # (c) export --prior, generate --prior_seconds, the artifact card vs CPU, .pt2, timing
    t0 = time.perf_counter()
    out = _cli(["export", "--run", run_dir, "--prior", prior_run, "--output", work / "export",
                "--device", "cuda"])
    export_s = time.perf_counter() - t0
    path = out.strip().splitlines()[-1].removeprefix("exported: ")
    launches_export = dilated_unit.launches - launches_train
    before = dilated_unit.launches
    t0 = time.perf_counter()
    _cli(["generate", "--model", path, "--prior_seconds", PRIOR_SECONDS, "--out_path",
          work / "gen", "--seed", GENERATE_SEED, "--device", "cuda"])
    generate_s = time.perf_counter() - t0
    launches_generate = dilated_unit.launches - before
    launches = dilated_unit.launches
    shapes.__exit__()
    check(len(shapes.seen) == launches, f"{len(shapes.seen)} unit calls on the card recorded, "
                                        f"{launches} launches counted")
    check(launches_export == UNITS_PER_HALF and launches_generate == UNITS_PER_HALF,
          f"export --prior {launches_export} launches (its smoke decode), generate "
          f"--prior_seconds {launches_generate} (one decode); expected {UNITS_PER_HALF} each")
    art = ExportedRAVE(path, device="cuda")
    cpu_art = ExportedRAVE(path, device="cpu")
    decim = art.cfg.decimation()
    sr, wav = wavfile.read(work / "gen" / "prior_sample_0.wav")
    n_frames = max(round(PRIOR_SECONDS * SAMPLE_RATE / decim), 1)
    check(sr == SAMPLE_RATE and wav.shape == (n_frames * decim,),
          f"prior sample wav {sr} Hz, {wav.shape}; expected {n_frames * decim} samples")
    gen_units = sorted(shapes.seen[-UNITS_PER_HALF:])
    check(gen_units == v2_unit_shapes(1, n_frames * decim),
          f"generate --prior_seconds: unit shapes {gen_units}")
    check(bool(np.abs(wav).max() > 0), "the prior sample is silent")

    check(art.has_prior and art.manifest["prior"] == pcfg, "the artifact's prior")
    codes = check_prior_codes(art, cpu_art, PRIOR_PROGRAM_STEPS, GENERATE_SEED)
    program = art.load_program("prior")
    D = art.prior_step.prior.latent_size * art.prior_step.prior.resolution
    x_e = x_p = torch.zeros(1, D, 1, device="cuda")
    s_e, s_p = art.prior_state(), art.prior_state()
    with torch.no_grad():
        for i in range(PRIOR_PROGRAM_STEPS):
            seed = torch.tensor(prior_step_seed(GENERATE_SEED, i), dtype=torch.int64,
                                device="cuda")
            x_e, s_e = art.prior_step(s_e, x_e, seed)
            x_p, s_p = program(s_p, x_p, seed)
            check(torch.equal(x_e, x_p) and all(torch.equal(a, b) for a, b in zip(s_e, s_p)),
                  f"prior_step.pt2 differs from the eager step at step {i}")

    def step_ms(fn) -> list:
        x, state, ms = torch.zeros(1, D, 1, device="cuda"), art.prior_state(), []
        with torch.no_grad():
            for i in range(PRIOR_TIMED_STEPS + 4):
                seed = torch.tensor(prior_step_seed(1, i), dtype=torch.int64, device="cuda")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                x, state = fn(state, x, seed)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
        return ms[4:]

    p50 = {"eager": statistics.median(step_ms(art.prior_step)),
           "program": statistics.median(step_ms(program))}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    z = art.sample_prior(n_frames, seed=GENERATE_SEED)
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0
    check(z.shape == (1, art.latent_size, n_frames) and bool(torch.isfinite(z).all()),
          f"sample_prior {tuple(z.shape)} or not finite")

    # (d) the unit at the path's shapes; an encode_latents batch and a sample's decode
    gen = torch.Generator(device="cuda").manual_seed(16)
    unit_rows = [kernel_row(gen, "prior", *shape) for shape in sorted(set(shapes.seen))]
    by_shape = {(r["B"], r["C"], r["T"], r["d"], r["mode"]): r for r in unit_rows}
    path_rows = [by_shape[shape] for shape in shapes.seen]  # one per launch
    unit_path = {"launches": len(path_rows), "ms": sum(r["ms"] for r in path_rows),
                 "plain_ms": sum(r["plain_ms"] for r in path_rows),
                 "bound_ms": sum(unit_bound([r], r["B"], "fp32")["bound_ms"] for r in path_rows),
                 "max_abs_err": max(r["max_abs_err"] for r in unit_rows)}
    x = probe.first_x
    eps = torch.randn(x.shape[0], art.cfg.latent_size, x.shape[-1] // decim,
                      generator=torch.Generator().manual_seed(17))
    z_enc = {}
    for dev in ("cuda", "cpu"):
        cfg_d, vae, _, _ = load_run(str(run_dir), device=dev)
        z_enc[dev] = encode_latents(cfg_d, vae, x.to(dev), pcfg["latent_size"],
                                    eps=eps.to(dev)).cpu()
        del vae
    encode_err = rel_err(z_enc["cuda"], z_enc["cpu"])
    decode_err = rel_err(art.decode(z, seed=GENERATE_SEED).cpu(),
                         cpu_art.decode(z.cpu(), seed=GENERATE_SEED))
    check(z_enc["cuda"].shape == (x.shape[0], pcfg["latent_size"], x.shape[-1] // decim)
          and encode_err <= MODEL_TOL and decode_err <= MODEL_TOL,
          f"prior path card vs CPU: encode_latents {tuple(z_enc['cuda'].shape)} "
          f"{encode_err:.3e}, a sample's decode {decode_err:.3e} > {MODEL_TOL}")
    shutil.rmtree(work, ignore_errors=True)
    out = {"stock": stock, "latent_size": pcfg["latent_size"], "artifact_latent_size":
           art.latent_size, "train_s": train_s, "encode_ms": [c["ms"] for c in enc],
           "decode_ms": [c["ms"] for c in dec], "ce": [r["latent_prediction"] for r in rows],
           "export_s": export_s, "generate_s": generate_s, "wav_samples": int(wav.shape[0]),
           "card_vs_cpu": codes, "program_steps_bit_equal": PRIOR_PROGRAM_STEPS,
           "step_ms_p50": p50, "frame_budget_ms": PRIOR_FRAME_MS,
           "sample_prior_s": sample_s, "sample_frames": n_frames,
           "launches": launches, "launches_per_encode": UNITS_PER_HALF,
           "launches_per_decode": UNITS_PER_HALF, "unit_rows": unit_rows,
           "unit_path": unit_path, "card_vs_cpu_encode": encode_err,
           "card_vs_cpu_decode": decode_err, "seconds": time.perf_counter() - t_phase}
    print(f"prior: stock prior (latent {PRIOR_LATENT}, {stock['channels']} channels, rf "
          f"{stock['receptive_field']}, {stock['params']} params) B={TRAIN_BATCH} x "
          f"{PRIOR_FRAMES} frames: card vs CPU {stock['card_vs_cpu']:.2e}, "
          f"{PRIOR_STREAM_STEPS} chained steps vs offline {stock['stream_vs_offline']:.2e}; "
          f"Adam step {stock['step_ms']:.2f} ms, peak {stock['peak_gb']:.2f} GiB; "
          f"cli train_prior --smoke_test on the loop's run: latent_size {out['latent_size']} "
          f"(artifact {art.latent_size}), ce {out['ce']}, {UNITS_PER_HALF} launches per "
          f"encode_latents ({', '.join(f'{ms:.1f}' for ms in out['encode_ms'])} ms) and per "
          f"decode ({', '.join(f'{ms:.1f}' for ms in out['decode_ms'])} ms), {train_s:.1f} s; "
          f"export --prior {export_s:.1f} s; generate --prior_seconds {PRIOR_SECONDS:g} "
          f"{generate_s:.2f} s, {wav.shape[0]} samples; sample_prior({n_frames}) "
          f"{sample_s:.2f} s; argmax codes card vs CPU on the card's chain: "
          f"{codes['codes_differ']} of {codes['codes']} differ ({codes['code_ties']} ties), "
          f"own chains' latents {codes['own_chain_z_rel_err']:.2e}; prior_step.pt2 "
          f"bit-equal over {PRIOR_PROGRAM_STEPS} steps; step p50 eager {p50['eager']:.3f} / "
          f".pt2 {p50['program']:.3f} ms (frame budget {PRIOR_FRAME_MS:.2f}); {launches} "
          f"launches; card vs CPU encode_latents (B={x.shape[0]}) {encode_err:.2e}, a "
          f"sample's decode {decode_err:.2e} <= {MODEL_TOL}; unit at the path's "
          f"{len(unit_rows)} shapes: max rel err {max(r['rel_err'] for r in unit_rows):.2e} <= "
          f"{KERNEL_TOL}, its {launches} launches {unit_path['ms']:.3f} ms (plain "
          f"{unit_path['plain_ms']:.3f}, bound {unit_path['bound_ms']:.3f}); kernel/plain ms: "
          f"{shape_summary(unit_rows)}; {out['seconds']:.1f} s", flush=True)
    for kind, ms in p50.items():
        check(ms < PRIOR_FRAME_MS, f"prior step p50 ({kind}) {ms:.3f} ms over one latent "
                                   f"frame's {PRIOR_FRAME_MS:.2f} ms")
    return out


DISCRETE_UNITS = [(768, 256, (1, 3))]
DISCRETE_PREWARMUP_STEPS, DISCRETE_WARMED_STEPS = 3, 8  # after the k-means step; 2 critic
DISCRETE_LOOP = ["train.phase_1_duration=3", "train.update_discriminator_every=2",
                 "train.ema=0.999"]
DISCRETE_LOOP_STEPS, DISCRETE_RESUME_STEPS, DISCRETE_VAL_EVERY = 6, 8, 3
# card vs CPU codes on one shared latent: a code may differ only where its two
# float64 distances tie within this share of |r|^2 + |c|^2 (float32's rounding)
CODE_TIE = 1e-6


def _family_step_b1(names, which: str, warmed: bool) -> dict:
    """The first step of one program of `names` from the seed-0 state at B=1
    x n_signal, on the card and on the CPU with the same draws (drawn on the
    CPU): {device: metrics}."""
    import torch

    from rave_tpu_torch.config import compose
    from rave_tpu_torch.train.state import create_train_state
    from rave_tpu_torch.train.steps import build_train_steps, draw_noise

    cfg = compose(names)
    xb, _ = _b1_inputs(cfg)
    draws = draw_noise(cfg, xb, torch.Generator().manual_seed(9))
    out = {}
    for device in ("cuda", "cpu"):
        st = create_train_state(cfg, seed=0, device=device)
        st.step = cfg.train.phase_1_duration if warmed else 0
        steps = build_train_steps(cfg)  # no crop: the same on both devices
        x, d = xb.to(device), draws.to(device)
        m = (steps["gen"](st, x, warmed, draws=d) if which == "gen"
             else steps["dis"](st, x, draws=d))
        out[device] = {k: float(v) for k, v in m.items()}
    return out


def _loss_err(a: dict, b: dict) -> float:
    return max(abs(a[k] - v) / max(abs(v), 1e-2) for k, v in b.items())


def codes_summary(c: dict) -> str:
    return (f"latents {c['z_rel_err']:.2e}, codes on the card's latent: "
            f"{c['shared_latent_codes_differ']} differ ({c['shared_latent_code_ties']} ties); "
            f"each its own latent: {c['index_agreement']:.4f} equal (reported)")


def check_codes(card_rvq, cpu_rvq, z_card, z_cpu, what: str) -> dict:
    """The RVQ on the card against the CPU's, from latents [B, D, T] that
    each device encoded: the latents within MODEL_TOL; then on one shared
    latent, the card's, each quantizer of the CPU fed the card's residual
    picks the card's code, unless the two codes tie (CODE_TIE). The share of
    equal codes when each device quantizes its own latent is reported only:
    near-ties flip between latents 1e-6 apart (ROADMAP C11)."""
    z_err = rel_err(z_card.cpu(), z_cpu)
    residual = z_card.transpose(1, 2).reshape(-1, z_card.shape[1])
    differ = ties = 0
    for card_vq, cpu_vq in zip(card_rvq.vq, cpu_rvq.vq):
        mine, shared = card_vq.codebook.encode(residual), residual.cpu()
        theirs, mine_cpu = cpu_vq.codebook.encode(shared), mine.cpu()
        bad = (mine_cpu != theirs).nonzero().flatten()
        if len(bad):
            r, codes = shared[bad].double(), cpu_vq.codebook.embed.double()
            d_mine = ((r - codes[mine_cpu[bad]]) ** 2).sum(-1)
            d_theirs = ((r - codes[theirs[bad]]) ** 2).sum(-1)
            scale = (r ** 2).sum(-1) + (codes[theirs[bad]] ** 2).sum(-1)
            differ += len(bad)
            ties += int(((d_mine - d_theirs).abs() <= CODE_TIE * scale).sum())
        residual = residual - card_vq.codebook.decode(mine)
    own = card_rvq.encode(z_card.transpose(1, 2)).cpu() == cpu_rvq.encode(z_cpu.transpose(1, 2))
    check(z_err <= MODEL_TOL and differ == ties,
          f"{what} card vs CPU: latents {z_err:.3e}; on the card's latent {differ} codes "
          f"differ, {ties} of them ties")
    return {"z_rel_err": z_err, "shared_latent_codes_differ": differ,
            "shared_latent_code_ties": ties, "index_agreement": float(own.float().mean())}


def _discrete_offline(cfg) -> dict:
    """B=16 x 131072 forward (timed, 22 launches) and, at phase `offline`'s
    B=1 x 65536, the encoder output, the RVQ codes and the decode of one
    index tensor on the card against the CPU."""
    import torch

    from rave_tpu_torch.factory import build_rave
    from rave_tpu_torch.ops.kernels import dilated_unit
    from rave_tpu_torch.train.steps import draw_noise

    cpu_model = build_rave(cfg, seed=0, device="cpu").eval()
    model = copy.deepcopy(cpu_model).cuda()
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(BATCH, 1, N_SIGNAL, device="cuda", generator=gen) * 0.1
    draws = draw_noise(cfg, x, gen)
    with torch.inference_mode():
        model(x, draws)  # warm
        torch.cuda.synchronize()
        dilated_unit.launches = dilated_unit.launches_bf16 = 0
        y = model(x, draws)
        torch.cuda.synchronize()
        launches = dilated_unit.launches
        check(tuple(y.shape) == (BATCH, 1, N_SIGNAL) and bool(torch.isfinite(y).all()),
              f"discrete forward {tuple(y.shape)} or not finite")
        check(launches == 22 and dilated_unit.launches_bf16 == 0,
              f"{launches} launches ({dilated_unit.launches_bf16} bf16) in a discrete forward")
        t0 = time.perf_counter()
        for _ in range(5):
            model(x, draws)
        torch.cuda.synchronize()
        sec = (time.perf_counter() - t0) / 5

        n = 65536
        xb = torch.randn(1, 1, n, generator=torch.Generator().manual_seed(2)) * 0.1
        z_cpu = cpu_model.encode(xb)
        codes = check_codes(model.encoder.rvq, cpu_model.encoder.rvq, model.encode(xb.cuda()),
                            z_cpu, "discrete")
        idx_cpu = cpu_model.encoder.encode_indices(z_cpu)
        noise = torch.randn(1, cfg.latent.noise_augmentation, z_cpu.shape[-1],
                            generator=torch.Generator().manual_seed(3))
        decode = lambda m, dev: m.decode(torch.cat(  # noqa: E731
            [m.encoder.decode_indices(idx_cpu.to(dev)), noise.to(dev)], 1))
        y_err = rel_err(decode(model, "cuda").cpu(), decode(cpu_model, "cpu"))
    check(y_err <= MODEL_TOL, f"discrete card vs CPU: decode of one index tensor {y_err:.3e}")
    return {"launches": launches, "forward_ms": sec * 1e3,
            "realtime_factor": BATCH * N_SIGNAL / SAMPLE_RATE / sec, **codes,
            "decode_rel_err": y_err}


def _discrete_steps(cfg) -> dict:
    """The k-means step (timed alone), pre-warmup steps, then steps picked by
    pick_phase past the warmup, at B=8 x 131072 on the card: 22 launches per
    step, finite losses, codebooks initialized once and updated by every
    program; codebook_health after."""
    import torch

    from rave_tpu_torch.ops.kernels import dilated_unit
    from rave_tpu_torch.train.analysis import crop_frames, receptive_field
    from rave_tpu_torch.train.loop import codebook_health
    from rave_tpu_torch.train.state import create_train_state
    from rave_tpu_torch.train.steps import build_train_steps, pick_phase

    rf = receptive_field(cfg, device="cuda")
    steps = build_train_steps(cfg, crop_frames(cfg, rf))
    state = create_train_state(cfg, seed=0, device="cuda")
    x = torch.randn(cfg.data.batch, 1, cfg.data.n_signal, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(6)) * 0.1
    noise = torch.Generator(device="cuda").manual_seed(7)
    codebooks = [m.codebook for m in state.model.encoder.rvq.vq]
    times, launches = {"kmeans": [], "gen_prewarmup": [], "gen_adversarial": [], "dis": []}, 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def one_step(name: str, which: str, warmed: bool, quantize: bool) -> None:
        nonlocal launches
        before = [cb.embed.clone() for cb in codebooks]
        torch.cuda.synchronize()
        dilated_unit.launches = dilated_unit.launches_bf16 = 0
        t0 = time.perf_counter()
        if which == "dis":
            m = steps["dis"](state, x, generator=noise, quantize=quantize)
        else:
            m = steps["gen"](state, x, warmed, generator=noise, quantize=quantize)
        torch.cuda.synchronize()
        times[name].append(time.perf_counter() - t0)
        check(dilated_unit.launches == 22 and dilated_unit.launches_bf16 == 0,
              f"discrete {name} step: {dilated_unit.launches} launches, expected 22 fp32")
        launches += 22
        bad = [k for k, v in m.items() if not math.isfinite(float(v))]
        check(not bad, f"discrete {name} step: non-finite {bad}")
        check(all(not torch.equal(cb.embed, b) for cb, b in zip(codebooks, before))
              and all(float(cb.inited) == 1.0 for cb in codebooks),
              f"discrete {name} step left a codebook as it was")

    check(rf == (0, 0), f"discrete receptive field {rf}, expected (0, 0) as in JAX")
    one_step("kmeans", "gen", False, True)
    for _ in range(DISCRETE_PREWARMUP_STEPS):
        one_step("gen_prewarmup", "gen", False, True)
    state.step = cfg.train.phase_1_duration
    for _ in range(DISCRETE_WARMED_STEPS):
        which, warmed, quantize = pick_phase(cfg, state.step)
        one_step("dis" if which == "dis" else "gen_adversarial", which, warmed, quantize)
    perplexity, usage = codebook_health(state.model)
    check(math.isfinite(perplexity) and perplexity > 1 and 0 < usage <= 1,
          f"codebook health {perplexity}, {usage}")
    ms = {k: statistics.mean(v[1:] if k != "kmeans" and len(v) > 1 else v) * 1e3
          for k, v in times.items()}
    return {"rf": list(rf), "ms_per_step": ms, "steps": {k: len(v) for k, v in times.items()},
            "step_ms": {k: [t * 1e3 for t in v] for k, v in times.items()},
            "launches": launches, "peak_gb": torch.cuda.max_memory_allocated() / 2**30,
            "codebook_perplexity": perplexity, "codebook_usage": usage}


def _discrete_loop(cfg, work: Path, db: Path) -> dict:
    """`cli train --config discrete` on phase `loop`'s store, resumed once
    (the restored state, codebooks and `inited` included, bit-equal to its
    checkpoint; no second k-means), then `cli eval`."""
    import torch

    from rave_tpu_torch.utils import checkpoint

    common = ["--config", "discrete", "--db_path", db, "--out_path", work / "runs", "--batch",
              TRAIN_BATCH, "--n_signal", N_SIGNAL, "--device", "cuda", "--val_every",
              DISCRETE_VAL_EVERY, "--save_every", 1000, "--device_data", "on", "--name", "d"]
    for o in DISCRETE_LOOP:
        common += ["--override", o]
    with LoopProbe() as probe:
        out = _cli(["train", "--max_steps", DISCRETE_LOOP_STEPS, *common])
        run_dir = Path(out.strip().splitlines()[-1].removeprefix("run dir: "))
        first = probe.take()
        out2 = _cli(["train", "--max_steps", DISCRETE_RESUME_STEPS, *common])
        resumed = probe.take()
    before = LoopProbe.counts()
    ev = json.loads(_cli(["eval", "--run", run_dir, "--db_path", db, "--split", "val",
                          "--device", "cuda"]).strip().splitlines()[-1])
    ev["fp32"] = LoopProbe.counts()[0] - before[0]
    _check_steps(first, "fp32", 0, DISCRETE_LOOP_STEPS, probe=False)
    _check_steps(resumed, "fp32", DISCRETE_LOOP_STEPS, DISCRETE_RESUME_STEPS, probe=False)
    check(f"resumed at step {DISCRETE_LOOP_STEPS}" in out2, "the discrete run did not resume")
    phases = {e["phase"] for e in first if e["kind"] == "step"}
    check(phases == {"gen_prewarmup", "gen_adversarial", "dis"}, f"discrete phases {phases}")
    restores = [e for e in resumed if e["kind"] == "restore" and "state" in e]
    check(len(restores) == 1, f"discrete restores {len(restores)}")
    saved = torch.load(restores[0]["path"], map_location="cpu", weights_only=True)
    bad = unequal(restores[0]["state"], saved)
    inited = [k for k in saved["model"] if k.endswith("inited")]
    check(not bad and len(inited) == cfg.latent.num_quantizers
          and all(float(saved["model"][k]) == 1.0 for k in inited),
          f"discrete restore not bit-equal ({bad[:5]}) or codebooks not initialized")
    rows = [json.loads(r) for r in (run_dir / "metrics.jsonl").read_text().splitlines()]
    health = [r for r in rows if "codebook_perplexity" in r]
    check([r["step"] for r in health] == [3, 6, 8], f"codebook health rows {health}")
    check(all(math.isfinite(ev[k]) for k in EVAL_METRICS) and ev["fp32"] == 22 * ev["n_batches"],
          f"discrete eval {ev}")
    ckpts = [checkpoint.checkpoint_step(p) for p in checkpoint.list_checkpoints(str(run_dir))]
    return {"run_dir": run_dir, "checkpoints": ckpts, "eval": ev, "codebook_health": health,
            "launches": sum(e["fp32"] for e in first + resumed) + ev["fp32"],
            "step_ms": loop_ms(first + resumed)}


def _discrete_export(cfg, run_dir: Path, work: Path) -> dict:
    """`cli export --streaming` of the loop's run and `cli generate` of a 30 s
    file; the card against the CPU (codes agree, one index tensor decodes
    alike); `forward_step.pt2` bit-equal to the eager steps over 32 blocks;
    the streaming p50 against the block's budget."""
    import torch

    from rave_tpu_torch.data.audio_io import decode_file
    from rave_tpu_torch.export.artifact import ExportedRAVE
    from rave_tpu_torch.export.generate import load_signal
    from rave_tpu_torch.ops.kernels import dilated_unit

    t0 = time.perf_counter()
    text = _cli(["export", "--run", run_dir, "--streaming", "--output", work / "export",
                 "--device", "cuda"])
    export_s = time.perf_counter() - t0
    path = Path(text.strip().splitlines()[-1].removeprefix("exported: "))
    manifest = json.loads((path / "manifest.json").read_text())
    want = (cfg.latent.num_quantizers, cfg.augmented_latent_size(), cfg.block_size())
    got = tuple(manifest[k] for k in ("latent_size", "full_latent_size", "block_size"))
    check(got == want, f"discrete manifest: latent, full latent, block {got}, expected {want}")
    wav = work / "discrete_in.wav"
    n = write_signal(wav, EXPORT_SECONDS, seed=22)
    torch.cuda.synchronize()
    dilated_unit.launches = dilated_unit.launches_bf16 = 0
    t0 = time.perf_counter()
    _cli(["generate", "--model", path, "--input", wav, "--out_path", work / "generated",
          "--device", "cuda"])
    torch.cuda.synchronize()
    generate_s, launches = time.perf_counter() - t0, dilated_unit.launches
    check(launches == 22, f"discrete generate: {launches} launches, expected 22")

    art, cpu = ExportedRAVE(str(path), device="cuda"), ExportedRAVE(str(path), device="cpu")
    B = art.block_size
    x = load_signal(decode_file(str(wav), SAMPLE_RATE, 1), 1, 1, B).cuda()
    clip = x[..., : -(-int(CLIP_SECONDS * SAMPLE_RATE) // B) * B]
    with torch.inference_mode():
        codes = check_codes(art.model.encoder.rvq, cpu.model.encoder.rvq,
                            art.model.encode(clip), cpu.model.encode(clip.cpu()),
                            "discrete artifact")
    idx_cpu = cpu.encode(clip.cpu(), seed=3)
    y_err = rel_err(art.decode(idx_cpu.cuda(), seed=4).cpu(), cpu.decode(idx_cpu, seed=4))
    check(y_err <= MODEL_TOL, f"discrete artifact card vs CPU: decode {y_err:.3e}")

    program = art.load_program("forward")
    art.reset_stream()
    state = [s.clone() for s in art.state]
    eager_ms, program_ms, equal = [], [], True
    for i in range(PROGRAM_BLOCKS):
        xb = x[..., i * B:(i + 1) * B]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y_e = art.forward(xb, streaming=True, seed=2000 + i)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        y_p, state = program(state, xb, torch.tensor(2000 + i, device="cuda"))
        torch.cuda.synchronize()
        eager_ms.append((t1 - t0) * 1e3)
        program_ms.append((time.perf_counter() - t1) * 1e3)
        equal = equal and torch.equal(y_p, y_e) and all(
            torch.equal(a, b) for a, b in zip(state, art.state))
    check(equal, f"discrete forward_step.pt2 not bit-equal to the eager steps over "
                 f"{PROGRAM_BLOCKS} blocks")
    return {"export_s": export_s, "generate_s": generate_s, "generate_launches": launches,
            "realtime_factor_generate": n / SAMPLE_RATE / generate_s, **codes,
            "decode_rel_err": y_err, "program_bit_equal": equal,
            "block_ms_p50": {"eager": statistics.median(eager_ms),
                             "program": statistics.median(program_ms)},
            "block_budget_ms": B / SAMPLE_RATE * 1e3}


def _other_family(names) -> dict:
    """One generator step of `names` at B=8 x 131072 on the card (22
    launches, finite), its first pre-warmup step at B=1 on the card against
    the CPU, and the artifact's codec halves (`EncodeSide`, `DecodeSide`)
    of the stepped model, offline, on the card against the CPU. Phase
    `discrete`'s export checks `export_model` and the `.pt2` programs."""
    import torch

    from rave_tpu_torch.config import compose
    from rave_tpu_torch.export.artifact import DecodeSide, EncodeSide
    from rave_tpu_torch.export.export import user_latent_size
    from rave_tpu_torch.ops.kernels import dilated_unit
    from rave_tpu_torch.train.state import create_train_state
    from rave_tpu_torch.train.steps import build_train_steps

    cfg = compose(names)
    state = create_train_state(cfg, seed=0, device="cuda")
    x = torch.randn(cfg.data.batch, 1, cfg.data.n_signal, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(6)) * 0.1
    step = build_train_steps(cfg)["gen"]
    step(state, x, False, generator=torch.Generator(device="cuda").manual_seed(7))  # warm
    torch.cuda.synchronize()
    dilated_unit.launches = dilated_unit.launches_bf16 = 0
    t0 = time.perf_counter()
    m = step(state, x, False, generator=torch.Generator(device="cuda").manual_seed(8))
    torch.cuda.synchronize()
    ms, launches = (time.perf_counter() - t0) * 1e3, dilated_unit.launches
    check(launches == 22 and all(math.isfinite(float(v)) for v in m.values()),
          f"{cfg.latent.family} step: {launches} launches, metrics {m}")
    b1 = _family_step_b1(names, "gen", False)
    loss_err = _loss_err(b1["cuda"], b1["cpu"])
    latent_size = user_latent_size(cfg, None, 0.0)
    gpu = state.model.eval()
    cpu = copy.deepcopy(gpu).cpu()
    clip = torch.randn(1, 1, 16 * cfg.block_size(), generator=torch.Generator().manual_seed(5))
    clip = clip * 0.1
    seeds = {dev: (torch.tensor(1, device=dev), torch.tensor(2, device=dev))
             for dev in ("cuda", "cpu")}
    with torch.inference_mode():
        z_gpu = EncodeSide(gpu, cfg, latent_size)(clip.cuda(), seeds["cuda"][0]).cpu()
        z_cpu = EncodeSide(cpu, cfg, latent_size)(clip, seeds["cpu"][0])
        y_gpu = DecodeSide(gpu, cfg, latent_size)(z_cpu.cuda(), seeds["cuda"][1]).cpu()
        y_cpu = DecodeSide(cpu, cfg, latent_size)(z_cpu, seeds["cpu"][1])
    errs = {"encode": rel_err(z_gpu, z_cpu), "decode": rel_err(y_gpu, y_cpu)}
    check(loss_err <= MODEL_TOL and max(errs.values()) <= MODEL_TOL
          and z_gpu.shape[1] == latent_size and bool(torch.isfinite(y_gpu).all()),
          f"{cfg.latent.family} card vs CPU: step losses {loss_err:.3e}, codec {errs}, "
          f"latents {tuple(z_gpu.shape)}")
    return {"step_ms": ms, "launches": launches, "b1_loss_rel_err": loss_err,
            "codec_rel_err": errs, "latent_size": latent_size}


def phase_discrete() -> dict:
    """compose(["discrete"]) at full width; see the module docstring."""
    import torch

    from rave_tpu_torch.config import compose

    t_phase = time.perf_counter()
    work = ROOT / "build" / "discrete"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    cfg = compose(["discrete"])
    gen = torch.Generator(device="cuda").manual_seed(40)
    kernel_rows = [kernel_row(gen, "discrete", B, C, T, d, "centered")
                   for B in (BATCH, TRAIN_BATCH) for C, T, dils in DISCRETE_UNITS for d in dils]
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    offline = timed("offline", _discrete_offline, cfg)
    train = timed("steps", _discrete_steps, cfg)
    b1 = timed("b1_card_vs_cpu", lambda: {
        k: _family_step_b1(["discrete"], which, warmed)
        for k, which, warmed in (("gen_prewarmup", "gen", False),
                                 ("gen_adversarial", "gen", True), ("dis", "dis", True))})
    b1_err = {k: _loss_err(v["cuda"], v["cpu"]) for k, v in b1.items()}
    check(max(b1_err.values()) <= MODEL_TOL, f"discrete B=1 card vs CPU losses {b1_err}")
    loop = timed("loop", _discrete_loop, cfg, work, ROOT / "build" / "loop" / "db")
    export = timed("export", _discrete_export, cfg, loop["run_dir"], work)
    others = {names[-1]: timed(names[-1], _other_family, names)
              for names in (["v2", "wasserstein"], ["v2", "spherical"])}
    shutil.rmtree(work, ignore_errors=True)
    launches = offline["launches"] + train["launches"] + loop["launches"] + \
        export["generate_launches"] + sum(o["launches"] for o in others.values())
    out = {"kernel_rows": kernel_rows, "offline": offline, "train": train,
           "b1_loss_rel_err": b1_err, "loop": {k: v for k, v in loop.items() if k != "run_dir"},
           "export": export, "others": others, "launches": launches, "part_seconds": seconds,
           "seconds": time.perf_counter() - t_phase}
    print(f"discrete: units at C=768 T=256 kernel/plain ms {shape_summary(kernel_rows)} (max rel "
          f"err {max(r['rel_err'] for r in kernel_rows):.2e} <= {KERNEL_TOL}); forward B={BATCH} x "
          f"{N_SIGNAL} {offline['forward_ms']:.2f} ms = {offline['realtime_factor']:.1f}x "
          f"realtime, 22 launches; B=1 x 65536 card vs CPU: {codes_summary(offline)}, decode "
          f"{offline['decode_rel_err']:.2e}",
          flush=True)
    print(f"discrete steps B={TRAIN_BATCH} x {N_SIGNAL}: ms "
          + ", ".join(f"{k} {v:.1f} (x{train['steps'][k]})"
                      for k, v in train["ms_per_step"].items())
          + " (each: " + "; ".join(f"{k} " + ", ".join(f"{t:.1f}" for t in v)
                                   for k, v in train["step_ms"].items()) + ")"
          + f"; peak {train['peak_gb']:.2f} GiB; codebook perplexity "
          f"{train['codebook_perplexity']:.1f}, usage {train['codebook_usage']:.3f}; B=1 card vs "
          f"CPU losses " + ", ".join(f"{k} {v:.1e}" for k, v in b1_err.items())
          + f"; loop {DISCRETE_LOOP_STEPS} steps resumed to {DISCRETE_RESUME_STEPS} bit-equal "
          f"(codebooks, inited), checkpoints {loop['checkpoints']}, eval "
          f"{loop['eval']['spectral_distance']}", flush=True)
    print(f"discrete export: {export['export_s']:.1f} s; generate 30 s "
          f"{export['realtime_factor_generate']:.1f}x end to end, 22 launches; artifact card vs "
          f"CPU {codes_summary(export)}, decode {export['decode_rel_err']:.2e}"
          f"; forward_step.pt2 bit-equal over {PROGRAM_BLOCKS} blocks; streaming p50 eager "
          f"{export['block_ms_p50']['eager']:.3f} ms, .pt2 {export['block_ms_p50']['program']:.3f}"
          f" ms (budget {export['block_budget_ms']:.2f} ms); "
          + "; ".join(f"{k}: step {o['step_ms']:.1f} ms, B=1 losses {o['b1_loss_rel_err']:.1e}, "
                      f"codec {o['codec_rel_err']['encode']:.1e} / "
                      f"{o['codec_rel_err']['decode']:.1e}" for k, o in others.items())
          + f"; {launches} launches on the path; phase {out['seconds']:.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()) + ")", flush=True)
    return out


# the v3 phase: Snake units bypass the kernel (launches 0 everywhere on this path)
V3_PREWARMUP, V3_CYCLES = 3, 3  # steps of each precision: 3 pre-warmup, then 3 x 4 warmed
V3_LOOP = ["train.phase_1_duration=2", "train.update_discriminator_every=2", "train.ema=0.999"]
V3_LOOP_STEPS, V3_RESUME_STEPS, V3_VAL_EVERY = 4, 6, 2
V3_ADAIN_BLOCKS = 4  # streaming blocks that learn each statistic
V3_ATTRIBUTES = ["learn_target", "reset_target", "learn_source", "reset_source"]
V3_CRITIC_ITERS = 5
# a free-running AdaIN stream: the card's outputs with cuDNN off no further from a float64
# run of its own fixed kernels than this many times the CPU's from its own (0.14-1.34x
# read on an NVIDIA H100), or than FREE_FLOOR where both are at float32's rounding; the
# served stream's error over the later half of the transfer's read blocks no more than
# this many times its earlier half's (PERF.md section 6)
FREE_DRIFT, FREE_FLOOR = 3.0, 1e-5
# the transfer's blocks read for growth: those past the stream's reach (the receptive
# field's left side plus the delay), which see only transferred input
V3_READ_BLOCKS = 8


def learn_adain(model, cfg, target, source) -> None:
    """AdaIN's statistics learned as an artifact's `set_learn_target` /
    `set_learn_source` learn them: `target`, then `source` ([1, 1, n *
    block] waveforms) streamed through the model with the flag of each on;
    learning off after, so that in eval mode the transfer acts."""
    import torch

    from rave_tpu_torch.models.blocks import AdaIN
    from rave_tpu_torch.nn.streaming import init_stream_state

    adains = [m for m in model.modules() if isinstance(m, AdaIN)]
    block = cfg.block_size()
    with torch.no_grad():
        for side, clip in (("y", target), ("x", source)):
            for m in adains:
                setattr(m, f"learn_{side}", torch.ones_like(m.learn_y))
                m.learning = True
            init_stream_state(model, 1)
            for i in range(0, clip.shape[-1], block):
                z = model.step_encode(clip[..., i:i + block])
                model.step_decode(z[:, :cfg.latent_size])
            for m in adains:
                setattr(m, f"learn_{side}", torch.zeros_like(m.learn_y))
                m.learning = False
    init_stream_state(model, 1)


def as_float64(art):
    """An `ExportedRAVE` turned into float64: its model, its codec halves
    (which hold the latent PCA) and its state."""
    for module in (art.model, art.encode_side, art.decode_side):
        module.double()
    art.state = [s.double() if s.is_floating_point() else s for s in art.state]
    return art


def float64_twin(art, device: str = "cpu"):
    """`art` in float64 on `device`, with `art`'s own fixed kernels: each
    device fixes them from (v, g) in its own float32 arithmetic
    (`freeze_weights`), so the card's and the CPU's differ in the last bits."""
    from rave_tpu_torch.export.artifact import ExportedRAVE

    twin = ExportedRAVE(str(art.path), device=device)
    twin.model.load_state_dict({k: v.to(device) for k, v in art.model.state_dict().items()})
    return as_float64(twin)


def adain_stream(art, segments: dict, seed0: int = 500, seeds=None) -> dict:
    """The AdaIN attributes driven free over one stream from a fresh state,
    as a live user drives them: `segments` {"learn_target", "learn_source",
    "transfer"} ([1, 1, n * block], on the artifact's device and dtype) go
    through `forward(streaming=True)` block by block, learning the target,
    then the source, then transferring, the i-th block of the stream with
    seed `seeds[i]` (default seed0 + i): {segment: outputs} and the AdaIN
    state after, each flat on the CPU in float64."""
    import torch

    B, i = art.block_size, 0
    art.reset_target()
    art.reset_source()
    art.reset_stream()
    out = {}
    for name, flags in (("learn_target", (True, False)), ("learn_source", (False, True)),
                        ("transfer", (False, False))):
        art.set_learn_target(flags[0])
        art.set_learn_source(flags[1])
        ys, signal = [], segments[name]
        for t in range(0, signal.shape[-1], B):
            seed = seed0 + i if seeds is None else seeds[i]
            ys.append(art.forward(signal[..., t:t + B], streaming=True, seed=seed).cpu())
            i += 1
        out[name] = torch.cat(ys, -1).double().reshape(-1)
    out["adain_state"] = torch.cat([art.state[j].cpu().double().reshape(-1)
                                    for j in art.adain_indices])
    return out


def _v3_offline(cfg) -> dict:
    """B=16 x 131072 forwards (timed; training mode: AdaIN keeps statistics
    for 8 batch slots, as JAX's and the reference's, so an eval batch holds
    at most 8) and B=8 in eval mode with AdaIN's statistics learned from a
    seeded target and source (timed); no unit launch in either; at B=1 x
    65536 in eval mode the card against the CPU, and the transfer acting
    (training mode differs)."""
    import torch

    from rave_tpu_torch.factory import build_rave
    from rave_tpu_torch.ops.kernels import dilated_unit
    from rave_tpu_torch.train.steps import draw_noise

    cpu_model = build_rave(cfg, seed=0, device="cpu")
    clips = torch.randn(2, 1, 1, V3_ADAIN_BLOCKS * cfg.block_size(),
                        generator=torch.Generator().manual_seed(30))
    learn_adain(cpu_model, cfg, clips[0] * 0.03, clips[1] * 0.2)
    model = copy.deepcopy(cpu_model).cuda()
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(BATCH, 1, N_SIGNAL, device="cuda", generator=gen) * 0.1
    draws = draw_noise(cfg, x, gen)
    out = {}
    with torch.inference_mode():
        for mode, b in (("train", BATCH), ("eval", TRAIN_BATCH)):
            model.train(mode == "train")
            xb, db = x[:b], draws.to("cuda")
            db.eps = db.eps[:b]
            model(xb, db)  # warm
            torch.cuda.synchronize()
            dilated_unit.launches = dilated_unit.launches_bf16 = 0
            y = model(xb, db)
            torch.cuda.synchronize()
            launches = dilated_unit.launches
            check(tuple(y.shape) == (b, 1, N_SIGNAL) and bool(torch.isfinite(y).all())
                  and launches == 0 and dilated_unit.launches_bf16 == 0,
                  f"v3 {mode} forward {tuple(y.shape)}, {launches} unit launches (expected 0)")
            t0 = time.perf_counter()
            for _ in range(5):
                model(xb, db)
            torch.cuda.synchronize()
            sec = (time.perf_counter() - t0) / 5
            out[mode] = {"batch": b, "launches": launches, "forward_ms": sec * 1e3,
                         "realtime_factor": b * N_SIGNAL / SAMPLE_RATE / sec}
        n = 65536
        xb = torch.randn(1, 1, n, generator=torch.Generator().manual_seed(2)) * 0.1
        eb = draw_noise(cfg, xb, torch.Generator().manual_seed(3))
        model.eval(), cpu_model.eval()
        y_cpu, y_gpu = cpu_model(xb, eb), model(xb.cuda(), eb.to("cuda")).cpu()
        err = rel_err(y_gpu, y_cpu)
        transfer = rel_err(model.train()(xb.cuda(), eb.to("cuda")).cpu(), y_gpu)
    check(err <= MODEL_TOL and transfer > 1e-2,
          f"v3 B=1 eval card vs CPU {err:.3e} (<= {MODEL_TOL}); training mode differs by "
          f"{transfer:.3e} (> 1e-2: AdaIN's transfer acts in eval mode)")
    return {**out, "b1_rel_err": err, "transfer_rel_change": transfer}


def _critic_ms(cfg) -> dict:
    """The descript critic alone, forward and backward on the 16-row real+fake
    batch of a B=8 step, device ms by CUDA events (`cuda_ms`): whole, its
    MPDs and its MRDs (the parts on the critic's normalized input)."""
    import torch

    from rave_tpu_torch.factory import build_discriminator

    critic = build_discriminator(cfg, seed=1, device="cuda")
    xy = torch.randn(2 * TRAIN_BATCH, 1, N_SIGNAL, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(4)) * 0.1
    xn = xy - xy.mean(-1, keepdim=True)
    xn = 0.8 * xn / (xn.abs().amax(-1, keepdim=True) + 1e-9)
    mpds = [m for n, m in critic.named_children() if n.startswith("mpd")]
    mrds = [m for n, m in critic.named_children() if n.startswith("mrd")]

    def fwd_bwd(feature_lists):
        def run():
            critic.zero_grad(set_to_none=True)
            sum(fm[-1].mean() for fm in feature_lists()).backward()
        return run

    return {"all": cuda_ms(fwd_bwd(lambda: critic(xy)), V3_CRITIC_ITERS),
            "mpd": cuda_ms(fwd_bwd(lambda: [m(xn) for m in mpds]), V3_CRITIC_ITERS),
            "mrd": cuda_ms(fwd_bwd(lambda: [m(xn) for m in mrds]), V3_CRITIC_ITERS)}


def _v3_steps(cfg) -> dict:
    """The receptive-field probe, then fp32 and `train.bf16` + `bf16_dis`
    steps of the three programs at B=8 x 131072 (`_train_run`, no unit
    launch), the first step of each program at B=1 on the card against the
    CPU, and the critic's fwd+bwd split."""
    import torch

    from rave_tpu_torch.config import compose
    from rave_tpu_torch.ops.kernels import dilated_unit
    from rave_tpu_torch.train.analysis import crop_frames, receptive_field

    dilated_unit.launches = dilated_unit.launches_bf16 = 0
    rf = receptive_field(cfg, device="cuda")
    check(dilated_unit.launches == 0, f"v3 receptive-field probe: {dilated_unit.launches} launches")
    crop = crop_frames(cfg, rf)
    x = torch.randn(TRAIN_BATCH, 1, N_SIGNAL, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(6)) * 0.1
    runs = {}
    for kind, extra in (("fp32", []), ("bf16", ["train.bf16=true", "train.bf16_dis=true"])):
        runs[kind] = _train_run(compose(["v3"], extra), crop, x, bf16=kind == "bf16",
                                per_step=0, prewarmup=V3_PREWARMUP, cycles=V3_CYCLES)
    b1 = {k: _family_step_b1(["v3"], which, warmed)
          for k, which, warmed in (("gen_prewarmup", "gen", False),
                                   ("gen_adversarial", "gen", True), ("dis", "dis", True))}
    b1_err = {k: _loss_err(v["cuda"], v["cpu"]) for k, v in b1.items()}
    check(max(b1_err.values()) <= MODEL_TOL, f"v3 B=1 card vs CPU losses {b1_err}")
    return {"rf": list(rf), "crop_frames": list(crop), "runs": runs, "b1_loss_rel_err": b1_err,
            "critic_fwd_bwd_ms": _critic_ms(cfg)}


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms, no autotuning; both put back on exit."""
    import torch

    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


def _v3_loop(work: Path, db: Path) -> dict:
    """`cli train --config v3` on phase `loop`'s store: a short warmup and a
    critic step every other step, validation every other step, resumed once
    (the restored state, AdaIN's buffers included, bit-equal to its
    checkpoint); `cli eval` twice, equal. AdaIN's calls are recorded with the
    model's mode: training in the steps, eval in validation, eval and the
    probe."""
    import collections

    import torch

    from rave_tpu_torch.models.blocks import AdaIN
    from rave_tpu_torch.train import loop
    from rave_tpu_torch.utils import checkpoint

    common = ["--config", "v3", "--db_path", db, "--out_path", work / "runs", "--batch",
              TRAIN_BATCH, "--n_signal", N_SIGNAL, "--device", "cuda", "--val_every",
              V3_VAL_EVERY, "--save_every", 1000, "--device_data", "on", "--name", "v3"]
    for o in V3_LOOP:
        common += ["--override", o]
    modes, where = collections.Counter(), ["step"]
    forward = AdaIN.forward

    def recorded(self, x):
        modes[(where[-1], "train" if self.training else "eval")] += 1
        return forward(self, x)

    def labelled(label, fn):
        def call(*args, **kwargs):
            where.append(label)
            try:
                return fn(*args, **kwargs)
            finally:
                where.pop()
        return call

    AdaIN.forward = recorded
    try:
        # deterministic cuDNN: one tree trains one set of weights, and phase v3's
        # free-running drift check reads one ratio (ROADMAP C15)
        with LoopProbe() as probe, deterministic_cudnn():
            loop.run_validation = labelled("validation", loop.run_validation)
            loop.receptive_field = labelled("probe", loop.receptive_field)
            out = _cli(["train", "--max_steps", V3_LOOP_STEPS, *common])
            run_dir = Path(out.strip().splitlines()[-1].removeprefix("run dir: "))
            first = probe.take()
            out2 = _cli(["train", "--max_steps", V3_RESUME_STEPS, *common])
            resumed = probe.take()
        before = LoopProbe.counts()
        where.append("eval")
        evals = [json.loads(_cli(["eval", "--run", run_dir, "--db_path", db, "--split", "val",
                                  "--device", "cuda"]).strip().splitlines()[-1])
                 for _ in range(2)]
    finally:
        AdaIN.forward = forward
    eval_launches = LoopProbe.counts()[0] - before[0]
    _check_steps(first, "fp32", 0, V3_LOOP_STEPS, per_step=0)
    _check_steps(resumed, "fp32", V3_LOOP_STEPS, V3_RESUME_STEPS, per_step=0)
    check(f"resumed at step {V3_LOOP_STEPS}" in out2, "the v3 run did not resume")
    phases = {e["phase"] for e in first if e["kind"] == "step"}
    check(phases == {"gen_prewarmup", "gen_adversarial", "dis"}, f"v3 phases {phases}")
    check(modes[("step", "eval")] == 0 and modes[("step", "train")] > 0
          and modes[("validation", "train")] == 0 and modes[("validation", "eval")] > 0
          and modes[("eval", "train")] == 0 and modes[("eval", "eval")] > 0
          and modes[("probe", "train")] == 0, f"AdaIN calls by (where, mode): {dict(modes)}")
    restores = [e for e in resumed if e["kind"] == "restore" and "state" in e]
    check(len(restores) == 1, f"v3 restores {len(restores)}")
    saved = torch.load(restores[0]["path"], map_location="cpu", weights_only=True)
    bad = unequal(restores[0]["state"], saved)
    adain = [k for k in saved["model"] if k.rsplit(".", 1)[-1] in AdaIN.STATE]
    check(not bad and len(adain) == 22 * len(AdaIN.STATE),
          f"v3 restore not bit-equal ({bad[:5]}) or {len(adain)} AdaIN buffers")
    check(evals[0] == evals[1] and all(math.isfinite(evals[0][k]) for k in EVAL_METRICS)
          and eval_launches == 0, f"v3 eval {evals} ({eval_launches} launches)")
    ckpts = [checkpoint.checkpoint_step(p) for p in checkpoint.list_checkpoints(str(run_dir))]
    return {"run_dir": run_dir, "checkpoints": ckpts, "eval": evals[0],
            "adain_calls": {f"{k[0]}/{k[1]}": v for k, v in modes.items()},
            "launches": sum(e["fp32"] + e["bf16"] for e in first + resumed) + eval_launches,
            "step_ms": loop_ms(first + resumed),
            "validation_ms": [e["ms"] for e in first + resumed if e["kind"] == "validation"],
            "save_s": [e["ms"] / 1e3 for e in first + resumed if e["kind"] == "save"]}


def _v3_export(run_dir: Path, work: Path) -> dict:
    """`cli export --streaming` of the loop's run and `cli generate` of a 30 s
    file; the AdaIN attributes driven on the artifact on the card and on the
    CPU alike (learn a target, learn a source, transfer; each call on the
    card from the CPU's state, against the CPU's call); the
    `.pt2` forward bit-equal to the eager steps over 32 blocks while the
    target learns, AdaIN's state included; the resets bring the identity
    back; the streaming p50 against the block's budget."""
    import torch

    from rave_tpu_torch.data.audio_io import decode_file
    from rave_tpu_torch.export.artifact import ExportedRAVE
    from rave_tpu_torch.export.generate import load_signal
    from rave_tpu_torch.ops.kernels import dilated_unit
    from rave_tpu_torch.train.analysis import receptive_field

    t0 = time.perf_counter()
    text = _cli(["export", "--run", run_dir, "--streaming", "--output", work / "export",
                 "--device", "cuda"])
    export_s = time.perf_counter() - t0
    path = Path(text.strip().splitlines()[-1].removeprefix("exported: "))
    manifest = json.loads((path / "manifest.json").read_text())
    leaves = manifest["aot"]["forward_step"]["state_leaves"]
    check(manifest["attributes"] == V3_ATTRIBUTES and all(
        sum(n.endswith(op["leaf"]) for n in leaves) == 22
        for ops in manifest["attribute_ops"].values() for op in ops),
        f"v3 manifest attributes {manifest['attributes']}, ops {manifest['attribute_ops']}")
    wav = work / "v3_in.wav"
    n = write_signal(wav, EXPORT_SECONDS, seed=23)
    torch.cuda.synchronize()
    dilated_unit.launches = dilated_unit.launches_bf16 = 0
    t0 = time.perf_counter()
    _cli(["generate", "--model", path, "--input", wav, "--out_path", work / "generated",
          "--device", "cuda"])
    torch.cuda.synchronize()
    generate_s, launches = time.perf_counter() - t0, dilated_unit.launches
    check(launches == 0, f"v3 generate: {launches} unit launches, expected 0")

    art, cpu = ExportedRAVE(str(path), device="cuda"), ExportedRAVE(str(path), device="cpu")
    B = art.block_size
    x = load_signal(decode_file(str(wav), SAMPLE_RATE, 1), 1, 1, B).cuda()
    k = V3_ADAIN_BLOCKS * B
    target, source, clip = x[..., :k] * 0.3, x[..., k:2 * k], x[..., 2 * k:4 * k]
    identity = art.forward(clip, seed=3)

    # Each call on the card starts from the CPU artifact's state, so that the
    # card is held to the CPU call by call at 1e-3: in a free-running stream
    # each device learns its own statistics, which the transfer divides by;
    # that stream is held below against float64 runs
    def same_state():
        art.state = [s.to("cuda") for s in cpu.state]

    def adain_err():
        return rel_err(torch.cat([art.state[i].cpu().reshape(-1) for i in art.adain_indices]),
                       torch.cat([cpu.state[i].reshape(-1) for i in cpu.adain_indices]),
                       1e-6)

    def stream(signal, seed0):
        y_err = state_err = 0.0
        for i in range(0, signal.shape[-1], B):
            same_state()
            y_gpu = art.forward(signal[..., i:i + B], streaming=True, seed=seed0 + i).cpu()
            y_cpu = cpu.forward(signal[..., i:i + B].cpu(), streaming=True, seed=seed0 + i)
            y_err, state_err = max(y_err, rel_err(y_gpu, y_cpu)), max(state_err, adain_err())
        return {"y": y_err, "adain_state": state_err}

    errs = {}
    for a in (art, cpu):
        a.set_learn_target(True)
    errs["learn_target"] = stream(target, 100)
    for a in (art, cpu):
        a.set_learn_target(False)
        a.set_learn_source(True)
    errs["learn_source"] = stream(source, 200)
    for a in (art, cpu):
        a.set_learn_source(False)
    errs["transfer_stream"] = stream(clip, 300)
    same_state()
    y_gpu = art.forward(clip, seed=3)
    errs["transfer_offline"] = {"y": rel_err(y_gpu.cpu(), cpu.forward(clip.cpu(), seed=3))}
    moved = rel_err(y_gpu, identity)
    check(max(v for e in errs.values() for v in e.values()) <= MODEL_TOL and moved > 1e-2,
          f"v3 artifact card vs CPU per call {errs} (<= {MODEL_TOL}); the transfer moved the "
          f"output {moved:.3e} (> 1e-2)")

    program = art.load_program("forward")
    art.reset_stream()
    art.set_learn_target(True)
    state = [s.clone() for s in art.state]
    eager_ms, program_ms, equal = [], [], True
    for i in range(PROGRAM_BLOCKS):
        xb = x[..., i * B:(i + 1) * B]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y_e = art.forward(xb, streaming=True, seed=2000 + i)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        y_p, state = program(state, xb, torch.tensor(2000 + i, device="cuda"))
        torch.cuda.synchronize()
        eager_ms.append((t1 - t0) * 1e3)
        program_ms.append((time.perf_counter() - t1) * 1e3)
        equal = equal and torch.equal(y_p, y_e) and all(
            torch.equal(a, b) for a, b in zip(state, art.state))
    learned = [float(art.state[i]) for i in art.adain_indices
               if art.slots[i][2] == "num_update_y"]
    check(equal and learned == [float(V3_ADAIN_BLOCKS + PROGRAM_BLOCKS)] * 22,
          f"v3 forward_step.pt2 not bit-equal to the eager steps over {PROGRAM_BLOCKS} blocks "
          f"({equal}) or the target's updates {learned[:3]}...")
    art.set_learn_target(False)
    art.reset_target()
    art.reset_source()
    back = rel_err(art.forward(clip, seed=3), identity)
    check(back <= 1e-6, f"v3 reset: offline forward {back:.3e} from the identity")

    # The same calls free-running from a fresh state, as a live user drives
    # them, each against a float64 run of its own fixed kernels on the CPU
    # (each device fixes them in float32, a few ulps apart). With cuDNN off,
    # the card's outputs no further than FREE_DRIFT x the CPU's. As the card
    # serves, with cuDNN, the transfer amplifies cuDNN's float32 rounding
    # 2-25x further than the CPU's, by the trained weights (PERF.md section
    # 6): there the error must not grow over the transfer's blocks. A block
    # output within the stream's reach of the transfer's start still sees
    # the learning segments, so the growth is read over the V3_READ_BLOCKS
    # blocks past it.
    left, _ = receptive_field(art.cfg, device="cuda")
    settle = -(-(left + manifest["latency"]["total_samples"]) // B)
    n_blocks = settle + V3_READ_BLOCKS
    transfer = x[..., 2 * k:2 * k + n_blocks * B]
    check(transfer.shape[-1] == n_blocks * B, f"v3: {x.shape[-1]} samples hold no "
                                              f"{n_blocks}-block transfer")
    segments = {"learn_target": target, "learn_source": source, "transfer": transfer}
    on_cpu = {k: v.cpu() for k, v in segments.items()}
    in_f64 = {k: v.double() for k, v in on_cpu.items()}
    ref = {"card": adain_stream(float64_twin(art), in_f64),
           "cpu": adain_stream(float64_twin(cpu), in_f64)}
    served, cpu_run = adain_stream(art, segments), adain_stream(cpu, on_cpu)
    enabled, torch.backends.cudnn.enabled = torch.backends.cudnn.enabled, False
    try:
        plain = adain_stream(art, segments)
    finally:
        torch.backends.cudnn.enabled = enabled
    drift = {k: {"card": rel_err(served[k], v), "card_cudnn_off": rel_err(plain[k], v),
                 "cpu": rel_err(cpu_run[k], ref["cpu"][k])} for k, v in ref["card"].items()}
    blocks = [rel_err(a, b) for a, b in zip(served["transfer"].reshape(n_blocks, -1),
                                            ref["card"]["transfer"].reshape(n_blocks, -1))]
    read = blocks[settle:]
    half = len(read) // 2
    drift_ratio = max(read[half:]) / max(read[:half])
    check(all(drift[k]["card_cudnn_off"] <= max(FREE_DRIFT * drift[k]["cpu"], FREE_FLOOR)
              for k in segments) and drift_ratio <= FREE_DRIFT,
          f"v3 artifact free-running from float64 {drift} (the card with cuDNN off over "
          f"{FREE_DRIFT}x the CPU?), the served transfer by block {blocks}, read past block "
          f"{settle} (grows?)")
    kernels = max(rel_err(v.cpu(), cpu.model.state_dict()[k], 1e-30)
                  for k, v in art.model.state_dict().items() if k.endswith(".w"))
    p50 = {"eager": statistics.median(eager_ms), "program": statistics.median(program_ms)}
    budget = B / SAMPLE_RATE * 1e3
    check(max(p50.values()) < budget, f"v3 streaming p50 {p50} over the {budget:.2f} ms budget")
    return {"export_s": export_s, "generate_s": generate_s, "generate_launches": launches,
            "realtime_factor_generate": n / SAMPLE_RATE / generate_s, "card_vs_cpu": errs,
            "free_stream_vs_float64": drift, "free_transfer_by_block": blocks,
            "free_transfer_settle_blocks": settle, "free_drift_ratio": drift_ratio,
            "fixed_kernels_card_vs_cpu": kernels,
            "transfer_rel_change": moved,
            "reset_rel_err": back, "program_bit_equal": equal,
            "block_ms_p50": p50, "block_budget_ms": budget}


def _v3_discrete() -> dict:
    """compose(["discrete_v3"]): the B=16 forward (timed); at B=8 x 131072 the
    k-means step apart, then one step of each program (no unit launch); the
    first step of each program at B=1 on the card against the CPU; and the
    codes of a B=1 x 65536 clip on the card against the CPU."""
    import torch

    from rave_tpu_torch.config import compose
    from rave_tpu_torch.factory import build_rave
    from rave_tpu_torch.ops.kernels import dilated_unit
    from rave_tpu_torch.train.state import create_train_state
    from rave_tpu_torch.train.steps import build_train_steps, draw_noise, pick_phase

    cfg = compose(["discrete_v3"])
    cpu_model = build_rave(cfg, seed=0, device="cpu").eval()
    model = copy.deepcopy(cpu_model).cuda()
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(BATCH, 1, N_SIGNAL, device="cuda", generator=gen) * 0.1
    draws = draw_noise(cfg, x, gen)
    with torch.inference_mode():
        model(x, draws)
        torch.cuda.synchronize()
        dilated_unit.launches = dilated_unit.launches_bf16 = 0
        t0 = time.perf_counter()
        for _ in range(5):
            y = model(x, draws)
        torch.cuda.synchronize()
        forward_s = (time.perf_counter() - t0) / 5
        launches = dilated_unit.launches
        check(tuple(y.shape) == (BATCH, 1, N_SIGNAL) and bool(torch.isfinite(y).all())
              and launches == 0, f"discrete_v3 forward {tuple(y.shape)}, {launches} launches")
        xb = torch.randn(1, 1, 65536, generator=torch.Generator().manual_seed(2)) * 0.1
        codes = check_codes(model.encoder.rvq, cpu_model.encoder.rvq, model.encode(xb.cuda()),
                            cpu_model.encode(xb), "discrete_v3")

    state = create_train_state(cfg, seed=0, device="cuda")
    steps = build_train_steps(cfg)
    xt = x[:TRAIN_BATCH]
    noise = torch.Generator(device="cuda").manual_seed(7)
    step_ms = {}
    for name in ("kmeans", "gen_prewarmup", "dis", "gen_adversarial"):
        if name == "dis":
            state.step = cfg.train.phase_1_duration
        which, warmed, quantize = pick_phase(cfg, state.step)
        check(which == ("dis" if name == "dis" else "gen"), f"discrete_v3 {name}: {which}")
        torch.cuda.synchronize()
        dilated_unit.launches = 0
        t0 = time.perf_counter()
        m = (steps["dis"](state, xt, generator=noise, quantize=quantize) if which == "dis"
             else steps["gen"](state, xt, warmed, generator=noise, quantize=quantize))
        torch.cuda.synchronize()
        step_ms[name] = (time.perf_counter() - t0) * 1e3
        check(dilated_unit.launches == 0 and all(math.isfinite(float(v)) for v in m.values()),
              f"discrete_v3 {name} step: {dilated_unit.launches} launches, metrics {m}")
    b1 = {k: _family_step_b1(["discrete_v3"], which, warmed)
          for k, which, warmed in (("gen_prewarmup", "gen", False),
                                   ("gen_adversarial", "gen", True), ("dis", "dis", True))}
    b1_err = {k: _loss_err(v["cuda"], v["cpu"]) for k, v in b1.items()}
    check(max(b1_err.values()) <= MODEL_TOL, f"discrete_v3 card vs CPU: B=1 losses {b1_err}")
    return {"forward_ms": forward_s * 1e3,
            "realtime_factor": BATCH * N_SIGNAL / SAMPLE_RATE / forward_s,
            "step_ms": step_ms, "b1_loss_rel_err": b1_err, **codes}


def phase_v3() -> dict:
    """compose(["v3"]) and compose(["discrete_v3"]) at full width; see the module docstring."""
    import torch

    from rave_tpu_torch.config import compose
    from rave_tpu_torch.ops.kernels import dilated_unit

    t_phase = time.perf_counter()
    work = ROOT / "build" / "v3"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    cfg = compose(["v3"])
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        result = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return result

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dilated_unit.launches = dilated_unit.launches_bf16 = 0
    offline = timed("offline", _v3_offline, cfg)
    train = timed("steps", _v3_steps, cfg)
    loop = timed("loop", _v3_loop, work, ROOT / "build" / "loop" / "db")
    export = timed("export", _v3_export, loop["run_dir"], work)
    discrete = timed("discrete_v3", _v3_discrete)
    shutil.rmtree(work, ignore_errors=True)
    launches = (sum(o["launches"] for o in (offline["train"], offline["eval"]))
                + sum(r["launches"] for r in train["runs"].values()) + loop["launches"]
                + export["generate_launches"])
    check(launches == 0, f"{launches} unit launches on the v3 path, expected 0")
    out = {"offline": offline, "train": train,
           "loop": {k: v for k, v in loop.items() if k != "run_dir"}, "export": export,
           "discrete_v3": discrete, "launches": launches, "part_seconds": seconds,
           "peak_gb": torch.cuda.max_memory_allocated() / 2**30,
           "seconds": time.perf_counter() - t_phase}
    runs, crit = train["runs"], train["critic_fwd_bwd_ms"]
    print(f"v3: forward B={BATCH} x {N_SIGNAL} (training mode) {offline['train']['forward_ms']:.2f}"
          f" ms = {offline['train']['realtime_factor']:.1f}x realtime, B={TRAIN_BATCH} eval with "
          f"learned AdaIN {offline['eval']['forward_ms']:.2f} ms; B=1 eval card vs CPU "
          f"{offline['b1_rel_err']:.2e}; 0 unit launches (Snake bypasses the kernel); steps "
          f"B={TRAIN_BATCH} x {N_SIGNAL} ms " + "; ".join(
              f"{kind} " + ", ".join(f"{k} {v:.1f} (x{r['steps'][k] - 1})"
                                     for k, v in r["ms_per_step"].items())
              + f", peak {r['peak_gb']:.2f} GiB" for kind, r in runs.items())
          + "; B=1 card vs CPU losses " + ", ".join(
              f"{k} {v:.1e}" for k, v in train["b1_loss_rel_err"].items())
          + f"; critic fwd+bwd (16 rows, device) {crit['all']:.2f} ms: MPDs {crit['mpd']:.2f}, "
          f"MRDs {crit['mrd']:.2f}", flush=True)
    print(f"v3 loop: {V3_LOOP_STEPS} steps resumed to {V3_RESUME_STEPS} bit-equal (AdaIN "
          f"included), checkpoints {loop['checkpoints']}, AdaIN calls {loop['adain_calls']}, "
          f"eval {loop['eval']['spectral_distance']} (twice); export {export['export_s']:.1f} s; "
          f"generate 30 s {export['realtime_factor_generate']:.1f}x end to end; attributes, "
          f"card vs CPU per call: " + ", ".join(
              f"{k} " + " / ".join(f"{v:.1e}" for v in e.values())
              for k, e in export["card_vs_cpu"].items())
          + "; free-running from float64, card / card with cuDNN off / CPU: " + ", ".join(
              f"{k} {e['card']:.1e} / {e['card_cudnn_off']:.1e} / {e['cpu']:.1e}"
              for k, e in export["free_stream_vs_float64"].items())
          + ", the served transfer by block " + " ".join(
              f"{e:.1e}" for e in export["free_transfer_by_block"])
          + f" (past block {export['free_transfer_settle_blocks']}, later / earlier half "
          f"{export['free_drift_ratio']:.2f}x, <= {FREE_DRIFT})"
          + f" (fixed kernels card vs CPU {export['fixed_kernels_card_vs_cpu']:.1e})"
          + f"; transfer moved {export['transfer_rel_change']:.2e}, reset back "
          f"{export['reset_rel_err']:.1e}; forward_step.pt2 bit-equal over {PROGRAM_BLOCKS} "
          f"blocks; streaming p50 eager {export['block_ms_p50']['eager']:.3f} ms, .pt2 "
          f"{export['block_ms_p50']['program']:.3f} ms (budget {export['block_budget_ms']:.2f}"
          f" ms)", flush=True)
    print(f"discrete_v3: forward B={BATCH} {discrete['forward_ms']:.2f} ms = "
          f"{discrete['realtime_factor']:.1f}x realtime; steps B={TRAIN_BATCH} ms "
          + ", ".join(f"{k} {v:.1f}" for k, v in discrete["step_ms"].items())
          + "; B=1 card vs CPU losses " + ", ".join(
              f"{k} {v:.1e}" for k, v in discrete["b1_loss_rel_err"].items())
          + f"; B=1 x 65536 {codes_summary(discrete)}; {launches} unit launches on the "
          f"v3 path; phase {out['seconds']:.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()) + ")", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase `variants`: v2_small (the noise synth), v2_nopqmf (raw-waveform
# output) and hybrid (mel input, a 2-layer GRU) at full width
# ---------------------------------------------------------------------------

VARIANTS = ("v2_small", "v2_nopqmf", "hybrid")
# the residual units of one forward at B x 131072 samples, in launch order:
# (C, T, dilations) of each stage, the encoder's then the decoder's
VARIANT_UNITS = {
    "v2_small": [(48, 8192, (1, 3, 9)), (96, 2048, (1, 3, 9)), (192, 1024, (1, 3, 9)),
                 (384, 512, (1, 3)), (384, 512, (1, 3)), (192, 1024, (1, 3, 9)),
                 (96, 2048, (1, 3, 9)), (48, 8192, (1, 3, 9))],
    "v2_nopqmf": [(64, 8192, (1, 3, 9)), (128, 2048, (1, 3, 9)), (256, 512, (1, 3, 9)),
                  (512, 128, (1, 3)), (512, 256, (1, 3)), (256, 2048, (1, 3, 9)),
                  (128, 16384, (1, 3, 9)), (64, 131072, (1, 3, 9))],
    "hybrid": [(96, 512, (1,)), (192, 256, (1,)), (384, 128, (1,)), (768, 128, (1, 3)),
               (384, 512, (1, 3, 9)), (192, 2048, (1, 3, 9)), (96, 8192, (1, 3, 9))],
}
VARIANT_LAUNCHES = {k: sum(len(d) for _, _, d in v) for k, v in VARIANT_UNITS.items()}
# the variants whose bf16 steps phase `train_bf16` drives: hybrid's mel input has no
# bf16 step in rave_tpu (its rfft refuses bfloat16; ROADMAP C14), and the port refuses it
VARIANT_BF16 = ("v2_small", "v2_nopqmf")
# hybrid's receptive field, 21759 / 21503 samples (architectural: the probe on the CPU at
# capacity 2), divided by the channels alone as rave_tpu/train/loop.py:168 does under mel
# input, crops more band frames than a 131072-sample clip has (ROADMAP C12): its steps and
# run train without the crop
VARIANT_OVERRIDES = {"hybrid": ["train.valid_signal_crop=false"]}
# the run: a pre-warmup, an adversarial and a critic step, on the device dataset
VARIANT_LOOP = ["train.phase_1_duration=1", "train.update_discriminator_every=2",
                "data.augmentations=[]"]
VARIANT_LOOP_STEPS, VARIANT_B1_SIGNAL = 3, 65536
VARIANT_STREAM_BLOCKS = 32  # timed streaming forward blocks


def variant_unit_cases(batch: int) -> list:
    """The kernel cases of the variants' unit shapes that v2's do not cover,
    centered at `batch`; then at each channel count new to the kernel, at
    its longest T and widest dilation there, a ragged length (T - 21) at
    `batch` and the length itself at B=1."""
    v2 = {(C, T, d) for C, T, dils in UNIT_SHAPES for d in dils}
    shapes = sorted({(C, T, d) for units in VARIANT_UNITS.values() for C, T, dils in units
                     for d in dils} - v2)
    cases = [("variant", batch, C, T, d, "centered") for C, T, d in shapes]
    widths = {C for C, _, _ in UNIT_SHAPES}
    widest = {}
    for C, T, d in shapes:
        if C not in widths:
            widest[C] = max(widest.get(C, (0, 0)), (T, d))
    for C, (T, d) in sorted(widest.items()):
        cases += [("ragged", batch, C, T - 21, d, "centered"), ("b1", 1, C, T, d, "centered")]
    return cases


def unit_rows_of(rows, preset: str, batch: int) -> list:
    """The kernel phases' rows of one forward's units of `preset` at `batch`
    (each launch once), centered."""
    table = {(r["C"], r["T"], r["d"]): r for r in rows
             if r["B"] == batch and r["mode"] == "centered" and r["case"] in ("main", "variant")}
    return [table[(C, T, d)] for C, T, dils in VARIANT_UNITS[preset] for d in dils]


def variant_cfg(preset: str):
    from rave_tpu_torch.config import compose

    return compose([preset], VARIANT_OVERRIDES.get(preset, []))


def _variant_draws(cfg, x, gen):
    """The variational eps and the noise synth's uniforms of a pass over x."""
    import torch

    from rave_tpu_torch.models.blocks import LatentDraws

    B, T_lat = x.shape[0], x.shape[-1] // cfg.decimation()
    eps = torch.randn(B, cfg.latent_size, T_lat, device=x.device, generator=gen)
    shape = cfg.noise_shape(x.shape[1], B, T_lat)
    uniform = None if shape is None else torch.rand(shape, device=x.device, generator=gen)
    return LatentDraws(eps=eps, uniform=uniform)


def _variant_offline(preset: str, cfg) -> dict:
    """B=16 x 131072 forward (exact launches, the units' shapes, timed), and
    B=1 x 65536 card against CPU."""
    import torch

    from rave_tpu_torch.factory import build_rave
    from rave_tpu_torch.ops.kernels import dilated_unit

    cpu_model = build_rave(cfg, seed=0, device="cpu").eval()
    model = copy.deepcopy(cpu_model).cuda()
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(BATCH, 1, N_SIGNAL, device="cuda", generator=gen) * 0.1
    draws = _variant_draws(cfg, x, gen)
    want = VARIANT_LAUNCHES[preset]
    with torch.inference_mode():
        model(x, draws)  # warm
        torch.cuda.synchronize()
        before = (dilated_unit.launches, dilated_unit.launches_bf16)
        with UnitShapes() as shapes:
            y = model(x, draws)
        torch.cuda.synchronize()
        launches = dilated_unit.launches - before[0]
        seen = [(C, T, d) for _, C, T, d, _ in shapes.seen]
        units = [(C, T, d) for C, T, dils in VARIANT_UNITS[preset] for d in dils]
        check(seen == units, f"{preset}: the forward's units {seen}, expected {units}")
        check(launches == want and dilated_unit.launches_bf16 == before[1],
              f"{preset}: {launches} launches in one forward, expected {want} fp32")
        check(tuple(y.shape) == (BATCH, 1, N_SIGNAL) and bool(torch.isfinite(y).all()),
              f"{preset}: output {tuple(y.shape)} or not finite")
        iters = 5
        t0 = time.perf_counter()
        for _ in range(iters):
            model(x, draws)
        torch.cuda.synchronize()
        sec = (time.perf_counter() - t0) / iters
        n = VARIANT_B1_SIGNAL
        xb = torch.randn(1, 1, n, generator=torch.Generator().manual_seed(2)) * 0.1
        db = _variant_draws(cfg, xb, torch.Generator().manual_seed(3))
        y_cpu = cpu_model(xb, db)
        y_gpu = model(xb.cuda(), db.to("cuda")).cpu()
        err = rel_err(y_gpu, y_cpu)
        check(err <= MODEL_TOL, f"{preset}: card vs CPU forward {err:.3e} > {MODEL_TOL}")
    return {"launches_per_forward": want, "forward_ms": sec * 1e3,
            "realtime_factor": BATCH * N_SIGNAL / SAMPLE_RATE / sec, "b1_rel_err": err}


def _variant_stream(preset: str, cfg) -> dict:
    """Streamed blocks of block_size() against the offline output past the
    delays (encode; decode on the noise synth's offline draws shifted by its
    lag), and the p50 of a streaming forward block (encode + decode)."""
    import torch

    from rave_tpu_torch.factory import build_rave
    from rave_tpu_torch.nn.streaming import init_stream_state

    model = build_rave(cfg, stream_batch=1, seed=4, device="cuda").eval()
    block, D, dec = cfg.block_size(), cfg.latent_size, cfg.decimation()
    gen = torch.Generator(device="cuda").manual_seed(5)
    frames = block // dec
    with torch.inference_mode():
        De = model.encode_delay
        n_enc = 8 + 2 * -(-De * dec // block)
        x = torch.randn(1, 1, block * n_enc, device="cuda", generator=gen) * 0.1
        init_stream_state(model, 1)
        z_st = torch.cat([model.step_encode(x[..., i * block:(i + 1) * block])
                          for i in range(n_enc)], -1)
        z_off = model.encode(x)
        z_err = rel_err(z_st[..., 2 * De:], z_off[..., De:z_off.shape[-1] - De])

        Dd = model.decode_delay
        n_dec = 8 + 2 * -(-Dd // block)
        n_lat = frames * n_dec
        latent = torch.randn(1, D, n_lat, device="cuda", generator=gen)
        shape, u_off, u_st = cfg.noise_shape(1, 1, n_lat), None, [None] * n_dec
        if shape is not None:
            noise = model.decoder.synth.branches[-1]  # the noise synth, v2's or v1's
            lag = noise.delay // noise.target_size
            u_off = torch.rand(shape, device="cuda", generator=gen)
            shifted = torch.cat([torch.zeros_like(u_off[:, :lag]), u_off[:, :shape[1] - lag]], 1)
            u_st = shifted.split(shape[1] // n_dec, dim=1)
        init_stream_state(model, 1)
        y_st = torch.cat([model.step_decode(latent[..., i * frames:(i + 1) * frames], u_st[i])
                          for i in range(n_dec)], -1)
        y_off = model.decode(latent, u_off)
        y_err = rel_err(y_st[..., 2 * Dd:], y_off[..., Dd:y_off.shape[-1] - Dd])
        check(bool(torch.isfinite(y_st).all()) and y_st.shape == y_off.shape,
              f"{preset}: stream {tuple(y_st.shape)} or not finite")
        check(z_err <= MODEL_TOL and y_err <= MODEL_TOL,
              f"{preset}: stream vs offline past the delays z {z_err:.3e}, y {y_err:.3e}")

        init_stream_state(model, 1)
        xs = torch.randn(1, 1, block * VARIANT_STREAM_BLOCKS, device="cuda", generator=gen)
        times = []
        for i in range(VARIANT_STREAM_BLOCKS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            z = model.step_encode(xs[..., i * block:(i + 1) * block])
            shape = cfg.noise_shape(1, 1, frames)
            u = None if shape is None else torch.rand(shape, device="cuda", generator=gen)
            model.step_decode(z[:, :D], u)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    return {"block": block, "encode_delay": De, "decode_delay": Dd, "z_rel_err": z_err,
            "y_rel_err": y_err, "block_ms_p50": statistics.median(times) * 1e3,
            "block_budget_ms": block / SAMPLE_RATE * 1e3}


def _variant_state(cfg, device: str, step: int):
    from rave_tpu_torch.train.state import create_train_state

    st = create_train_state(cfg, seed=0, device=device)
    st.step = step
    return st


def batch_stats(model) -> dict:
    """BatchNorm's running statistics by name, on the CPU (none without v1's BatchNorm)."""
    return {n: b.detach().cpu() for n, b in model.named_buffers()
            if n.endswith((".bn.mean", ".bn.var"))}


def _variant_steps(preset: str, cfg, want: int = None) -> dict:
    """The receptive-field crop, one step of each program at B=8 x 131072
    after one warm step each (exact launches, `want` per step, times, peak
    memory), and the first step of each program at B=1 on the card against
    the CPU (losses, and BatchNorm's running statistics after the step)."""
    import torch

    from rave_tpu_torch.train.analysis import crop_frames, receptive_field
    from rave_tpu_torch.train.steps import build_train_steps, draw_noise

    rf = receptive_field(cfg, device="cuda") if cfg.train.valid_signal_crop else (0, 0)
    crop = crop_frames(cfg, rf)
    steps = build_train_steps(cfg, crop)
    t1 = cfg.train.phase_1_duration
    programs = {"gen_prewarmup": ("gen", False, 0), "gen_adversarial": ("gen", True, t1 + 1),
                "dis": ("dis", True, t1)}
    timed = _timed_steps(cfg, crop, False, programs,
                         VARIANT_LAUNCHES[preset] if want is None else want)

    xb = torch.randn(1, 1, VARIANT_B1_SIGNAL, generator=torch.Generator().manual_seed(8)) * 0.1
    db = draw_noise(cfg, xb, torch.Generator().manual_seed(9))
    errs, stats_errs = {}, {}
    for name, (which, warmed, step) in programs.items():
        losses, stats = {}, {}
        for device in ("cuda", "cpu"):
            s = _variant_state(cfg, device, step)
            d = db.to(device)
            m = (steps["gen"](s, xb.to(device), warmed, draws=d) if which == "gen"
                 else steps["dis"](s, xb.to(device), draws=d))
            losses[device] = {k: float(v) for k, v in m.items() if _is_loss(k)}
            stats[device] = batch_stats(s.model)
        errs[name] = _loss_err(losses["cuda"], losses["cpu"])
        check(errs[name] <= LOSS_TOL, f"{preset} {name} B=1 card vs CPU losses "
                                      f"{errs[name]:.3e} > {LOSS_TOL}: {losses}")
        if stats["cpu"]:
            stats_errs[name] = max(rel_err(v, stats["cpu"][k]) for k, v in stats["cuda"].items())
            check(stats_errs[name] <= LOSS_TOL, f"{preset} {name} B=1 card vs CPU running "
                                                f"statistics {stats_errs[name]:.3e} > {LOSS_TOL}")
    return {"receptive_field": list(rf), "crop_frames": list(crop), **timed,
            "b1_loss_rel_err": errs, "b1_stats_rel_err": stats_errs}


def _variant_loop_export(preset: str, cfg, work: Path, db: Path) -> dict:
    """`cli train --config <preset>` a few steps on phase `loop`'s store
    (device dataset), `cli export --streaming`, `cli generate` of a 30 s
    file; the artifact on the card against the CPU (3 s clip offline and 8
    streaming blocks, the same seeds), `forward_step.pt2` against the eager
    steps over 32 blocks (<= 1e-5), the streaming p50."""
    import torch

    from rave_tpu_torch.data.audio_io import decode_file
    from rave_tpu_torch.export.artifact import ExportedRAVE
    from rave_tpu_torch.export.generate import load_signal
    from rave_tpu_torch.ops.kernels import dilated_unit

    want = VARIANT_LAUNCHES[preset]
    args = ["train", "--config", preset, "--db_path", db, "--out_path", work / "runs",
            "--batch", TRAIN_BATCH, "--n_signal", N_SIGNAL, "--device", "cuda", "--val_every",
            1000, "--save_every", 1000, "--device_data", "on", "--name", preset,
            "--max_steps", VARIANT_LOOP_STEPS]
    for o in VARIANT_LOOP + VARIANT_OVERRIDES.get(preset, []):
        args += ["--override", o]
    with LoopProbe() as probe:
        out = _cli(args)
        events = probe.take()
    run_dir = Path(out.strip().splitlines()[-1].removeprefix("run dir: "))
    check("device-resident dataset" in out, f"{preset}: the run did not use the device dataset")
    _check_steps(events, "fp32", 0, VARIANT_LOOP_STEPS, probe=cfg.train.valid_signal_crop,
                 per_step=want)
    phases = [e["phase"] for e in events if e["kind"] == "step"]
    check(phases == ["gen_prewarmup", "gen_adversarial", "dis"], f"{preset} phases {phases}")

    t0 = time.perf_counter()
    text = _cli(["export", "--run", run_dir, "--streaming", "--output", work / "export",
                 "--device", "cuda"])
    export_s = time.perf_counter() - t0
    path = Path(text.strip().splitlines()[-1].removeprefix("exported: "))
    manifest = json.loads((path / "manifest.json").read_text())
    check(manifest["block_size"] == cfg.block_size(), f"{preset} manifest block size")
    wav = work / f"{preset}_in.wav"
    n = write_signal(wav, EXPORT_SECONDS, seed=23)
    torch.cuda.synchronize()
    before = dilated_unit.launches
    t0 = time.perf_counter()
    _cli(["generate", "--model", path, "--input", wav, "--out_path", work / "generated",
          "--device", "cuda"])
    torch.cuda.synchronize()
    generate_s, gen_launches = time.perf_counter() - t0, dilated_unit.launches - before
    check(gen_launches == want, f"{preset} generate: {gen_launches} launches, expected {want}")

    art, cpu = ExportedRAVE(str(path), device="cuda"), ExportedRAVE(str(path), device="cpu")
    B = art.block_size
    x = load_signal(decode_file(str(wav), SAMPLE_RATE, 1), 1, 1, B).cuda()
    clip = x[..., : -(-int(CLIP_SECONDS * SAMPLE_RATE) // B) * B]
    off_err = rel_err(art.forward(clip, seed=11).cpu(), cpu.forward(clip.cpu(), seed=11))
    ys_card, ys_cpu = [], []
    for i in range(CPU_STREAM_BLOCKS):
        xb = x[..., i * B:(i + 1) * B]
        ys_card.append(art.forward(xb, streaming=True, seed=100 + i).cpu())
        ys_cpu.append(cpu.forward(xb.cpu(), streaming=True, seed=100 + i))
    st_err = rel_err(torch.cat(ys_card, -1), torch.cat(ys_cpu, -1))
    check(off_err <= MODEL_TOL and st_err <= MODEL_TOL,
          f"{preset} artifact card vs CPU: offline {off_err:.3e}, streaming {st_err:.3e}")

    program = art.load_program("forward")
    art.reset_stream()
    state = [s.clone() for s in art.state]
    eager_ms, program_ms, worst = [], [], 0.0
    for i in range(PROGRAM_BLOCKS):
        xb = x[..., i * B:(i + 1) * B]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y_e = art.forward(xb, streaming=True, seed=3000 + i)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        y_p, state = program(state, xb, torch.tensor(3000 + i, device="cuda"))
        torch.cuda.synchronize()
        eager_ms.append((t1 - t0) * 1e3)
        program_ms.append((time.perf_counter() - t1) * 1e3)
        worst = max([worst, rel_err(y_p, y_e)]
                    + [rel_err(a, b, 1.0) for a, b in zip(state, art.state)])
    check(worst <= PROGRAM_TOL, f"{preset} forward_step.pt2 vs eager {worst:.3e} > {PROGRAM_TOL}")
    return {"loop_ms": loop_ms(events), "export_s": export_s, "generate_s": generate_s,
            "realtime_factor_generate": n / SAMPLE_RATE / generate_s,
            "generate_launches": gen_launches, "card_vs_cpu": {"offline": off_err,
                                                               "streaming": st_err},
            "program_vs_eager": worst, "block_ms_p50": {"eager": statistics.median(eager_ms),
                                                        "program": statistics.median(program_ms)},
            "block_budget_ms": B / SAMPLE_RATE * 1e3}


def phase_variants() -> dict:
    """v2_small, v2_nopqmf and hybrid at full width; see the module docstring."""
    import torch

    from rave_tpu_torch.ops.kernels import dilated_unit

    t_phase = time.perf_counter()
    work = ROOT / "build" / "variants"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    db = ROOT / "build" / "loop" / "db"
    out = {}
    torch.cuda.synchronize()
    dilated_unit.launches = dilated_unit.launches_bf16 = 0
    for preset in VARIANTS:
        start = dilated_unit.launches
        cfg = variant_cfg(preset)
        parts = {"offline": lambda: _variant_offline(preset, cfg),
                 "stream": lambda: _variant_stream(preset, cfg),
                 "steps": lambda: _variant_steps(preset, cfg),
                 "loop_export": lambda: _variant_loop_export(preset, cfg, work / preset, db)}
        t0, res, seconds = time.perf_counter(), {}, {}
        for name, run in parts.items():
            t = time.perf_counter()
            res[name] = run()
            seconds[name] = time.perf_counter() - t
        res["launches"] = dilated_unit.launches - start
        res["seconds"], res["part_seconds"] = time.perf_counter() - t0, seconds
        out[preset] = res
        o, s, st, le = res["offline"], res["stream"], res["steps"], res["loop_export"]
        print(f"variants {preset}: forward B={BATCH} x {N_SIGNAL} {o['forward_ms']:.2f} ms = "
              f"{o['realtime_factor']:.1f}x realtime, {o['launches_per_forward']} launches per "
              f"forward; B=1 card vs CPU {o['b1_rel_err']:.2e}; stream vs offline z "
              f"{s['z_rel_err']:.2e} y {s['y_rel_err']:.2e}, p50 {s['block_ms_p50']:.3f} ms per "
              f"{s['block']}-sample block (budget {s['block_budget_ms']:.2f}); steps B="
              f"{TRAIN_BATCH} ms " + ", ".join(f"{k} {v:.1f}" for k, v in st["ms_per_step"].items())
              + f", peak {st['peak_gb']:.2f} GiB, rf {st['receptive_field']}; B=1 card vs CPU "
              "losses " + ", ".join(f"{k} {v:.1e}" for k, v in st["b1_loss_rel_err"].items())
              + f"; cli train/export/generate: generate 30 s {le['realtime_factor_generate']:.1f}x"
              f", artifact card vs CPU {le['card_vs_cpu']['offline']:.1e} / "
              f"{le['card_vs_cpu']['streaming']:.1e}, .pt2 vs eager {le['program_vs_eager']:.1e}"
              f", p50 eager {le['block_ms_p50']['eager']:.3f} / .pt2 "
              f"{le['block_ms_p50']['program']:.3f} ms; {res['launches']} launches; "
              f"{res['seconds']:.1f} s", flush=True)
    shutil.rmtree(work, ignore_errors=True)
    launches = dilated_unit.launches
    check(dilated_unit.launches_bf16 == 0 and all(r["launches"] > 0 for r in out.values()),
          f"variants: launches {[r['launches'] for r in out.values()]}, "
          f"{dilated_unit.launches_bf16} bf16")
    return {"presets": out, "launches": launches, "seconds": time.perf_counter() - t_phase}


# ---------------------------------------------------------------------------
# phase `v1`: the v1 preset at full width (EncoderV1 with BatchNorm, GeneratorV1
# with its noise synth), and `export_onnx --verify`
# ---------------------------------------------------------------------------

# a pre-warmup, an adversarial and a critic step, resumed after the second
V1_LOOP = ["train.phase_1_duration=1", "train.update_discriminator_every=2", "train.ema=0.999"]
V1_LOOP_STEPS, V1_RESUME_STEPS = 2, 3
ONNX_LOOP, ONNX_LOOP_STEPS = ["train.phase_1_duration=1"], 2  # a pre-warmup, then a critic step
V1_STATS = 8  # BatchNorm's running mean and var in each of v1's 4 strided stages


def _v1_offline(cfg) -> dict:
    """The B=16 x 131072 forward in eval mode (BatchNorm on its running
    statistics; no unit launch: v1 has no DilatedUnit), timed, and at B=1 x
    65536 the card against the CPU on the same weights and draws."""
    import torch

    from rave_tpu_torch.factory import build_rave
    from rave_tpu_torch.ops.kernels import dilated_unit

    cpu_model = build_rave(cfg, seed=0, device="cpu").eval()
    model = copy.deepcopy(cpu_model).cuda()
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(BATCH, 1, N_SIGNAL, device="cuda", generator=gen) * 0.1
    draws = _variant_draws(cfg, x, gen)
    with torch.inference_mode():
        model(x, draws)  # warm
        torch.cuda.synchronize()
        before = dilated_unit.launches
        y = model(x, draws)
        torch.cuda.synchronize()
        launches = dilated_unit.launches - before
        check(tuple(y.shape) == (BATCH, 1, N_SIGNAL) and bool(torch.isfinite(y).all())
              and launches == 0, f"v1 forward {tuple(y.shape)}, {launches} unit launches")
        t0 = time.perf_counter()
        for _ in range(5):
            model(x, draws)
        torch.cuda.synchronize()
        sec = (time.perf_counter() - t0) / 5
        xb = torch.randn(1, 1, VARIANT_B1_SIGNAL, generator=torch.Generator().manual_seed(2)) * 0.1
        db = _variant_draws(cfg, xb, torch.Generator().manual_seed(3))
        err = rel_err(model(xb.cuda(), db.to("cuda")).cpu(), cpu_model(xb, db))
    check(err <= MODEL_TOL, f"v1 B=1 card vs CPU forward {err:.3e} > {MODEL_TOL}")
    return {"launches": launches, "forward_ms": sec * 1e3,
            "realtime_factor": BATCH * N_SIGNAL / SAMPLE_RATE / sec, "b1_rel_err": err}


def _v1_loop_export(work: Path, db: Path) -> dict:
    """`cli train --config v1` on phase `loop`'s store, resumed once (the
    restored state, BatchNorm's running statistics included, bit-equal to its
    checkpoint; the statistics moved by the steps); `cli export --streaming`
    and `cli generate` of a 30 s file; the artifact on the card against the
    CPU; `forward_step.pt2` bit-equal to the eager steps over 32 blocks; the
    streaming p50 of a block, eager and `.pt2`, under the block's budget."""
    import torch

    from rave_tpu_torch.data.audio_io import decode_file
    from rave_tpu_torch.export.artifact import ExportedRAVE
    from rave_tpu_torch.export.generate import load_signal
    from rave_tpu_torch.ops.kernels import dilated_unit
    from rave_tpu_torch.utils import checkpoint

    common = ["--config", "v1", "--db_path", db, "--out_path", work / "runs", "--batch",
              TRAIN_BATCH, "--n_signal", N_SIGNAL, "--device", "cuda", "--val_every", 2,
              "--save_every", 1000, "--device_data", "on", "--name", "v1"]
    for o in V1_LOOP:
        common += ["--override", o]
    with LoopProbe() as probe:
        out = _cli(["train", "--max_steps", V1_LOOP_STEPS, *common])
        run_dir = Path(out.strip().splitlines()[-1].removeprefix("run dir: "))
        first = probe.take()
        out2 = _cli(["train", "--max_steps", V1_RESUME_STEPS, *common])
        resumed = probe.take()
    _check_steps(first, "fp32", 0, V1_LOOP_STEPS, per_step=0)
    _check_steps(resumed, "fp32", V1_LOOP_STEPS, V1_RESUME_STEPS, per_step=0)
    check(f"resumed at step {V1_LOOP_STEPS}" in out2, "the v1 run did not resume")
    phases = [e["phase"] for e in first + resumed if e["kind"] == "step"]
    check(phases == ["gen_prewarmup", "gen_adversarial", "dis"], f"v1 phases {phases}")
    restores = [e for e in resumed if e["kind"] == "restore" and "state" in e]
    check(len(restores) == 1, f"v1 restores {len(restores)}")
    saved = torch.load(restores[0]["path"], map_location="cpu", weights_only=True)
    bad = unequal(restores[0]["state"], saved)
    stats = {k: v for k, v in saved["model"].items() if k.endswith((".bn.mean", ".bn.var"))}
    moved = sum(not torch.equal(v, torch.zeros_like(v) if k.endswith("mean") else
                                torch.ones_like(v)) for k, v in stats.items())
    check(not bad and len(stats) == V1_STATS and moved == V1_STATS,
          f"v1 restore not bit-equal ({bad[:5]}), or {len(stats)} running statistics "
          f"({moved} moved)")

    t0 = time.perf_counter()
    text = _cli(["export", "--run", run_dir, "--streaming", "--output", work / "export",
                 "--device", "cuda"])
    export_s = time.perf_counter() - t0
    path = Path(text.strip().splitlines()[-1].removeprefix("exported: "))
    wav = work / "v1_in.wav"
    n = write_signal(wav, EXPORT_SECONDS, seed=24)
    torch.cuda.synchronize()
    before = dilated_unit.launches
    t0 = time.perf_counter()
    _cli(["generate", "--model", path, "--input", wav, "--out_path", work / "generated",
          "--device", "cuda"])
    torch.cuda.synchronize()
    generate_s, gen_launches = time.perf_counter() - t0, dilated_unit.launches - before
    check(gen_launches == 0, f"v1 generate: {gen_launches} unit launches, expected 0")

    art, cpu = ExportedRAVE(str(path), device="cuda"), ExportedRAVE(str(path), device="cpu")
    final = torch.load(checkpoint.latest_checkpoint(str(run_dir)), map_location="cpu",
                       weights_only=True)["model"]
    check(not unequal(batch_stats(art.model), {k: final[k] for k in stats}),
          "the artifact's running statistics are not the run's")
    B = art.block_size
    x = load_signal(decode_file(str(wav), SAMPLE_RATE, 1), 1, 1, B).cuda()
    clip = x[..., : -(-int(CLIP_SECONDS * SAMPLE_RATE) // B) * B]
    off_err = rel_err(art.forward(clip, seed=11).cpu(), cpu.forward(clip.cpu(), seed=11))
    ys_card, ys_cpu = [], []
    for i in range(CPU_STREAM_BLOCKS):
        xb = x[..., i * B:(i + 1) * B]
        ys_card.append(art.forward(xb, streaming=True, seed=100 + i).cpu())
        ys_cpu.append(cpu.forward(xb.cpu(), streaming=True, seed=100 + i))
    st_err = rel_err(torch.cat(ys_card, -1), torch.cat(ys_cpu, -1))
    check(off_err <= MODEL_TOL and st_err <= MODEL_TOL,
          f"v1 artifact card vs CPU: offline {off_err:.3e}, streaming {st_err:.3e}")

    program = art.load_program("forward")
    art.reset_stream()
    state = [s.clone() for s in art.state]
    eager_ms, program_ms, equal = [], [], True
    for i in range(PROGRAM_BLOCKS):
        xb = x[..., i * B:(i + 1) * B]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y_e = art.forward(xb, streaming=True, seed=3000 + i)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        y_p, state = program(state, xb, torch.tensor(3000 + i, device="cuda"))
        torch.cuda.synchronize()
        eager_ms.append((t1 - t0) * 1e3)
        program_ms.append((time.perf_counter() - t1) * 1e3)
        equal = equal and torch.equal(y_p, y_e) and all(
            torch.equal(a, b) for a, b in zip(state, art.state))
    check(equal, f"v1 forward_step.pt2 not bit-equal to the eager steps over {PROGRAM_BLOCKS} "
                 "blocks")
    p50 = {"eager": statistics.median(eager_ms), "program": statistics.median(program_ms)}
    budget = B / SAMPLE_RATE * 1e3
    check(max(p50.values()) < budget, f"v1 streaming p50 {p50} over the {budget:.2f} ms budget")
    ckpts = [e["mb"] for e in first + resumed if e["kind"] == "save"]
    return {"loop_ms": loop_ms(first + resumed), "checkpoint_mb": ckpts, "export_s": export_s,
            "generate_s": generate_s, "realtime_factor_generate": n / SAMPLE_RATE / generate_s,
            "launches": sum(e["fp32"] + e["bf16"] for e in first + resumed) + gen_launches,
            "card_vs_cpu": {"offline": off_err, "streaming": st_err},
            "program_bit_equal": equal, "block_ms_p50": p50, "block_budget_ms": budget}


def _export_onnx(run_dir: Path, out: Path) -> dict:
    """`cli export_onnx --verify` of `run_dir` on the card: its seconds, the
    file's size, the verify's error, and the unit launches it made (its live
    forward's)."""
    import torch

    from rave_tpu_torch.ops.kernels import dilated_unit

    torch.cuda.synchronize()
    before = (dilated_unit.launches, dilated_unit.launches_bf16)
    t0 = time.perf_counter()
    text = _cli(["export_onnx", "--run", run_dir, "--output", out, "--verify", "--device",
                 "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    lines = text.strip().splitlines()
    path = Path(next(v for v in lines if v.startswith("exported: ")).removeprefix("exported: "))
    err = float(next(v for v in lines if v.startswith("verify: ")).split("= ")[1].split()[0])
    check(err < 1e-4, f"export_onnx --verify of {run_dir.name}: {err:.3e}")
    return {"seconds": seconds, "mib": path.stat().st_size / 2**20, "verify_max_abs_err": err,
            "launches": dilated_unit.launches - before[0],
            "launches_bf16": dilated_unit.launches_bf16 - before[1]}


def _v1_onnx(work: Path, db: Path, v2_run: Path) -> dict:
    """`cli train --config onnx` two steps on phase `loop`'s store, then `cli
    export_onnx --verify` of it (no unit launch: v1) and of phase `loop`'s v2
    run (its live forward's 22 launches, exactly; the kernel held against its
    plain version at each shape they gave it)."""
    import torch

    args = ["train", "--config", "onnx", "--db_path", db, "--out_path", work / "runs",
            "--batch", TRAIN_BATCH, "--n_signal", N_SIGNAL, "--device", "cuda", "--val_every",
            1000, "--save_every", 1000, "--device_data", "on", "--name", "onnx",
            "--max_steps", ONNX_LOOP_STEPS]
    for o in ONNX_LOOP:
        args += ["--override", o]
    out = _cli(args)
    run_dir = Path(out.strip().splitlines()[-1].removeprefix("run dir: "))
    onnx = _export_onnx(run_dir, work / "onnx")
    with UnitShapes() as shapes:
        v2 = _export_onnx(v2_run, work / "onnx_v2")
    check(onnx["launches"] == 0 and v2["launches"] == 22 and v2["launches_bf16"] == 0
          and len(shapes.seen) == v2["launches"],
          f"export_onnx --verify launches: onnx {onnx['launches']} (expected 0), v2 "
          f"{v2['launches']} (expected 22, {len(shapes.seen)} unit shapes seen)")
    # the kernel against its plain version at each shape the verify's live forward gave it
    gen = torch.Generator(device="cuda").manual_seed(18)
    rows = {shape: kernel_row(gen, "onnx_verify", *shape) for shape in sorted(set(shapes.seen))}
    path = [rows[shape] for shape in shapes.seen]  # one per launch
    v2["unit_path"] = {"shapes": len(rows), "ms": sum(r["ms"] for r in path),
                       "plain_ms": sum(r["plain_ms"] for r in path),
                       "bound_ms": sum(unit_bound([r], r["B"], "fp32")["bound_ms"] for r in path),
                       "max_abs_err": max(r["max_abs_err"] for r in path),
                       "max_rel_err": max(r["rel_err"] for r in path)}
    return {"onnx": onnx, "v2": v2}


def phase_v1(v2_run: Path, db: Path) -> dict:
    """compose(["v1"]) at full width and `export_onnx`; see the module docstring."""
    import torch

    from rave_tpu_torch.config import compose
    from rave_tpu_torch.ops.kernels import dilated_unit

    t_phase = time.perf_counter()
    work = ROOT / "build" / "v1"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    cfg = compose(["v1"])
    seconds, out = {}, {}
    parts = {"offline": lambda: _v1_offline(cfg),
             "stream": lambda: _variant_stream("v1 causal", compose(["v1", "causal"])),
             "steps": lambda: _variant_steps("v1", cfg, want=0),
             "loop_export": lambda: _v1_loop_export(work, db)}
    torch.cuda.synchronize()
    dilated_unit.launches = dilated_unit.launches_bf16 = 0
    for name, run in parts.items():
        t0 = time.perf_counter()
        out[name] = run()
        seconds[name] = time.perf_counter() - t0
    launches = dilated_unit.launches
    check(launches == 0 and dilated_unit.launches_bf16 == 0,
          f"{launches} unit launches on the v1 path, expected 0")
    t0 = time.perf_counter()
    out["onnx"] = _v1_onnx(work, db, v2_run)
    seconds["onnx"] = time.perf_counter() - t0
    shutil.rmtree(work, ignore_errors=True)
    out.update({"launches": launches, "launches_onnx_verify": out["onnx"]["v2"]["launches"],
                "part_seconds": seconds, "seconds": time.perf_counter() - t_phase})
    o, s, st, le, ox = (out[k] for k in ("offline", "stream", "steps", "loop_export", "onnx"))
    print(f"v1: forward B={BATCH} x {N_SIGNAL} (eval) {o['forward_ms']:.2f} ms = "
          f"{o['realtime_factor']:.1f}x realtime, {launches} unit launches; B=1 card vs CPU "
          f"{o['b1_rel_err']:.2e}; causal stream vs offline z {s['z_rel_err']:.2e} y "
          f"{s['y_rel_err']:.2e}; steps B={TRAIN_BATCH} x {N_SIGNAL} ms " + ", ".join(
              f"{k} {v:.1f}" for k, v in st["ms_per_step"].items())
          + f", peak {st['peak_gb']:.2f} GiB; B=1 card vs CPU losses " + ", ".join(
              f"{k} {v:.1e}" for k, v in st["b1_loss_rel_err"].items())
          + ", running statistics " + ", ".join(
              f"{k} {v:.1e}" for k, v in st["b1_stats_rel_err"].items())
          + f"; cli train {V1_LOOP_STEPS} steps resumed to {V1_RESUME_STEPS} bit-equal "
          f"(running statistics included); export {le['export_s']:.1f} s, generate 30 s "
          f"{le['realtime_factor_generate']:.1f}x, artifact card vs CPU "
          f"{le['card_vs_cpu']['offline']:.1e} / {le['card_vs_cpu']['streaming']:.1e}, "
          f"forward_step.pt2 bit-equal over {PROGRAM_BLOCKS} blocks, streaming p50 eager "
          f"{le['block_ms_p50']['eager']:.3f} ms, .pt2 {le['block_ms_p50']['program']:.3f} ms "
          f"(budget {le['block_budget_ms']:.2f} ms); export_onnx --verify: onnx "
          f"{ox['onnx']['seconds']:.1f} s, {ox['onnx']['mib']:.2f} MiB, err "
          f"{ox['onnx']['verify_max_abs_err']:.1e}, {ox['onnx']['launches']} launches; v2 "
          f"{ox['v2']['seconds']:.1f} s, {ox['v2']['mib']:.2f} MiB, err "
          f"{ox['v2']['verify_max_abs_err']:.1e}, {ox['v2']['launches']} launches at "
          f"{ox['v2']['unit_path']['shapes']} shapes, kernel vs plain max abs err "
          f"{ox['v2']['unit_path']['max_abs_err']:.1e} (rel "
          f"{ox['v2']['unit_path']['max_rel_err']:.1e}), {ox['v2']['unit_path']['ms']:.3f} ms "
          f"(plain {ox['v2']['unit_path']['plain_ms']:.3f}, bound "
          f"{ox['v2']['unit_path']['bound_ms']:.3f}); phase "
          f"{out['seconds']:.1f} s (" + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items())
          + ")", flush=True)
    return out


SPECTRAL = ["v2", "spectral_discriminator"]
SPECTRAL_BF16 = ["train.bf16=true", "train.bf16_dis=true"]
# the other distances, each in one adversarial generator step of v2
DISTANCE_KINDS = {"encodec": ['distance.kind="encodec"'],
                  "instantaneous": ['distance.kind="instantaneous"'],
                  "mel64": ["distance.num_mels=64"]}
SPECTRAL_CRITIC_ITERS = 5


def _timed_steps(cfg, crop, bf16: bool, programs: dict, want: int = 22) -> dict:
    """Each of `programs` ({name: (which, warmed, step)}) at B=8 x 131072 from
    the seed-0 state: a warm step, then a timed one, each with exactly `want`
    launches of the step's variant (fp32, or bf16 under `train.bf16`), finite
    metrics; ms per step and the peak memory."""
    import torch

    from rave_tpu_torch.ops.kernels import dilated_unit
    from rave_tpu_torch.train.steps import build_train_steps, draw_noise

    steps = build_train_steps(cfg, crop)
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(TRAIN_BATCH, 1, N_SIGNAL, device="cuda", generator=gen) * 0.1
    st = _variant_state(cfg, "cuda", 0)
    kind = "bf16" if bf16 else "fp32"
    ms = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for name, (which, warmed, step) in programs.items():
        times = []
        for _ in range(2):  # a warm step, then the timed one
            st.step = step
            draws = draw_noise(cfg, x, gen)
            torch.cuda.synchronize()
            before = (dilated_unit.launches, dilated_unit.launches_bf16)
            t0 = time.perf_counter()
            m = (steps["gen"](st, x, warmed, draws=draws) if which == "gen"
                 else steps["dis"](st, x, draws=draws))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            n, n_bf16 = (dilated_unit.launches - before[0],
                         dilated_unit.launches_bf16 - before[1])
            check(n == want and n_bf16 == (want if bf16 else 0),
                  f"{cfg.name} {kind} {name}: {n} launches ({n_bf16} bf16), expected {want} "
                  f"{kind}")
            bad = [k for k, v in m.items() if not math.isfinite(float(v))]
            check(not bad, f"{cfg.name} {kind} {name}: non-finite {bad}")
        ms[name] = times[-1] * 1e3
    return {"ms_per_step": ms, "peak_gb": torch.cuda.max_memory_allocated() / 2**30}


def _b1_losses(cfg, programs: dict) -> dict:
    """The first step of each of `programs` at B=1 x 65536 from the seed-0
    state on the card and on the CPU, the same draws: each loss term's
    relative difference (as `_loss_err`, term by term)."""
    import torch

    from rave_tpu_torch.train.steps import build_train_steps, draw_noise

    steps = build_train_steps(cfg)  # no crop: the same on both devices
    xb = torch.randn(1, 1, VARIANT_B1_SIGNAL, generator=torch.Generator().manual_seed(8)) * 0.1
    db = draw_noise(cfg, xb, torch.Generator().manual_seed(9))
    errs = {}
    for name, (which, warmed, step) in programs.items():
        losses = {}
        for device in ("cuda", "cpu"):
            s = _variant_state(cfg, device, step)
            d = db.to(device)
            m = (steps["gen"](s, xb.to(device), warmed, draws=d) if which == "gen"
                 else steps["dis"](s, xb.to(device), draws=d))
            losses[device] = {k: float(v) for k, v in m.items() if _is_loss(k)}
        errs[name] = {k: abs(losses["cuda"][k] - v) / max(abs(v), 1e-2)
                      for k, v in losses["cpu"].items()}
    return errs


def _spectral_critic_ms(cfg, bf16: bool) -> dict:
    """The critic of `spectral` alone, forward and backward on the 16-row
    real+fake batch of a B=8 step, device ms by `cuda_ms`: whole, its
    multiscale part and its spectral part (EncodecConvNets on 5 STFTs)."""
    import torch

    from rave_tpu_torch.factory import build_discriminator

    critic = build_discriminator(cfg, seed=1, device="cuda")
    xy = torch.randn(2 * TRAIN_BATCH, 1, N_SIGNAL, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(4)) * 0.1
    if bf16:
        xy = xy.to(torch.bfloat16)
    parts = {"all": critic, "multiscale": critic.discriminators_0,
             "spectral": critic.discriminators_1}

    def fwd_bwd(module):
        def run():
            critic.zero_grad(set_to_none=True)
            sum(fm[-1].float().mean() for fm in module(xy)).backward()
        return run

    return {k: cuda_ms(fwd_bwd(m), SPECTRAL_CRITIC_ITERS) for k, m in parts.items()}


def spectral_flop(cfg, rows: int, n_signal: int) -> float:
    """Multiply-adds x 2 of the spectral critic's convs, forward, over `rows`
    signals: each scale's image [2, bins, frames] through ENCODEC_LAYERS and
    conv_out (the count PERF.md's prediction rests on)."""
    from rave_tpu_torch.models.discriminators import ENCODEC_LAYERS

    cap, total = cfg.discriminator.encodec_capacity, 0.0
    for scale in cfg.discriminator.spectral_scales:
        h, w, ch = scale // 2 + 1, (n_signal - scale) // (scale // 4) + 1, 2
        for (kh, kw), (sh, _), _ in ENCODEC_LAYERS:
            h = (h - 1) // sh + 1
            total += 2 * h * w * ch * cap * kh * kw
            ch = cap
        total += 2 * h * w * ch * 9
    return total * rows


def phase_spectral(crop) -> dict:
    """compose(["v2", "spectral_discriminator"]) and the other distances at
    full width; see the module docstring."""
    import torch

    from rave_tpu_torch.config import compose
    from rave_tpu_torch.ops.kernels import dilated_unit

    t_phase = time.perf_counter()
    t1 = compose(SPECTRAL).train.phase_1_duration
    programs = {"gen_prewarmup": ("gen", False, 0), "gen_adversarial": ("gen", True, t1 + 1),
                "dis": ("dis", True, t1)}
    adversarial = {"gen_adversarial": programs["gen_adversarial"]}
    cfgs = {"fp32": compose(SPECTRAL), "bf16": compose(SPECTRAL, SPECTRAL_BF16),
            **{k: compose(["v2"], o) for k, o in DISTANCE_KINDS.items()}}
    # the main path: 2 steps of each program (a warm one, a timed one), 22 launches each
    torch.cuda.synchronize()
    dilated_unit.launches = dilated_unit.launches_bf16 = 0
    out = {k: _timed_steps(c, crop, k == "bf16", programs if k in ("fp32", "bf16")
                           else adversarial) for k, c in cfgs.items()}
    launches, launches_bf16 = dilated_unit.launches, dilated_unit.launches_bf16
    n_steps = 2 * (2 * len(programs) + len(DISTANCE_KINDS))
    check(launches == 22 * n_steps and launches_bf16 == 22 * 2 * len(programs),
          f"phase spectral: {launches} launches ({launches_bf16} bf16), expected "
          f"{22 * n_steps} ({22 * 2 * len(programs)} bf16)")
    b1 = {"fp32": _b1_losses(cfgs["fp32"], programs),
          **{k: _b1_losses(cfgs[k], adversarial) for k in DISTANCE_KINDS}}
    critic = {k: _spectral_critic_ms(cfgs["fp32"], k == "bf16") for k in ("fp32", "bf16")}
    out.update({"launches": launches, "launches_bf16": launches_bf16, "b1_loss_rel_err": b1,
                "critic_fwd_bwd_ms": critic, "spectral_critic_tflop_fwd":
                spectral_flop(cfgs["fp32"], 2 * TRAIN_BATCH, N_SIGNAL) / 1e12,
                "seconds": time.perf_counter() - t_phase})
    f, b = out["fp32"], out["bf16"]
    print(f"spectral: v2 + spectral_discriminator B={TRAIN_BATCH} x {N_SIGNAL}, ms per step "
          f"fp32 " + ", ".join(f"{k} {v:.1f}" for k, v in f["ms_per_step"].items())
          + f" (peak {f['peak_gb']:.2f} GiB), bf16 " + ", ".join(
              f"{k} {v:.1f}" for k, v in b["ms_per_step"].items())
          + f" (peak {b['peak_gb']:.2f} GiB); critic fwd+bwd on {2 * TRAIN_BATCH} rows ms fp32 "
          + ", ".join(f"{k} {v:.1f}" for k, v in critic["fp32"].items()) + ", bf16 "
          + ", ".join(f"{k} {v:.1f}" for k, v in critic["bf16"].items())
          + f" (spectral forward {out['spectral_critic_tflop_fwd']:.3f} TFLOP); adversarial "
          "generator steps " + ", ".join(
              f"{k} {out[k]['ms_per_step']['gen_adversarial']:.1f} ms "
              f"({out[k]['peak_gb']:.2f} GiB)" for k in DISTANCE_KINDS)
          + "; B=1 card vs CPU, the largest loss term's error: " + "; ".join(
              f"{k} {name} {max(e for t, e in terms.items() if 'phase' not in t):.1e}"
              + "".join(f", {t} {e:.1e}" for t, e in terms.items() if "phase" in t)
              for k, errs in b1.items() for name, terms in errs.items())
          + f"; {launches} launches ({launches_bf16} bf16, 22 per step); "
          f"{out['seconds']:.1f} s", flush=True)
    for k, errs in b1.items():  # the phase terms too: their weighted form damps the
        for name, terms in errs.items():  # near-silent bins that cuFFT and the CPU round apart
            for t, e in terms.items():
                check(e <= LOSS_TOL, f"spectral {k} {name} B=1 card vs CPU {t}: {e:.3e} > "
                                     f"{LOSS_TOL}")
    return out


IMPORT_GIN = 'include "configs/v2.gin"\n'  # the reference's v2, as a run's config.gin names it
IMPORT_TOL = 1e-5  # imported vs source forward: the weight norm re-decomposed in float32


def _source_model(cfg):
    """v2 at full width with seeded weights and latent buffers (an orthogonal
    PCA, a mean, a rising fidelity curve), as a trained reference run has."""
    import torch

    from rave_tpu_torch.factory import build_rave

    model = build_rave(cfg, seed=21, device="cpu")
    D, gen = cfg.latent_size, torch.Generator().manual_seed(22)
    q, _ = torch.linalg.qr(torch.randn(D, D, generator=gen, dtype=torch.float64))
    with torch.no_grad():
        model.latent_pca.copy_(q.float())
        model.latent_mean.copy_(torch.randn(D, generator=gen) * 0.1)
        model.fidelity.copy_(torch.linspace(0.5, 1.0, D))
    return model


def _block_p50(art, x) -> dict:
    """The streaming p50 per block, eager and `forward_step.pt2`, over
    PROGRAM_BLOCKS blocks of x, after 4 warm blocks each."""
    import torch

    program, B = art.load_program("forward"), art.block_size
    art.reset_stream()
    state = [s.clone() for s in art.state]
    eager, prog = [], []
    for i in range(PROGRAM_BLOCKS + 4):
        xb = x[..., i * B:(i + 1) * B]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        art.forward(xb, streaming=True, seed=4000 + i)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, state = program(state, xb, torch.tensor(4000 + i, device="cuda"))
        torch.cuda.synchronize()
        eager.append((t1 - t0) * 1e3)
        prog.append((time.perf_counter() - t1) * 1e3)
    return {"eager": statistics.median(eager[4:]), "program": statistics.median(prog[4:])}


def phase_import() -> dict:
    """A reference checkpoint of v2 into the port; see the module docstring."""
    import torch
    from scipy.io import wavfile

    sys.path.insert(0, str(ROOT / "tools"))
    from torch_reference_ckpt import reference_state_dict, save_reference_ckpt

    from rave_tpu_torch import config as config_lib
    from rave_tpu_torch.data.audio_io import decode_file
    from rave_tpu_torch.export.artifact import ExportedRAVE
    from rave_tpu_torch.export.generate import load_signal
    from rave_tpu_torch.nn.conv import ConvTranspose1d
    from rave_tpu_torch.ops.kernels import dilated_unit
    from rave_tpu_torch.train.loop import fp32_exact
    from rave_tpu_torch.train.state import create_train_state
    from rave_tpu_torch.utils.checkpoint import load_run, save_checkpoint
    from rave_tpu_torch.utils.convert import jax_path, to_jax_variables

    t_phase = time.perf_counter()
    work = ROOT / "build" / "import"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    gin = work / "config.gin"
    gin.write_text(IMPORT_GIN)
    cfg = config_lib.compose([str(gin)])
    source = _source_model(cfg)
    t0 = time.perf_counter()
    sd = reference_state_dict(to_jax_variables(source), transposed={
        jax_path(n) for n, m in source.named_modules() if isinstance(m, ConvTranspose1d)})
    save_reference_ckpt(work / "run.ckpt", sd)
    ckpt_s, ckpt_mb = time.perf_counter() - t0, (work / "run.ckpt").stat().st_size / 2**20
    # the same weights as a port run, exported alike: the referee of the imported artifact
    (work / "source").mkdir()
    (work / "source" / "config.json").write_text(config_lib.snapshot(cfg))
    state = create_train_state(cfg, device="cpu")
    state.model.load_state_dict(source.state_dict())
    save_checkpoint(str(work / "source"), state)
    del state

    # the main path: import_torch -> export --streaming -> generate of a 30 s file
    wav = work / "in.wav"
    n = write_signal(wav, EXPORT_SECONDS, seed=25)
    seconds, counts = {}, {}

    def cli_step(step: str, args) -> str:
        before = dilated_unit.launches
        t0 = time.perf_counter()
        text = _cli([*args, "--device", "cuda"])
        torch.cuda.synchronize()
        seconds[step], counts[step] = time.perf_counter() - t0, dilated_unit.launches - before
        return text.strip().splitlines()[-1]

    torch.cuda.synchronize()
    dilated_unit.launches = dilated_unit.launches_bf16 = 0
    with UnitShapes() as shapes:
        run_dir = Path(cli_step("import_torch", [
            "import_torch", "--ckpt", work / "run.ckpt", "--config", gin, "--name", "imported",
            "--out_path", work / "runs"]).removeprefix("imported into: "))
        art_path = Path(cli_step("export", ["export", "--streaming", "--run", run_dir,
                                            "--output", work / "art"]).removeprefix("exported: "))
        cli_step("generate", ["generate", "--model", art_path, "--input", wav, "--out_path",
                              work / "gen"])
    launches = dilated_unit.launches
    check(counts == {"import_torch": 0, "export": UNITS_PER_HALF, "generate": 22}
          and dilated_unit.launches_bf16 == 0 and len(shapes.seen) == launches,
          f"import path launches {counts} ({len(shapes.seen)} unit calls seen); expected "
          f"import_torch 0, export {UNITS_PER_HALF} (its smoke decode), generate 22")
    gen_units = sorted(shapes.seen[-counts["generate"]:])
    check(gen_units == sorted(v2_unit_shapes(1, -(-n // 2048) * 2048) * 2),
          f"generate's unit shapes {gen_units}")

    # the imported model and artifact against the source's
    _cli(["export", "--streaming", "--run", work / "source", "--output", work / "src_art",
          "--device", "cuda"])
    x = load_signal(decode_file(str(wav), SAMPLE_RATE, 1), 1, 1, 2048).cuda()
    clip = x[..., : 64 * 2048]
    _, imported, _, _ = load_run(str(run_dir), device="cuda")
    src = source.cuda().eval()
    with torch.inference_mode(), fp32_exact():
        y = {}
        for key, m in (("imported", imported), ("source", src)):
            z = m.encode(clip)
            y[key] = m.decode(z[:, : cfg.latent_size])
        model_err = rel_err(y["imported"], y["source"])
    art = ExportedRAVE(str(art_path), device="cuda")
    src_art = ExportedRAVE(str(work / "src_art" / art_path.name), device="cuda")
    with fp32_exact():
        art_err = rel_err(art.forward(clip, seed=5), src_art.forward(clip, seed=5))
    check(model_err <= IMPORT_TOL and art_err <= IMPORT_TOL,
          f"imported vs source: model forward {model_err:.3e}, artifact {art_err:.3e} > "
          f"{IMPORT_TOL}")
    p50 = _block_p50(art, x)
    budget = art.block_size / SAMPLE_RATE * 1e3
    check(max(p50.values()) < budget, f"imported artifact's streaming p50 {p50} over the "
                                      f"{budget:.2f} ms budget")
    sr, y_wav = wavfile.read(work / "gen" / "in_reconstructed.wav")
    check(sr == SAMPLE_RATE and y_wav.shape == (n,) and abs(y_wav).max() > 0,
          f"generated wav {sr} Hz {y_wav.shape}")

    gen = torch.Generator(device="cuda").manual_seed(26)
    rows = {shape: kernel_row(gen, "import", *shape) for shape in sorted(set(shapes.seen))}
    path = [rows[shape] for shape in shapes.seen]  # one per launch
    unit_path = {"shapes": len(rows), "ms": sum(r["ms"] for r in path),
                 "plain_ms": sum(r["plain_ms"] for r in path),
                 "bound_ms": sum(unit_bound([r], r["B"], "fp32")["bound_ms"] for r in path),
                 "max_abs_err": max(r["max_abs_err"] for r in path),
                 "max_rel_err": max(r["rel_err"] for r in path)}
    shutil.rmtree(work, ignore_errors=True)
    out = {"launches": launches, "launches_by_step": counts, "seconds_by_step": seconds,
           "ckpt_s": ckpt_s, "ckpt_mb": ckpt_mb, "reference_tensors": len(sd),
           "model_rel_err": model_err, "artifact_rel_err": art_err, "block_ms_p50": p50,
           "block_budget_ms": budget, "realtime_factor_generate": n / SAMPLE_RATE
           / seconds["generate"], "unit_rows": list(rows.values()), "unit_path": unit_path,
           "seconds": time.perf_counter() - t_phase}
    print(f"import: v2 at full width ({len(sd)} reference tensors, {ckpt_mb:.1f} MiB .ckpt in "
          f"{ckpt_s:.1f} s) -> cli import_torch --config {gin.name} {seconds['import_torch']:.1f} s"
          f", export --streaming {seconds['export']:.1f} s, generate {EXPORT_SECONDS:g} s "
          f"{seconds['generate']:.2f} s ({out['realtime_factor_generate']:.1f}x); launches "
          f"{counts}; imported vs source forward {model_err:.2e}, artifact {art_err:.2e} <= "
          f"{IMPORT_TOL}; streaming p50 eager {p50['eager']:.3f} ms, .pt2 {p50['program']:.3f} "
          f"ms (budget {budget:.2f}); unit at {len(rows)} shapes: max rel err "
          f"{unit_path['max_rel_err']:.1e}, its {launches} launches {unit_path['ms']:.3f} ms "
          f"(plain {unit_path['plain_ms']:.3f}, bound {unit_path['bound_ms']:.3f}); "
          f"{out['seconds']:.1f} s", flush=True)
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
    export = phase_export(ROOT / loop["run_dir"])
    prior = phase_prior(ROOT / loop["run_dir"], ROOT / "build" / "loop" / "db")
    v1 = phase_v1(ROOT / loop["run_dir"], ROOT / "build" / "loop" / "db")
    shutil.rmtree(ROOT / "build" / "loop" / "runs", ignore_errors=True)  # ~0.7 GB per checkpoint
    shutil.rmtree(ROOT / "build" / "loop" / "export", ignore_errors=True)
    spectral = phase_spectral(tuple(train["crop_frames"]))
    imported = phase_import()
    discrete = phase_discrete()
    variants = phase_variants()
    v3 = phase_v3()
    foreign = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "rave_tpu"))
    check(not foreign, f"the port loaded the JAX package or jax: {foreign[:5]}")

    # one main-path call's 22 units: each centered shape in encoder and decoder
    main_rows = [r for r in rows if r["case"] == "main" and r["mode"] == "centered"] * 2
    main_bf16 = [r for r in rows_bf16 if r["case"] == "main" and r["mode"] == "centered"
                 and r["B"] == TRAIN_BATCH] * 2
    bound32 = unit_bound(main_rows, BATCH, "fp32")
    bound16 = unit_bound(main_bf16, TRAIN_BATCH, "bf16")
    export_rows = export["unit_b1"] * 2  # generate's forward: each shape in encoder and decoder
    # the discrete forward's 22 units at B=16: v2's shapes but C=768 at T=256
    discrete_rows = [r for r in main_rows if r["C"] != 768] + [
        r for r in discrete["kernel_rows"] if r["B"] == BATCH] * 2
    bounds = {"fp32_b16_forward": bound32, "bf16_b8_forward": bound16,
              "fp32_b1_generate_forward": unit_bound(export_rows, 1, "fp32"),
              "fp32_b16_discrete_forward": unit_bound(discrete_rows, BATCH, "fp32"),
              **{f"{k}_b8_fwd_bwd": unit_bound(grad[k] * 2, TRAIN_BATCH, k, backward=True)
                 for k in ("fp32", "bf16")}}
    # each variant's forward: its units at B=16 (fp32, its path) and B=8 (bf16)
    variant_units = {f"{p}_{kind}": unit_rows_of(r, p, b) for p in VARIANTS
                     for kind, r, b in (("fp32_b16", rows, BATCH), ("bf16_b8", rows_bf16,
                                                                     TRAIN_BATCH))}
    bounds.update({f"{k}_forward": unit_bound(v, BATCH if "b16" in k else TRAIN_BATCH,
                                              k.split("_")[-2])
                   for k, v in variant_units.items()})
    print("bounds (a forward's units): " + "; ".join(
        f"{k} {b['bound_ms']:.3f} ms ({b['bound_by']})" for k, b in bounds.items()), flush=True)

    def per_variant(kind: str) -> dict:
        return {key: {p: (sum(r[key] for r in variant_units[f"{p}_{kind}"]) if key != "bound_ms"
                          else bounds[f"{p}_{kind}_forward"]["bound_ms"]) for p in VARIANTS}
                for key in ("ms", "plain_ms", "bound_ms")}
    kernels = {"kernels": [{
        "name": "fused_dilated_unit", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": offline["launches"],
        "launches_train": train["launches"], "launches_remat_step": remat["remat_launches"],
        "launches_loop": loop["launches"]["fp32"],
        "launches_export": export["generate_launches"],
        "launches_discrete": discrete["launches"],
        "launches_v3": v3["launches"],  # Snake units bypass the kernel, as in rave_tpu
        "launches_variants": variants["launches"],
        "launches_v1": v1["launches"],  # v1 has no DilatedUnit, as in rave_tpu
        "launches_onnx_verify": v1["launches_onnx_verify"],  # the v2 run's live forward
        # v2 + spectral_discriminator and the other distances: 22 per step
        "launches_spectral": spectral["launches"] - spectral["launches_bf16"],
        # import_torch 0, export's smoke decode 11, generate's forward 22
        "launches_import": imported["launches"],
        **{f"{k}_import": imported["unit_path"][k] for k in ("ms", "plain_ms", "bound_ms",
                                                            "max_abs_err")},
        **{f"{k}_onnx_verify": v1["onnx"]["v2"]["unit_path"][k]
           for k in ("ms", "plain_ms", "bound_ms", "max_abs_err")},
        "launches_prior": prior["launches"],  # train_prior, export --prior, generate
        **{f"{k}_prior": prior["unit_path"][k] for k in ("ms", "plain_ms", "bound_ms",
                                                          "max_abs_err")},
        **{f"{k}_variants_b16": v for k, v in per_variant("fp32_b16").items()},
        "ms_discrete_b16": sum(r["ms"] for r in discrete_rows),
        "plain_ms_discrete_b16": sum(r["plain_ms"] for r in discrete_rows),
        "bound_ms_discrete_b16": bounds["fp32_b16_discrete_forward"]["bound_ms"],
        "ms_export_b1": sum(r["ms"] for r in export_rows),
        "plain_ms_export_b1": sum(r["plain_ms"] for r in export_rows),
        "bound_ms_export_b1": bounds["fp32_b1_generate_forward"]["bound_ms"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": sum(r["ms"] for r in main_rows), "plain_ms": sum(r["plain_ms"] for r in main_rows),
        "bound_ms": bound32["bound_ms"], "bound_by": bound32["bound_by"], "library_ms": None,
    }, {
        "name": "fused_dilated_unit_bf16", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": train_bf16["launches"],
        "launches_loop": loop["launches"]["bf16"],
        "launches_spectral": spectral["launches_bf16"],  # the bf16 steps of phase spectral
        **{f"{k}_variants_b8": v for k, v in per_variant("bf16_b8").items()},
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
         "train_bf16": train_bf16, "remat": remat, "loop": loop, "export": export,
         "prior": prior, "discrete": discrete, "v3": v3, "variants": variants, "v1": v1,
         "spectral": spectral, "import": imported,
         **kernels},
        indent=1))
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
