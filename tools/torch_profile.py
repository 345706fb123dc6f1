#!/usr/bin/env python3
"""Where the device time goes in rave_tpu_torch's serving paths and training steps.

    python3 tools/torch_profile.py [--out profile.txt] [--top 18] [--cells a,b,...]

from the root of a checkout, on a machine with a CUDA card and nvcc. The
cells, all `compose` presets at full width with seeded random weights, fp32
with TF32 off where they run fp32 (`--cells` picks some; the first four by
default):

  offline : compose(["v2"]), B=16 x 131072 samples, 3 forwards profiled
            (under `torch.inference_mode()`, as the next cell);
  stream  : compose(["v2", "causal"]), batch 1, blocks of block_size()
            through step_encode -> step_decode: 4 warm, 8 timed, 12 profiled;
  train   : compose(["v2"]), B=8 x 131072, one step of each phase (pre-warmup
            generator, adversarial generator, critic): 1 warm, 3 timed and
            1 profiled each. The fused unit's share of a step is the device
            time of its forward and of its gradient's kernel, each of which
            this tool wraps in a `record_function` range; the convolutions'
            share is that of every cuDNN kernel (the convolutions of critic
            and generator and their layout transforms);
  train_bf16 : the same with train.bf16 and train.bf16_dis (the CLI's
            `--bf16`), the fused unit's bf16 kernel;
  artifact_v2, artifact_discrete : the artifact's eager streaming block,
            `StepProgram("forward")` over `EncodeSide` / `DecodeSide` with the
            kernels fixed, as `ExportedRAVE.forward(streaming=True)` runs it, for
            compose(["v2"]) (2048 samples) and compose(["discrete"]) (1024
            samples: its latent codec is the RVQ's 16 encode and 16 decode
            stages): 4 warm, 8 timed, 12 profiled;
  train_discrete : the `train` cell for compose(["discrete"]); its warm
            step runs the k-means init, the timed and profiled steps the
            EMA codebooks;
  train_v3, artifact_v3 : the `train` and artifact cells for
            compose(["v3"]) (Snake units, which bypass the fused kernel, AdaIN,
            the descript critic); its 2048-sample block streams through
            AdaIN's statistics, learning off;
  offline_<p>, train_<p>, artifact_<p> for p in v2_small, v2_nopqmf,
            hybrid : the `offline`, `train` and artifact cells for the v2
            variants (the noise synth; raw-waveform output; mel input and a
            GRU); hybrid's train cell without the valid-signal crop, which
            empties its multiband loss (ROADMAP C12);
  train_spectral, train_spectral_bf16 : the `train` and `train_bf16` cells
            for compose(["v2", "spectral_discriminator"]) (the multiscale
            critic beside EncodecConvNets on the complex STFTs), the critic's
            forward range splitting its share;
  prior_step : one autoregressive step of the stock prior (prior_v1.gin) at
            latent_size 128 (4096 channels, the latent size of the v2 run
            in chip_smoke.py's phase `prior`), `PriorStep` as the
            artifact's `prior_step.pt2` runs it, each step's frame fed
            back: 4 warm, 8 timed, 12 profiled.

Every train cell also reports the critic's forward (the kernels launched
under a `record_function` range around it) beside cuDNN's share.

Each cell is timed unprofiled first (host clock around work that ends in
`synchronize`), then traced by `torch.profiler` with CPU and CUDA activity.
From the trace's device events (kernels and copies on the card, each counted
once) it prints the device-busy time per call (the union of their
intervals), the busy share of the unprofiled wall, the device ops per call,
and the kernels that take the most device time, by name.
"""
from __future__ import annotations

import argparse
import re
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def device_summary(prof, calls: int, wall_ms: float, top: int) -> list[str]:
    from torch.autograd import DeviceType

    # kernels and copies only: `record_function` ranges (Adam's step, the unit's
    # backward) also appear as device events, spanning the kernels they launch
    events = [e for e in prof.events()
              if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    if not events:
        raise SystemExit("torch_profile: the profiler saw no device events")
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy_us, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy_us += cur_e - cur_s
    by_name = defaultdict(lambda: [0.0, 0])
    for e in events:
        by_name[e.name][0] += e.time_range.end - e.time_range.start
        by_name[e.name][1] += 1
    busy_ms = busy_us / 1e3 / calls
    lines = [f"device busy {busy_ms:.3f} ms per call = {100 * busy_ms / wall_ms:.1f}% of the "
             f"unprofiled wall {wall_ms:.3f} ms; {len(events) / calls:.0f} device ops per call"]
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        ms = us / 1e3 / calls
        lines.append(f"  {ms:8.3f} ms {100 * ms / busy_ms:5.1f}%  x{n / calls:6.1f}  {name[:110]}")
    return lines


# the fused unit's kernels (csrc/dilated_unit.cu): its weight preparations, the unit (the
# forward's and the gradient's launches) and the weight gradients (one launch per call)
WGRAD_KERNEL = re.compile(r"wgrad_wgmma_kernel")
UNIT_KERNEL = re.compile(r"unit_kernel|prepare_weights|wgrad_wgmma_kernel")
# cuDNN's kernels by name: convolutions (forward, data and weight gradients)
# and the layout transforms around them; the unit's own kernels are not cuDNN's
CONV_KERNEL = re.compile(r"^(?!.*(?:unit_kernel|prepare_weights|wgrad_wgmma_kernel))"
                         r".*(?:xmma|fprop|dgrad|wgrad|implicit_gemm|cudnn|convolve|conv[12]d)",
                         re.I)


def kernel_ms(prof, calls: int, pattern) -> float:
    from torch.autograd import DeviceType

    return sum(e.time_range.end - e.time_range.start for e in prof.events()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation
               and pattern.search(e.name)) / 1e3 / calls


def range_ms(prof, calls: int, name: str) -> float:
    """Device time of the kernels launched under the `record_function` range
    `name`: the range's own device total where the profiler keeps one on the
    CPU event, else that of the device events that start inside the range's
    spans on the device timeline (its GPU user annotations)."""
    from torch.autograd import DeviceType

    events = prof.events()
    total = sum(e.device_time_total for e in events
                if e.device_type == DeviceType.CPU and e.name == name)
    if total == 0:
        spans = sorted((e.time_range.start, e.time_range.end) for e in events
                       if e.device_type == DeviceType.CUDA and e.is_user_annotation
                       and e.name == name)
        total = sum(e.time_range.end - e.time_range.start for e in events
                    if e.device_type == DeviceType.CUDA and not e.is_user_annotation
                    and any(a <= e.time_range.start < b for a, b in spans))
    return total / 1e3 / calls


def unit_share(prof, calls: int, busy_ms: float) -> str:
    """Device time of the fused unit per call (the kernels under the
    `record_function` ranges of its forward, either variant, and of its
    gradient's kernels; the weight gradients' kernel apart), that of cuDNN's
    kernels (convolutions and their layout transforms), and that of the
    critic's forward (the kernels under its range)."""
    fwd = range_ms(prof, calls, FORWARD_RANGE)
    bwd = range_ms(prof, calls, BACKWARD_RANGE)
    unit = kernel_ms(prof, calls, UNIT_KERNEL)
    wgrad = kernel_ms(prof, calls, WGRAD_KERNEL)
    conv = kernel_ms(prof, calls, CONV_KERNEL)
    critic = range_ms(prof, calls, CRITIC_RANGE)
    return (f"fused unit: forward kernel {fwd:.3f} ms + backward kernel {bwd:.3f} ms = "
            f"{fwd + bwd:.3f} ms per call (its kernels by name {unit:.3f} ms, of which the "
            f"backward's weight gradients {wgrad:.3f} ms), "
            f"{100 * (fwd + bwd) / busy_ms:.1f}% of device busy; "
            f"cuDNN convolutions and layout transforms {conv:.3f} ms, "
            f"{100 * conv / busy_ms:.1f}%; the critic's forward {critic:.3f} ms, "
            f"{100 * critic / busy_ms:.1f}%")


FORWARD_RANGE = "fused_dilated_unit.forward"
BACKWARD_RANGE = "fused_dilated_unit.backward"
CRITIC_RANGE = "critic.forward"


def train_cell(activities, top: int, overrides=(), names=("v2",)) -> list[str]:
    import torch
    from torch.profiler import profile, record_function

    from rave_tpu_torch.config import compose
    from rave_tpu_torch.ops.kernels import dilated_unit
    from rave_tpu_torch.train.analysis import crop_frames, receptive_field
    from rave_tpu_torch.train.state import create_train_state
    from rave_tpu_torch.train.steps import build_train_steps

    forward, backward = dilated_unit._forward, dilated_unit._backward

    def traced_forward(*args):
        with record_function(FORWARD_RANGE):
            return forward(*args)

    def traced_backward(*args):
        with record_function(BACKWARD_RANGE):
            return backward(*args)

    dilated_unit._forward, dilated_unit._backward = traced_forward, traced_backward
    cfg = compose(list(names), list(overrides))
    rf = receptive_field(cfg, device="cuda") if cfg.train.valid_signal_crop else (0, 0)
    steps = build_train_steps(cfg, crop_frames(cfg, rf))
    state = create_train_state(cfg, seed=0, device="cuda")
    critic_forward = state.discriminator.forward

    def traced_critic(x):
        with record_function(CRITIC_RANGE):
            return critic_forward(x)

    state.discriminator.forward = traced_critic
    x = torch.randn(cfg.data.batch, 1, cfg.data.n_signal, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(6)) * 0.1
    noise = torch.Generator(device="cuda").manual_seed(7)
    phases = {
        "gen pre-warmup": lambda: steps["gen"](state, x, False, generator=noise),
        "gen adversarial": lambda: steps["gen"](state, x, True, generator=noise),
        "dis": lambda: steps["dis"](state, x, generator=noise),
    }
    lines = []
    for name, step in phases.items():
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 3 * 1e3
        with profile(activities=activities) as prof:
            step()
            torch.cuda.synchronize()
        summary = device_summary(prof, 1, wall, top)
        busy_ms = float(summary[0].split()[2])
        lines += [f"== train {'+'.join(names)} {' '.join(overrides)} B={cfg.data.batch} x "
                  f"{cfg.data.n_signal}, {name} step"]
        lines += summary[:1] + [unit_share(prof, 1, busy_ms)] + summary[1:]
    dilated_unit._forward, dilated_unit._backward = forward, backward
    return lines


def offline_cell(activities, top: int, names=("v2",)) -> list[str]:
    import torch
    from torch.profiler import profile

    from rave_tpu_torch.config import compose
    from rave_tpu_torch.factory import build_rave
    from rave_tpu_torch.ops.kernels import dilated_unit
    from rave_tpu_torch.train.steps import draw_noise

    with torch.inference_mode():
        cfg = compose(list(names))
        model = build_rave(cfg, seed=0, device="cuda").eval()
        gen = torch.Generator(device="cuda").manual_seed(1)
        x = torch.randn(16, 1, 131072, device="cuda", generator=gen) * 0.1
        draws = draw_noise(cfg, x, gen)
        model(x, draws)
        before = dilated_unit.launches
        model(x, draws)
        units = dilated_unit.launches - before
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            model(x, draws)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 5 * 1e3
        with profile(activities=activities) as prof:
            for _ in range(3):
                model(x, draws)
            torch.cuda.synchronize()
    return ([f"== offline {'+'.join(names)} B=16 x 131072"] + device_summary(prof, 3, wall, top)
            + [f"fused unit kernels (weight preparation and unit, {units} calls): "
               f"{kernel_ms(prof, 3, UNIT_KERNEL):.3f} ms per forward"])


def block_cell(activities, top: int, title: str, block: int, step) -> list[str]:
    """`step(i)` runs block i: 4 warm (cuDNN picks its algorithms, the
    allocator fills), 8 timed one by one, 12 profiled."""
    import torch
    from torch.profiler import profile

    for i in range(4):
        step(i)
    times = []
    for i in range(4, 12):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(i)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    p50 = statistics.median(times)
    with profile(activities=activities) as prof:
        for i in range(12, 24):
            step(i)
        torch.cuda.synchronize()
    return ([f"== {title}, block {block}, unprofiled p50 {p50:.3f} ms "
             f"(blocks {', '.join(f'{t:.3f}' for t in times)})"]
            + device_summary(prof, 12, p50, top))


def stream_cell(activities, top: int) -> list[str]:
    import torch

    from rave_tpu_torch.config import compose
    from rave_tpu_torch.factory import build_rave
    from rave_tpu_torch.nn.streaming import init_stream_state

    with torch.inference_mode():
        cfg = compose(["v2", "causal"])
        model = build_rave(cfg, stream_batch=1, seed=4, device="cuda").eval()
        block = cfg.block_size()
        x = torch.randn(1, 1, block * 24, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(5)) * 0.1
        init_stream_state(model, 1)

        def step(i):
            z = model.step_encode(x[..., i * block:(i + 1) * block])
            return model.step_decode(z[:, :cfg.latent_size])

        return block_cell(activities, top, "stream v2 causal", block, step)


def artifact_cell(activities, top: int, names) -> list[str]:
    import torch

    from rave_tpu_torch.config import compose
    from rave_tpu_torch.export.artifact import (
        DecodeSide, EncodeSide, StepProgram, initial_state,
    )
    from rave_tpu_torch.export.export import user_latent_size
    from rave_tpu_torch.factory import build_rave
    from rave_tpu_torch.nn.conv import freeze_weights

    cfg = compose(list(names))
    model = build_rave(cfg, stream_batch=1, seed=4, device="cuda").eval().requires_grad_(False)
    freeze_weights(model)  # as ExportedRAVE serves it
    latent_size = (cfg.latent_size if cfg.latent.family == "variational"  # untruncated
                   else user_latent_size(cfg, None, 0.0))
    program = StepProgram("forward", model, EncodeSide(model, cfg, latent_size),
                          DecodeSide(model, cfg, latent_size))
    block = cfg.block_size()
    x = torch.randn(1, 1, block * 24, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(5)) * 0.1
    state = [initial_state(model)]
    seed = torch.tensor(0, dtype=torch.int64, device="cuda")

    def step(i):
        y, state[0] = program(state[0], x[..., i * block:(i + 1) * block], seed)
        return y

    with torch.inference_mode():
        return block_cell(activities, top, f"artifact {'+'.join(names)} streaming forward",
                          block, step)


def prior_step_cell(activities, top: int) -> list[str]:
    import torch

    from rave_tpu_torch.export.artifact import PriorStep, initial_state, prior_step_seed
    from rave_tpu_torch.prior.model import build_prior

    prior = build_prior(128, seed=0, device="cuda").eval().requires_grad_(False)
    program = PriorStep(prior)
    carry = [initial_state(prior), torch.zeros(1, prior.latent_size * prior.resolution, 1,
                                               device="cuda")]

    def step(i):
        seed = torch.tensor(prior_step_seed(1, i), dtype=torch.int64, device="cuda")
        carry[1], carry[0] = program(carry[0], carry[1], seed)
        return carry[1]

    with torch.inference_mode():
        return block_cell(activities, top, "prior_step, the stock prior at latent 128", 1, step)


CELLS = {
    "offline": offline_cell,
    "prior_step": prior_step_cell,
    "stream": stream_cell,
    "train": lambda act, top: train_cell(act, top),
    "train_bf16": lambda act, top: train_cell(act, top, ["train.bf16=true",
                                                         "train.bf16_dis=true"]),
    "artifact_v2": lambda act, top: artifact_cell(act, top, ["v2"]),
    "artifact_discrete": lambda act, top: artifact_cell(act, top, ["discrete"]),
    "train_discrete": lambda act, top: train_cell(act, top, names=["discrete"]),
    "train_v3": lambda act, top: train_cell(act, top, names=["v3"]),
    "artifact_v3": lambda act, top: artifact_cell(act, top, ["v3"]),
    "train_spectral": lambda act, top: train_cell(act, top,
                                                  names=["v2", "spectral_discriminator"]),
    "train_spectral_bf16": lambda act, top: train_cell(
        act, top, ["train.bf16=true", "train.bf16_dis=true"], ["v2", "spectral_discriminator"]),
}
for _p in ("v2_small", "v2_nopqmf", "hybrid"):
    _crop = ["train.valid_signal_crop=false"] if _p == "hybrid" else []
    CELLS[f"offline_{_p}"] = lambda act, top, p=_p: offline_cell(act, top, [p])
    CELLS[f"train_{_p}"] = lambda act, top, p=_p, o=_crop: train_cell(act, top, o, [p])
    CELLS[f"artifact_{_p}"] = lambda act, top, p=_p: artifact_cell(act, top, [p])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/profile.txt")
    ap.add_argument("--top", type=int, default=18)
    ap.add_argument("--cells", default="offline,stream,train,train_bf16",
                    help=f"comma-separated, of {', '.join(CELLS)}")
    args = ap.parse_args()
    cells = args.cells.split(",")
    unknown = [c for c in cells if c not in CELLS]
    if unknown:
        raise SystemExit(f"torch_profile: unknown cells {unknown}; known: {list(CELLS)}")
    sys.path.insert(0, str(ROOT))
    import torch
    from torch.profiler import ProfilerActivity

    if not torch.cuda.is_available():
        raise SystemExit("torch_profile: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    report = [card]
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for cell in cells:
        report += CELLS[cell](activities, args.top)
    text = "\n".join(report)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text + "\n")
    print(text, flush=True)


if __name__ == "__main__":
    main()
