"""The training driver (the Lightning Trainer equivalent).

PyTorch port of rave_tpu/train/loop.py: channel inference, the dataset and
its split, the input pipeline (the device-resident store, or the host
loader with pinned, non-blocking transfers two batches ahead), the
receptive field and valid-signal crop, the train state and its resume, the
three step programs picked per global step, validation with the latent PCA,
EMA, checkpoints and logging, in the order the JAX loop runs them.

As in the JAX package, a step's randomness depends on the global step only:
its reparametrization noise comes from `fold_in(seed + 1, step)` and the
device pipeline's batch from `fold_in(seed, step)` (utils/rng.py), so a
resumed run draws what an unbroken run would. Validation draws its noise
from seed 1234 for every batch, as the JAX loop's `key(1234)`.

Only the steps that log (1, 2 and every 100th) read a tensor back to the
host; the others queue their work and go on. `train` runs with TF32 off for
cuDNN convolutions and matmuls (restored on return): fp32 means fp32 here.

Not ported: the C++ sampler (the port uses the host `Loader` where the JAX
loop would pick it, ROADMAP A17), remote datasets (A18), multi-host data
parallelism (A14) and the codebook health of the discrete family (A9).
"""
from __future__ import annotations

import collections
import contextlib
import os
import time
from pathlib import Path
from typing import Iterator, Optional

import numpy as np
import torch

from rave_tpu_torch import config as config_lib
from rave_tpu_torch.config import RaveConfig
from rave_tpu_torch.data.dataset import get_dataset, split_dataset
from rave_tpu_torch.data.loader import Loader
from rave_tpu_torch.data.store import get_training_channels, read_metadata
from rave_tpu_torch.data.transforms import get_derivator_integrator
from rave_tpu_torch.factory import build_audio_distance, resolve_device
from rave_tpu_torch.train.analysis import crop_frames, pca, receptive_field
from rave_tpu_torch.train.state import TrainState, create_train_state
from rave_tpu_torch.train.steps import build_train_steps, draw_noise, pick_phase
from rave_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from rave_tpu_torch.utils.logging import MetricsLogger
from rave_tpu_torch.utils.rng import step_generator

VAL_NOISE_SEED = 1234
DEVICE_DATA_BUDGET_GB = 4.0  # RAVE_TPU_DEVICE_DATA_MAX_GB's default, as in the JAX loop
PREFETCH = 2  # batches in flight ahead of the step


@contextlib.contextmanager
def fp32_exact():
    """TF32 off for cuDNN convolutions and CUDA matmuls, restored on exit."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def make_run_dir(root: str, name: str, cfg: RaveConfig) -> Path:
    run_dir = Path(root) / f"{name}_{config_lib.config_hash(cfg)}"
    run_dir.mkdir(parents=True, exist_ok=True)
    (run_dir / "config.json").write_text(config_lib.snapshot(cfg))
    return run_dir


def standard_pipeline(cfg: RaveConfig) -> bool:
    """Crop, mangle and dither only: what the device pipeline can serve."""
    d = cfg.data
    return not (d.augmentations or d.derivative or d.normalize or d.rand_pitch)


def use_device_data(cfg: RaveConfig, db_path: str, device_data: str) -> bool:
    """The JAX loop's rule (rave_tpu/train/loop.py:112-126): the device pipeline unless
    it is off, the pipeline is not the standard one, the store is lazy, or (on
    'auto') the store is larger than $RAVE_TPU_DEVICE_DATA_MAX_GB."""
    if device_data == "off" or not standard_pipeline(cfg):
        return False
    if read_metadata(db_path).get("lazy", False):
        return False
    from rave_tpu_torch.data.device_data import db_nbytes

    budget = float(os.environ.get("RAVE_TPU_DEVICE_DATA_MAX_GB", DEVICE_DATA_BUDGET_GB)) * 1e9
    return device_data == "on" or db_nbytes(db_path) <= budget


def host_batches(batches: Iterator[np.ndarray], device: torch.device) -> Iterator[torch.Tensor]:
    """Host [B, C, T] batches onto `device`, PREFETCH transfers in flight: from
    pinned memory with non_blocking copies on a card, so the copy overlaps
    the running step."""
    pin = device.type == "cuda"
    queue: collections.deque = collections.deque()
    for x in batches:
        t = torch.from_numpy(x)
        queue.append((t.pin_memory() if pin else t).to(device, non_blocking=True))
        if len(queue) >= PREFETCH:
            yield queue.popleft()
    while queue:
        yield queue.popleft()


def device_batches(pipeline, start: int) -> Iterator[torch.Tensor]:
    """The device pipeline's batches from global step `start` on, PREFETCH
    queued ahead so their assembly overlaps the step."""
    queue: collections.deque = collections.deque()
    step = start
    while True:
        while len(queue) < PREFETCH:
            queue.append(pipeline.batch_at(step))
            step += 1
        yield queue.popleft()


@contextlib.contextmanager
def ema_weights(model: torch.nn.Module, ema: Optional[dict]):
    """The model with the EMA weights in place of the trained ones, which are
    put back on exit (no-op without an EMA)."""
    if ema is None:
        yield
        return
    params = dict(model.named_parameters())
    with torch.no_grad():
        trained = {n: p.detach().clone() for n, p in params.items()}
        for n, p in params.items():
            p.copy_(ema[n])
    try:
        yield
    finally:
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(trained[n])


def run_validation(cfg: RaveConfig, state: TrainState, loader: Loader, distance, logger,
                   step: int, eval_number: int, max_batches: Optional[int] = None):
    """One pass over the validation split (or its first `max_batches`) with
    the EMA weights when the run keeps them (reference rave/model.py:426-495):
    logs `validation` and 8 clips; returns (mean loss, [N, D] latent means)."""
    model = state.model
    device = next(model.parameters()).device
    D = cfg.latent_size
    n_batches = len(loader) if max_batches is None else min(len(loader), max_batches)
    losses, latents, clips = [], [], []
    with ema_weights(model, state.ema), torch.inference_mode():
        for b, x in enumerate(loader.epoch(0)):
            if b >= n_batches:
                break
            x = torch.from_numpy(x).to(device)
            z = model.encode(x)
            eps = draw_noise(cfg, x, torch.Generator(device=device).manual_seed(VAL_NOISE_SEED))
            zs, _ = model.reparametrize(z, eps=eps)
            y = model.decode(zs)[..., : x.shape[-1]]
            losses.append(sum(distance(x, y).values()))
            latents.append(z[:, :D].transpose(1, 2).reshape(-1, D))
            if sum(c.shape[0] for c in clips) < 8:
                clips.append(torch.cat([x, y], dim=-1))
    if not losses:
        return None, None
    val = float(np.mean(torch.stack(losses).cpu().numpy().astype(np.float64)))
    logger.log(step, {"validation": val})
    wav = torch.cat(clips)[:8, 0].reshape(-1).cpu().numpy()
    if cfg.data.derivative:  # derivative-domain audio integrated back (rave/model.py:491-492)
        wav = get_derivator_integrator(cfg.sampling_rate)[1](wav)
    logger.log_audio("audio_val", wav, cfg.sampling_rate, eval_number)
    return val, torch.cat(latents).cpu().numpy()


def set_pca_buffers(model: torch.nn.Module, latents: np.ndarray) -> np.ndarray:
    """latent_pca, latent_mean and fidelity from the validation latents; returns fidelity."""
    comp, mean, fidelity = pca(latents)
    with torch.no_grad():
        for name, value in (("latent_pca", comp), ("latent_mean", mean), ("fidelity", fidelity)):
            getattr(model, name).copy_(torch.from_numpy(value))
    return fidelity


@fp32_exact()
def train(
    cfg: RaveConfig,
    db_path: str,
    name: str = "run",
    out_path: str = "runs",
    n_channels: Optional[int] = None,
    max_steps: Optional[int] = None,
    val_every: int = 10000,
    save_every: Optional[int] = None,
    smoke_test: bool = False,
    seed: int = 0,
    resume: bool = True,
    progress: bool = True,
    trace_steps: int = 0,
    device_data: str = "auto",
    device: str | torch.device = "cuda",
) -> str:
    """Train `cfg` on the ARS store at `db_path` into `<out_path>/<name>_<hash>`
    (resuming from its newest checkpoint when `resume`); returns the run dir."""
    device = resolve_device(device)
    channels = get_training_channels(db_path, n_channels)
    cfg.data.n_channels = channels  # recorded in the config snapshot
    run_dir = make_run_dir(out_path, name, cfg)

    d = cfg.data
    dataset = get_dataset(db_path, cfg.sampling_rate, d.n_signal, derivative=d.derivative,
                          normalize=d.normalize, rand_pitch=d.rand_pitch,
                          augmentations=d.augmentations)
    train_idx, val_idx = split_dataset(dataset)
    on_device = use_device_data(cfg, db_path, device_data)
    if not on_device and standard_pipeline(cfg) and progress:
        print("the native (C++) input pipeline is not ported (ROADMAP A17): "
              "using the threaded host loader")
    val_loader = Loader(dataset, val_idx, d.batch, seed=seed, shuffle=False, drop_last=False)

    # receptive field -> the valid-signal crop of the multiband loss
    crop, rf = (0, 0), (0, 0)
    if cfg.train.valid_signal_crop:
        t0 = time.time()
        rf = receptive_field(cfg, n_channels=channels, device=device)
        crop = crop_frames(cfg, rf, channels)
        if crop[0] + crop[1] >= d.n_signal // cfg.n_band:
            raise ValueError(
                f"n_signal={d.n_signal} leaves no valid signal after cropping the model's "
                f"receptive field ({rf[0]}+{rf[1]} samples) — raise --n_signal or disable "
                "train.valid_signal_crop")
        if progress:
            ms = 1000 / cfg.sampling_rate
            print(f"receptive field: {rf[0] * ms:.1f}ms <- x -> {rf[1] * ms:.1f}ms "
                  f"({time.time() - t0:.0f}s)")

    state = create_train_state(cfg, n_channels=channels, seed=seed, device=device)
    if resume and restore_checkpoint(str(run_dir), state) is not None and progress:
        print(f"resumed at step {state.step}")
    with torch.no_grad():
        state.model.receptive_field.copy_(torch.tensor(rf, dtype=torch.float32))
    steps = build_train_steps(cfg, crop)
    distance = build_audio_distance(cfg)

    max_steps = max_steps or cfg.train.max_steps
    if smoke_test:
        max_steps = min(max_steps, state.step + 2)
        val_every = 1
    step = state.step
    if on_device:
        from rave_tpu_torch.data.device_data import DeviceDataPipeline, db_nbytes

        pipeline = DeviceDataPipeline(db_path, train_idx, d.batch, d.n_signal,
                                      cfg.sampling_rate, seed=seed, device=device)
        if progress:
            print(f"using the device-resident dataset ({db_nbytes(db_path) / 1e9:.2f} GB "
                  f"int16 on {device}, batches assembled there)")
        data = device_batches(pipeline, step)
    else:
        loader = Loader(dataset, train_idx, d.batch, seed=seed, workers=d.workers)
        data = host_batches(loader.forever(), device)

    best_val, saved_at, eval_number = float("inf"), -1, 0
    t_last, s_last = time.time(), step
    trace_start = step + 3 if trace_steps else -1
    profiler = None
    logger = MetricsLogger(str(run_dir))
    try:
        logger.log_text("config", config_lib.snapshot(cfg))
        logger.log_text("model", f"{state.model}\n\n{state.discriminator}")
        while step < max_steps:
            if step == trace_start:
                profiler = start_trace(device)
            elif profiler is not None and step >= trace_start + trace_steps:
                stop_trace(profiler, run_dir, progress)
                profiler = None
            x = next(data)
            which, warmed, _ = pick_phase(cfg, step)
            eps = draw_noise(cfg, x, step_generator(seed + 1, step, device))
            if which == "gen":
                metrics = steps["gen"](state, x, warmed, eps=eps)
            else:
                metrics = steps["dis"](state, x, eps=eps)
            step = state.step

            if step % 100 == 0 or step <= 2:  # the only host reads of a step's tensors
                m = {k: float(v) for k, v in metrics.items()}
                m["steps_per_sec"] = (step - s_last) / max(time.time() - t_last, 1e-9)
                t_last, s_last = time.time(), step
                logger.log(step, m)
                logger.update_status(step=step, warmed=bool(warmed))
                if progress:
                    print(f"step {step} [{which}] loss_gen={m.get('loss_gen', 0):.3f} "
                          f"loss_dis={m.get('loss_dis', 0):.3f} "
                          f"({m['steps_per_sec']:.2f} it/s)", flush=True)

            if step % val_every == 0 or step == max_steps:
                val_loss, latents = run_validation(
                    cfg, state, val_loader, distance, logger, step, eval_number,
                    max_batches=2 if smoke_test else None)
                eval_number += 1
                # the PCA buffers before any save at this step, so the saved
                # model carries this validation's PCA (pre-warmup only)
                if latents is not None and not warmed and cfg.latent.family == "variational":
                    fidelity = set_pca_buffers(state.model, latents)
                    for p in (0.8, 0.9, 0.95, 0.99):
                        logger.log(step, {f"fidelity_{p}": float(np.argmax(fidelity > p))})
                if val_loss is not None and val_loss <= best_val:
                    best_val = val_loss
                    save_checkpoint(str(run_dir), state)
                    saved_at = step
            if save_every and step % save_every == 0 and saved_at != step:
                save_checkpoint(str(run_dir), state)
                saved_at = step
    finally:
        if profiler is not None:  # the window outlived the run: still write the trace
            stop_trace(profiler, run_dir, progress)
        logger.close()
    if saved_at != step:
        save_checkpoint(str(run_dir), state)
    return str(run_dir)


def start_trace(device: torch.device):
    """A torch.profiler window over the next steps (the Lightning
    profiler="simple" analog); the device's activity too on a card."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    return profiler


def stop_trace(profiler, run_dir: Path, progress: bool) -> None:
    profiler.stop()
    out = Path(run_dir) / "trace"
    out.mkdir(exist_ok=True)
    profiler.export_chrome_trace(str(out / "trace.json"))
    if progress:
        print(f"profiler trace written to {out}")
