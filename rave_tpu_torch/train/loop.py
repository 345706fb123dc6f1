"""The training driver (the Lightning Trainer equivalent).

PyTorch port of rave_tpu/train/loop.py: channel inference, the dataset and
its split, the input pipeline (the device-resident store, the C++ sampler
or the threaded host loader, the host loaders' batches moved with pinned,
non-blocking transfers two batches ahead; `input_pipeline`), the receptive
field and valid-signal crop, the train state and its resume, the three
step programs picked per global step, validation with the latent PCA,
EMA, checkpoints and logging, in the order the JAX loop runs them.

Under `torchrun` the loop is one rank of a data-parallel run
(parallel/mesh.py, rave_tpu/train/loop.py:85-150, 361-375, 401-440): each
rank loads its shard of the indices in batches of `data.batch`, the steps
run over the global batch, validation runs the same number of full
batches on every rank (`all_processes_min`) with the latents and clips
gathered in rank order, rank 0 computes the receptive field and shares
it, writes the run directory (the others wait for it), logs and saves,
and every rank restores the same checkpoint.

As in the JAX package, a step's randomness depends on the global step only:
its latent draws (the variational eps, the augmentation noise, the
codebooks' sample rows) come from `fold_in(seed + 1, step)` and the device
pipeline's batch from `fold_in(seed, step)` (utils/rng.py), so a resumed
run draws what an unbroken run would. Validation runs the model in eval
mode (the JAX loop's second, `train=False` model), draws its noise from
seed 1234 for every batch, as the JAX loop's `key(1234)`, and never trains
a codebook (the JAX `val_step` reparametrizes with `train=False`). With the
discrete family quantizing, each validation also logs `codebook_health`.

On one card the steps run as CUDA graphs (train/graphs.py::TrainGraphs, one
graph per program and key), as the JAX loop runs its jitted steps; under
data parallelism and on the CPU they run eagerly (`step_method`). Only the
steps that log (1, 2 and every 100th) read a tensor back to the host; the
others queue their work and go on. `train` runs with TF32 off for
cuDNN convolutions and matmuls (restored on return): fp32 means fp32 here.

As in the JAX package, `train` cannot take a remote (`http`) store: it
reads the store's metadata first and raises FileNotFoundError (ROADMAP
C20); a remote store feeds a `Loader` through `get_dataset`.
"""
from __future__ import annotations

import collections
import contextlib
import os
import time
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from rave_tpu_torch import config as config_lib
from rave_tpu_torch.config import RaveConfig
from rave_tpu_torch.data.dataset import get_dataset, is_remote, split_dataset
from rave_tpu_torch.data.loader import Loader, NativeLoader
from rave_tpu_torch.data.store import get_training_channels, read_metadata
from rave_tpu_torch.data.transforms import get_derivator_integrator
from rave_tpu_torch.factory import build_audio_distance, resolve_device
from rave_tpu_torch.parallel import mesh
from rave_tpu_torch.train.analysis import pca, receptive_field, valid_crop
from rave_tpu_torch.train.graphs import TrainGraphs
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


def make_run_dir(root: str, name: str, cfg: RaveConfig, write: bool = True) -> Path:
    run_dir = Path(root) / f"{name}_{config_lib.config_hash(cfg)}"
    run_dir.mkdir(parents=True, exist_ok=True)
    if write:  # rank 0 only under data parallelism
        (run_dir / "config.json").write_text(config_lib.snapshot(cfg))
    return run_dir


class NullLogger:
    """The logger of ranks other than 0: writes nothing."""

    def log(self, *a, **k):
        pass

    log_text = log_audio = update_status = close = log


def standard_pipeline(cfg: RaveConfig) -> bool:
    """Crop, mangle and dither only: what the device pipeline can serve."""
    d = cfg.data
    return not (d.augmentations or d.derivative or d.normalize or d.rand_pitch)


def input_pipeline(cfg: RaveConfig, db_path: str, device_data: str, processes: int = 1) -> str:
    """The JAX loop's rule (rave_tpu/train/loop.py:112-150), stated: "device"
    (the device-resident store) for the standard pipeline of a local,
    non-lazy store in a single process, unless `device_data` is off or (on
    'auto') the store is larger than $RAVE_TPU_DEVICE_DATA_MAX_GB; else
    "native" (the C++ sampler) for the standard pipeline of a local,
    non-lazy store; else "threads" (the threaded `Loader`)."""
    remote = is_remote(db_path)
    if not standard_pipeline(cfg) or remote or read_metadata(db_path).get("lazy", False):
        return "threads"
    if device_data != "off" and processes == 1:
        from rave_tpu_torch.data.device_data import db_nbytes

        budget = float(os.environ.get("RAVE_TPU_DEVICE_DATA_MAX_GB",
                                      DEVICE_DATA_BUDGET_GB)) * 1e9
        if device_data == "on" or db_nbytes(db_path) <= budget:
            return "device"
    return "native"


def use_device_data(cfg: RaveConfig, db_path: str, device_data: str) -> bool:
    """Whether a single-process run takes the device pipeline (`input_pipeline`)."""
    return input_pipeline(cfg, db_path, device_data) == "device"


def step_method(device: torch.device) -> Tuple[str, str]:
    """How the loop runs its step programs, and the line that says why:
    "graph" (`TrainGraphs`) on a card in a single process; "eager" under
    data parallelism, whose gloo collectives a CUDA graph cannot hold, and
    on the CPU."""
    if device.type != "cuda":
        return "eager", "the training steps run eagerly (on the CPU)"
    if mesh.world_size() > 1:
        return "eager", ("the training steps run eagerly (data parallel: gloo's collectives "
                         "cannot be captured)")
    return "graph", f"the training steps run as CUDA graphs (one per program and key) on {device}"


def train_steps(cfg: RaveConfig, crop: Tuple[int, int], device: torch.device) -> dict:
    """{'gen': ..., 'dis': ...}: `build_train_steps`'s steps, served by a
    `TrainGraphs` where `step_method` says "graph"."""
    steps = build_train_steps(cfg, crop)
    if step_method(device)[0] == "eager":
        return steps
    graphs = TrainGraphs(steps)
    return {"gen": graphs.gen, "dis": graphs.dis}


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


@contextlib.contextmanager
def eval_mode(model: torch.nn.Module):
    """`model` in eval mode, its mode put back on exit."""
    was = model.training
    model.eval()
    try:
        yield
    finally:
        model.train(was)


def run_validation(cfg: RaveConfig, state: TrainState, loader: Loader, distance, logger,
                   step: int, eval_number: int, max_batches: Optional[int] = None):
    """One pass over the validation split (or its first `max_batches`) with
    the EMA weights when the run keeps them (reference rave/model.py:426-495),
    the model in eval mode (the JAX loop's `train=False` model) and put back
    in its mode after: logs `validation` and 8 clips; returns (mean loss,
    [N, D] latent means). Under data parallelism every rank runs the same
    number of full batches, each a shard of a global batch: the loss is the
    global batch's, the same on every rank, and the latents and clips are
    gathered in rank order."""
    model = state.model
    device = next(model.parameters()).device
    D = cfg.latent_size
    if mesh.world_size() > 1:  # full batches only, in lockstep over the ranks
        n_batches = mesh.all_processes_min(len(loader.indices) // loader.batch, device)
    else:
        n_batches = len(loader)
    if max_batches is not None:
        n_batches = min(n_batches, max_batches)
    losses, latents, clips = [], [], []
    with ema_weights(model, state.ema), eval_mode(model), torch.inference_mode(), \
            mesh.sharded_batch():
        for b, x in enumerate(loader.epoch(0)):
            if b >= n_batches:
                break
            x = torch.from_numpy(x).to(device)
            z = model.encode(x)
            draws = draw_noise(cfg, x, torch.Generator(device=device).manual_seed(VAL_NOISE_SEED))
            zs, _ = model.reparametrize(z, draws)
            y = model.decode(zs, draws.uniform)[..., : x.shape[-1]]
            losses.append(mesh.mean_over_ranks({"loss": sum(distance(x, y).values())})["loss"])
            latents.append(mesh.gather_to_hosts(z[:, :D].transpose(1, 2).reshape(-1, D)))
            if sum(c.shape[0] for c in clips) < 8:
                clips.append(mesh.gather_to_hosts(torch.cat([x, y], dim=-1)))
    if not losses:
        return None, None
    val = float(np.mean(torch.stack(losses).cpu().numpy().astype(np.float64)))
    logger.log(step, {"validation": val})
    wav = np.concatenate(clips)[:8, 0].reshape(-1)
    if cfg.data.derivative:  # derivative-domain audio integrated back (rave/model.py:491-492)
        wav = get_derivator_integrator(cfg.sampling_rate)[1](wav)
    logger.log_audio("audio_val", wav, cfg.sampling_rate, eval_number)
    return val, np.concatenate(latents)


def codebook_health(model: torch.nn.Module) -> Tuple[float, float]:
    """(mean perplexity, mean live-code fraction) over every quantizer's EMA
    `cluster_size` (rave_tpu/train/loop.py:380-398); on the host, at
    validation. A code holding at least half a uniform share of the EMA
    mass counts as live."""
    perps, usages = [], []
    for name, buf in model.named_buffers():
        if not name.endswith("cluster_size"):
            continue
        cs = buf.detach().cpu().numpy().reshape(-1)
        total = float(cs.sum())
        if total <= 0:
            continue
        p = cs / total
        entropy = float(-(p * np.log(np.maximum(p, 1e-12))).sum())
        perps.append(float(np.exp(entropy)))
        usages.append(float((cs > 0.5 * total / cs.size).mean()))
    if not perps:
        return 0.0, 0.0
    return float(np.mean(perps)), float(np.mean(usages))


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
    (resuming from its newest checkpoint when `resume`); returns the run dir.
    Under torchrun, one rank of a data-parallel run (the module docstring)."""
    device = mesh.init_from_env(resolve_device(device))
    rank, world = mesh.rank(), mesh.world_size()
    is_main = rank == 0
    progress = progress and is_main
    channels = get_training_channels(db_path, n_channels)  # C20: raises on a URL, as JAX
    cfg.data.n_channels = channels  # recorded in the config snapshot
    run_dir = make_run_dir(out_path, name, cfg, write=is_main)
    mesh.barrier()

    d = cfg.data
    dataset = get_dataset(db_path, cfg.sampling_rate, d.n_signal, derivative=d.derivative,
                          normalize=d.normalize, rand_pitch=d.rand_pitch,
                          augmentations=d.augmentations)
    train_idx, val_idx = split_dataset(dataset)
    pipeline_kind = input_pipeline(cfg, db_path, device_data, world)
    val_loader = Loader(dataset, val_idx, d.batch, seed=seed, shuffle=False, drop_last=False,
                        host_id=rank, host_count=world)

    # receptive field -> the valid-signal crop of the multiband loss (rank 0's, shared)
    crop, rf = (0, 0), (0, 0)
    if cfg.train.valid_signal_crop:
        t0 = time.time()
        rf = mesh.broadcast_object(
            receptive_field(cfg, n_channels=channels, device=device) if is_main else None)
        crop = valid_crop(cfg, rf, d.n_signal, channels)
        if progress:
            ms = 1000 / cfg.sampling_rate
            print(f"receptive field: {rf[0] * ms:.1f}ms <- x -> {rf[1] * ms:.1f}ms "
                  f"({time.time() - t0:.0f}s)")

    state = create_train_state(cfg, n_channels=channels, seed=seed, device=device)
    if resume and restore_checkpoint(str(run_dir), state) is not None and progress:
        print(f"resumed at step {state.step}")
    mesh.replicate(state.model)
    mesh.replicate(state.discriminator)
    with torch.no_grad():
        state.model.receptive_field.copy_(torch.tensor(rf, dtype=torch.float32))
    steps = train_steps(cfg, crop, device)
    if progress:
        print(step_method(device)[1])
    distance = build_audio_distance(cfg)

    max_steps = max_steps or cfg.train.max_steps
    if smoke_test:
        max_steps = min(max_steps, state.step + 2)
        val_every = 1
    step = state.step
    if pipeline_kind == "device":
        from rave_tpu_torch.data.device_data import DeviceDataPipeline, db_nbytes

        pipeline = DeviceDataPipeline(db_path, train_idx, d.batch, d.n_signal,
                                      cfg.sampling_rate, seed=seed, device=device)
        if progress:
            print(f"using the device-resident dataset ({db_nbytes(db_path) / 1e9:.2f} GB "
                  f"int16 on {device}, batches assembled there)")
        data = device_batches(pipeline, step)
    else:
        if pipeline_kind == "native":
            loader = NativeLoader(db_path, train_idx, d.batch, d.n_signal, cfg.sampling_rate,
                                  seed=seed, host_id=rank, host_count=world)
        else:
            loader = Loader(dataset, train_idx, d.batch, seed=seed, workers=d.workers,
                            host_id=rank, host_count=world)
        if progress:
            print("using the native (C++) input pipeline" if pipeline_kind == "native" else
                  "using the threaded host loader")
        data = host_batches(loader.forever(), device)

    best_val, saved_at, eval_number = float("inf"), -1, 0
    t_last, s_last = time.time(), step
    trace_start = step + 3 if trace_steps and is_main else -1
    profiler = None
    logger = MetricsLogger(str(run_dir)) if is_main else NullLogger()
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
            which, warmed, quantize = pick_phase(cfg, step)
            with mesh.sharded_batch():  # the global batch's draws, this rank's rows
                draws = draw_noise(cfg, x, step_generator(seed + 1, step, device))
            if which == "gen":
                metrics = steps["gen"](state, x, warmed, draws=draws, quantize=quantize)
            else:
                metrics = steps["dis"](state, x, draws=draws, quantize=quantize)
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
                if quantize and cfg.latent.family == "discrete":
                    perplexity, usage = codebook_health(state.model)
                    logger.log(step, {"codebook_perplexity": perplexity,
                                      "codebook_usage": usage})
                if val_loss is not None and val_loss <= best_val:  # the same on every rank
                    best_val = val_loss
                    if is_main:
                        save_checkpoint(str(run_dir), state)
                    saved_at = step
            if save_every and step % save_every == 0 and saved_at != step:
                if is_main:
                    save_checkpoint(str(run_dir), state)
                saved_at = step
    finally:
        if profiler is not None:  # the window outlived the run: still write the trace
            stop_trace(profiler, run_dir, progress)
        logger.close()
    if saved_at != step and is_main:
        save_checkpoint(str(run_dir), state)
    mesh.barrier()  # every rank returns once the run's last checkpoint is written
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
