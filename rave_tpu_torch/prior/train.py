"""The prior's training loop (`python -m rave_tpu_torch.cli train_prior`).

PyTorch port of rave_tpu/prior/train.py (reference scripts/train_prior.py:
65-205): loads a finished variational RAVE run of the port, projects its
latents (reparametrize -> mean-centre -> PCA -> truncation to a power of
two of dimensions, reference VariationalPrior, rave/prior/model.py:209-227),
then teacher-forces the autoregressive prior with cross-entropy under Adam.
At every `val_every` steps it generates a short latent sequence, decodes it
to audio for the logs, and saves the prior's and Adam's state.

The frozen RAVE runs in eval mode without a graph, so its fused units
launch their kernel directly on the card. The JAX `train_prior` pads a batch
under 8 rows with zero rows and averages the loss over the real ones, to
work round an XLA:TPU compiler abort on small-batch backprop convolutions;
that gives the loss and gradients of the unpadded batch
(tests/test_prior.py::test_prior_loss_pad_rows_equivalent), so the port
trains on the batch as it is.

Randomness: each step's reparametrization noise comes from a generator
seeded by `fold_in(seed + 1, step)` (utils/rng.py), the validation
sample's from `fold_in(seed, step)`, so the run depends on (seed, step)
alone.
"""
from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Optional

import torch

from rave_tpu_torch.data.dataset import get_dataset, split_dataset
from rave_tpu_torch.data.loader import Loader
from rave_tpu_torch.data.store import get_training_channels
from rave_tpu_torch.export.artifact import post_process_latent, pre_process_latent
from rave_tpu_torch.export.export import truncated_latent_size
from rave_tpu_torch.factory import resolve_device
from rave_tpu_torch.prior.core import DiagonalShift, QuantizedNormal
from rave_tpu_torch.prior.model import build_prior, generate, prior_loss
from rave_tpu_torch.train.loop import fp32_exact
from rave_tpu_torch.utils.checkpoint import load_run, save_prior_checkpoint
from rave_tpu_torch.utils.logging import MetricsLogger
from rave_tpu_torch.utils.rng import step_generator


@torch.no_grad()
def encode_latents(cfg, vae, x: torch.Tensor, latent_size: int,
                   generator: Optional[torch.Generator] = None,
                   eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Waveform [B, C, T] -> the prior's latents [B, latent_size, T_lat]: the
    encoder, then mean + (softplus(scale) + 1e-4) * eps, minus `latent_mean`,
    rotated by `latent_pca` and truncated (rave_tpu/prior/train.py:104-118);
    `eps` [B, cfg.latent_size, T_lat] defaults to normals from `generator`."""
    z = vae.encode(x)
    if eps is None:
        eps = torch.randn((z.shape[0], z.shape[1] // 2, z.shape[2]), generator=generator,
                          device=z.device, dtype=z.dtype)
    return post_process_latent(cfg, vae, latent_size, z, eps=eps)


@torch.no_grad()
def decode_latents(cfg, vae, z: torch.Tensor,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The prior's latents [B, D, T_lat] -> waveform [B, C, T_lat * decimation]:
    padded with normal noise to `cfg.latent_size`, rotated back, un-centred
    and decoded (rave_tpu/prior/train.py:120-130), the noise synth's
    uniforms (if any) from `generator`."""
    B, D, T = z.shape
    noise = torch.randn((B, cfg.latent_size - D, T), generator=generator, device=z.device)
    zf = pre_process_latent(cfg, vae, cfg.latent_size, z, noise=noise)
    shape = cfg.noise_shape(vae.n_channels, B, T)
    uniform = None if shape is None else torch.rand(shape, generator=generator,
                                                    device=z.device)
    return vae.decode(zf, uniform)


@fp32_exact()
def train_prior(
    run: str,
    db_path: str,
    name: str,
    out_path: str = "runs",
    batch: int = 8,
    n_signal: int = 131072,
    max_steps: int = 1_000_000,
    val_every: int = 10000,
    fidelity: float = 0.95,
    resolution: int = 32,
    res_size: int = 512,
    skp_size: int = 256,
    kernel_size: int = 3,
    cycle_size: int = 4,
    n_layers: int = 10,
    lr: float = 1e-4,
    smoke_test: bool = False,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> str:
    """Train a prior on the latents of the RAVE run `run` over the store
    `db_path`, on `device`; returns the prior run's directory
    `<out_path>/<name>_prior`."""
    device = resolve_device(device)
    cfg, vae, n_channels, vae_run = load_run(run, device=device)
    if cfg.latent.family != "variational":
        raise ValueError(f"the latent prior requires a variational RAVE; {vae_run} is "
                         f"{cfg.latent.family}")
    channels = get_training_channels(db_path, None)
    if channels != n_channels:
        raise ValueError(f"{db_path} holds {channels} channels, the run {n_channels}")
    latent_size = truncated_latent_size(vae.fidelity.cpu().numpy(), fidelity, cfg.latent_size)
    prior = build_prior(latent_size, resolution, res_size, skp_size, kernel_size, cycle_size,
                        n_layers, seed=seed, device=device)
    qn, shift = QuantizedNormal(resolution), DiagonalShift()

    ratio = cfg.decimation()
    n_signal = max(n_signal, 2 ** math.ceil(math.log2(prior.receptive_field * ratio)))
    if n_signal // ratio - latent_size + 1 < 2:  # the shifted sequence must hold a target
        raise ValueError(
            f"n_signal {n_signal} gives {n_signal // ratio} latent frames; the diagonal shift of "
            f"{latent_size} dimensions leaves {n_signal // ratio - latent_size + 1}, and the "
            f"loss needs 2: raise --n_signal to at least {(latent_size + 1) * ratio} (or lower "
            f"--fidelity)")

    run_dir = Path(out_path) / f"{name}_prior"
    run_dir.mkdir(parents=True, exist_ok=True)
    (run_dir / "prior_config.json").write_text(json.dumps(dict(
        vae_run=str(vae_run), latent_size=latent_size, resolution=resolution,
        res_size=res_size, skp_size=skp_size, kernel_size=kernel_size,
        cycle_size=cycle_size, n_layers=n_layers, fidelity=fidelity), indent=2))
    logger = MetricsLogger(str(run_dir))

    dataset = get_dataset(db_path, cfg.sampling_rate, n_signal)
    train_idx, _ = split_dataset(dataset)
    loader = Loader(dataset, train_idx, batch, seed=seed)
    opt = torch.optim.Adam(prior.parameters(), lr=lr)

    if smoke_test:
        max_steps, val_every = 2, 1

    step, saved_step = 0, None
    batches = loader.forever()
    try:
        for x in batches:
            if step >= max_steps:
                break
            x = torch.from_numpy(x).to(device)
            z = encode_latents(cfg, vae, x, latent_size, step_generator(seed + 1, step, device))
            x_oh = qn.encode(shift(z))
            opt.zero_grad(set_to_none=True)
            loss = prior_loss(prior, x_oh, latent_size)
            loss.backward()
            opt.step()
            step += 1
            if step % 100 == 0 or step <= 2:
                logger.log(step, {"latent_prediction": loss.item()})
                print(f"prior step {step} ce={loss.item():.4f}", flush=True)
            if step % val_every == 0 or step == max_steps:
                audio = validation_sample(cfg, vae, prior, qn, shift,
                                          min(128, n_signal // ratio),
                                          step_generator(seed, step, device))
                logger.log_audio("generation", audio[0, 0].cpu().numpy(), cfg.sampling_rate,
                                 step)
                save_prior_checkpoint(str(run_dir), step, prior, opt)
                saved_step = step
    finally:
        batches.close()
        logger.close()
    if saved_step != step:
        save_prior_checkpoint(str(run_dir), step, prior, opt)
    return str(run_dir)


@torch.no_grad()
def validation_sample(cfg, vae, prior, qn: QuantizedNormal, shift: DiagonalShift,
                      n_frames: int, generator: torch.Generator) -> torch.Tensor:
    """A sample of the prior decoded to audio [1, C, T]: a random first
    frame, `n_frames` generated, the shift undone (rave_tpu/prior/train.py:
    165-174)."""
    D, device = prior.latent_size, next(prior.parameters()).device
    x0 = qn.encode(torch.randn((1, D, 1), generator=generator, device=device))
    ys = generate(prior, x0, n_frames, generator=generator)
    dither = torch.rand((1, D, n_frames), generator=generator, device=device)
    z = shift.inverse(qn.decode(ys, dither))
    return decode_latents(cfg, vae, z, generator)
