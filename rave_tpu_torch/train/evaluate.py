"""Offline model evaluation: reconstruction metrics over a dataset split.

PyTorch port of rave_tpu/train/evaluate.py: for a port run dir (its newest
checkpoint, the one at `step`, or its EMA shadow), the spectral distance
the trainer logs as `validation`, a waveform L1 and the Fréchet mel
distance (FMD) between the Gaussian fits of real and reconstructed log-mel
frames, over the chosen split ('val' = the training 98/2 holdout, 'train'
or 'all'). The noise of every batch comes from seed 1234, as the JAX
package's `key(1234)`, so two calls give the same numbers. Runs with TF32
off, as `train` does.

Usage (CLI): python -m rave_tpu_torch.cli eval --run runs/myrun_* --db_path ./db
Prints one JSON line: {"spectral_distance": ..., "waveform_l1": ...,
"frechet_mel_distance": ..., "n_clips": ..., "split": ..., "step": ...}.
"""
from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch

from rave_tpu_torch.data.dataset import get_dataset, split_dataset
from rave_tpu_torch.data.loader import Loader
from rave_tpu_torch.factory import build_audio_distance, resolve_device
from rave_tpu_torch.ops.stft import mel_filterbank, spectrogram
from rave_tpu_torch.train.loop import VAL_NOISE_SEED, fp32_exact
from rave_tpu_torch.train.steps import draw_noise
from rave_tpu_torch.utils.checkpoint import checkpoint_step, latest_checkpoint, load_run

N_MELS, N_FFT, HOP = 64, 1024, 256


@fp32_exact()
@torch.inference_mode()
def evaluate(
    run: str,
    db_path: str,
    split: str = "val",
    batch: Optional[int] = None,
    n_signal: Optional[int] = None,
    max_batches: Optional[int] = None,
    use_ema: bool = False,
    step: Optional[int] = None,
    device: str | torch.device = "cuda",
) -> dict:
    """Mean reconstruction metrics of a run's newest checkpoint (or the one
    at exactly `step`) over `split`, weighted by batch size."""
    cfg, model, _, run_dir = load_run(run, use_ema, step, resolve_device(device))
    if batch:
        cfg.data.batch = batch
    if n_signal:
        cfg.data.n_signal = n_signal
    dataset = get_dataset(db_path, cfg.sampling_rate, cfg.data.n_signal,
                          derivative=cfg.data.derivative, normalize=cfg.data.normalize)
    train_idx, val_idx = split_dataset(dataset)
    indices = {"val": val_idx, "train": train_idx,
               "all": list(train_idx) + list(val_idx)}[split]
    if not len(indices):
        raise ValueError(f"split '{split}' of {db_path} is empty")
    loader = Loader(dataset, indices, min(cfg.data.batch, len(indices)), shuffle=False,
                    drop_last=False)
    distance = build_audio_distance(cfg)
    device = next(model.parameters()).device
    mel_fb = torch.from_numpy(mel_filterbank(cfg.sampling_rate, N_FFT, N_MELS)).to(device)

    spectral, wave, n_clips, n_batches = [], [], 0, 0
    stats = {key: [0, np.zeros(N_MELS), np.zeros((N_MELS, N_MELS))] for key in ("real", "fake")}
    for b, x in enumerate(loader.epoch(0)):
        if max_batches is not None and b >= max_batches:
            break
        x = torch.from_numpy(x).to(device)
        eps = draw_noise(cfg, x, torch.Generator(device=device).manual_seed(VAL_NOISE_SEED))
        zs, _ = model.reparametrize(model.encode(x), eps=eps)
        y = model.decode(zs)[..., : x.shape[-1]]
        spectral.append((float(sum(distance(x, y).values())), x.shape[0]))
        wave.append((float((y - x).abs().mean()), x.shape[0]))
        for key, sig in (("real", x), ("fake", y)):
            count, total, outer = _mel_stats(sig, mel_fb)
            stats[key][0] += count
            stats[key][1] += total
            stats[key][2] += outer
        n_clips += x.shape[0]
        n_batches += 1

    ckpt = latest_checkpoint(str(run_dir), step)
    wmean = lambda acc: sum(v * n for v, n in acc) / max(n_clips, 1)  # noqa: E731
    return {
        "spectral_distance": round(wmean(spectral), 6),
        "waveform_l1": round(wmean(wave), 6),
        "frechet_mel_distance": round(frechet(stats["real"], stats["fake"]), 6),
        "n_clips": n_clips,
        "n_batches": n_batches,
        "split": split,
        "step": checkpoint_step(ckpt) if ckpt is not None else -1,
        "ema": bool(use_ema),
        "run": str(run_dir),
    }


def _mel_stats(sig: torch.Tensor, mel_fb: torch.Tensor):
    """Log-mel frames of channel 0 -> (count, sum [n_mels], outer sum
    [n_mels, n_mels]), the sums float64 on the host."""
    m = torch.log(torch.einsum("bfk,mk->bfm", spectrogram(sig[:, 0], N_FFT, HOP), mel_fb) + 1e-5)
    flat = m.reshape(-1, N_MELS)
    host = lambda t: t.double().cpu().numpy()  # noqa: E731
    return flat.shape[0], host(flat.sum(0)), host(flat.T @ flat)


def frechet(real, fake) -> float:
    """Fréchet distance between two Gaussians given (count, sum, outer-sum)
    sufficient statistics: |mu1-mu2|^2 + tr(S1 + S2 - 2 (S1 S2)^(1/2))."""
    import scipy.linalg

    out = []
    for n, s, o in (real, fake):
        n = max(n, 2)
        mu = s / n
        out.append((mu, o / n - np.outer(mu, mu)))
    (mu1, c1), (mu2, c2) = out
    covmean = scipy.linalg.sqrtm(c1 @ c2)
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(np.sum((mu1 - mu2) ** 2)) + float(
        np.trace(c1) + np.trace(c2) - 2.0 * np.trace(covmean))


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser("rave_tpu_torch eval")
    p.add_argument("--run", required=True, help="run directory")
    p.add_argument("--db_path", required=True)
    p.add_argument("--split", choices=("val", "train", "all"), default="val")
    p.add_argument("--batch", type=int, default=0)
    p.add_argument("--n_signal", type=int, default=0)
    p.add_argument("--max_batches", type=int, default=0)
    p.add_argument("--ema_weights", action="store_true")
    p.add_argument("--step", type=int, default=None,
                   help="evaluate the checkpoint at exactly this step (default: newest)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = p.parse_args(argv)
    out = evaluate(a.run, a.db_path, split=a.split, batch=a.batch or None,
                   n_signal=a.n_signal or None, max_batches=a.max_batches or None,
                   use_ema=a.ema_weights, step=a.step, device=a.device)
    print(json.dumps(out))
