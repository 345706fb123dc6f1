"""Batch file transformation through an exported artifact (or a run).

PyTorch port of rave_tpu/export/generate.py (the reference's `rave
generate`, scripts/generate.py:33-123): decode each input file, pad it to
whole blocks, run the artifact's forward offline or in `chunk_size`
streaming blocks, trim, integrate the output of a derivative-trained model,
clip, and write an int16 wav. A run directory is exported on the fly.

A stereo artifact (`stream_batch` 2) takes a file's two channels as its two
batch rows, offline and streaming; the JAX package feeds it one row.

With `prior_seconds`, no input is read: each of `prior_samples` latent
sequences of `round(seconds * sr / decimation)` frames is sampled from the
artifact's bundled prior (seed `seed + i`), decoded offline and written as
`prior_sample_<i>.wav` (rave_tpu/export/generate.py:96-120).
"""
from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch
from scipy.io import wavfile

from rave_tpu_torch.data.audio_io import decode_file
from rave_tpu_torch.export.artifact import ExportedRAVE
from rave_tpu_torch.export.export import export_model


def generate(
    model: str,
    inputs: Sequence[str],
    out_path: str = "generated",
    streaming: bool = False,
    chunk_size: Optional[int] = None,
    prior_seconds: float = 0.0,
    prior_samples: int = 1,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> List[Path]:
    """Reconstruct each of `inputs` into `<out_path>/<stem>_reconstructed.wav`
    on `device` (or, with `prior_seconds`, sample the artifact's prior); the
    noise comes from the seed chain of `seed`. Returns the files written."""
    p = Path(model)
    if not (p / "manifest.json").exists():
        p = Path(export_model(run=model, streaming=streaming, device=device))
    art = ExportedRAVE(str(p), device=device, seed=seed)
    if prior_seconds:
        return generate_prior(art, out_path, prior_seconds, prior_samples, seed)
    sr = art.manifest.get("target_sampling_rate", art.manifest["sampling_rate"])
    block = chunk_size or art.block_size
    if streaming and block % art.block_size:
        raise ValueError(f"--chunk_size must be a multiple of the artifact's block size "
                         f"{art.block_size} (got {block})")
    out_dir = Path(out_path)
    out_dir.mkdir(parents=True, exist_ok=True)
    integrator = None
    if art.manifest.get("derivative"):
        from rave_tpu_torch.data.transforms import get_derivator_integrator

        integrator = get_derivator_integrator(sr)[1]

    rows, channels = art.stream_batch, art.n_channels
    written = []
    for f in inputs:
        x = decode_file(f, sr, rows * channels)
        if x is None:
            print(f"skipping {f} (cannot decode)")
            continue
        n_in = x.shape[0]
        x = load_signal(x, rows, channels, block)
        if streaming:
            art.reset_stream()
            y = torch.cat([art.forward(x[..., i:i + block], streaming=True)
                           for i in range(0, x.shape[-1], block)], dim=-1)
        else:
            y = art.forward(x)
        y = y[..., :n_in].reshape(rows * channels, n_in).T.cpu().numpy()  # [T, channels]
        if integrator is not None:
            y = integrator(y)
        y = np.clip(y, -1, 1)
        out_file = out_dir / (Path(f).stem + "_reconstructed.wav")
        wavfile.write(out_file, sr, (y * 32767).astype(np.int16))
        print(f"wrote {out_file}")
        written.append(out_file)
    return written


def generate_prior(art: ExportedRAVE, out_path: str, seconds: float, n: int,
                   seed: int) -> List[Path]:
    """Unconditional generation: `n` latent sequences sampled from the
    artifact's prior, decoded, as `<out_path>/prior_sample_<i>.wav`."""
    if not art.has_prior:
        raise RuntimeError(f"{art.path} was exported without a prior: export it again with "
                           "`export --prior <prior run dir>`")
    sr = art.manifest.get("target_sampling_rate", art.manifest["sampling_rate"])
    decim = art.manifest["methods"]["decode"]["in_ratio"]
    n_frames = max(int(round(seconds * art.manifest["sampling_rate"] / decim)), 1)
    out_dir = Path(out_path)
    out_dir.mkdir(parents=True, exist_ok=True)
    written = []
    for i in range(n):
        y = art.decode(art.sample_prior(n_frames, seed=seed + i))[0].T.cpu().numpy()
        y = np.clip(y, -1, 1)
        out_file = out_dir / f"prior_sample_{i}.wav"
        wavfile.write(out_file, sr, (y * 32767).astype(np.int16))
        print(f"wrote {out_file} ({y.shape[0] / sr:.2f}s)")
        written.append(out_file)
    return written


def load_signal(x: np.ndarray, rows: int, channels: int, block: int) -> torch.Tensor:
    """int16 [T, rows * channels] from `decode_file` -> float32 [rows,
    channels, T'] in [-1, 1), zero-padded to a whole number of blocks."""
    if x.dtype != np.int16:
        raise TypeError(f"decode_file returned {x.dtype}, not int16")
    x = x.astype(np.float32) / 32768.0
    x = np.pad(x, ((0, (-x.shape[0]) % block), (0, 0)))
    return torch.from_numpy(np.ascontiguousarray(x.T)).reshape(rows, channels, -1)
