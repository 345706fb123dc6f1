"""Corpus -> ARS store preprocessing (the `rave preprocess` equivalent).

The port's counterpart of rave_tpu/data/preprocess.py, which it matches
byte for byte: the same decode, the same record order, the same
metadata.yaml (written without yaml, see data/store.py). Reference:
scripts/preprocess.py — ffmpeg decode into fixed num_signal chunks via a
worker pool, int16 records keyed sequentially; lazy mode stores only
paths + probed lengths.
"""
from __future__ import annotations

import json
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from rave_tpu_torch.data.audio_io import (
    decode_file,
    have_ffmpeg,
    load_audio_chunk_ffmpeg,
    probe_length,
    search_for_audios,
)
from rave_tpu_torch.data.store import ArsWriter, read_metadata, write_metadata


def _preprocess_lazy(audios, out: Path, num_signal, sampling_rate, channels, workers) -> dict:
    if not have_ffmpeg() and not all(a.lower().endswith(".wav") for a in audios):
        raise RuntimeError(
            "lazy preprocessing requires ffmpeg/ffprobe for non-.wav "
            "inputs (.wav works ffmpeg-less via the mmap reader)"
        )
    entries, dropped = [], []
    with ThreadPoolExecutor(max_workers=workers) as pool:
        for path, (dur, _) in zip(audios, pool.map(probe_length, audios)):
            if dur > 0:
                entries.append({"path": str(path), "length": int(dur * sampling_rate)})
            else:
                dropped.append(str(path))
    if dropped:
        # a file the probe rejects (24-bit PCM without ffmpeg, say) would
        # otherwise fail or vanish at training time
        msg = (
            f"lazy preprocess: {len(dropped)}/{len(audios)} files cannot "
            "be probed/mmap'd and were skipped:\n  "
            + "\n  ".join(dropped[:20])
            + ("\n  ..." if len(dropped) > 20 else "")
        )
        if not entries:
            raise RuntimeError(msg)
        print(f"WARNING: {msg}")
    with open(out / "entries.json", "w") as f:
        json.dump(entries, f, indent=1)
    meta = {
        "lazy": True,
        "channels": channels,
        "n_seconds": sum(e["length"] for e in entries) / sampling_rate,
        "sr": sampling_rate,
        "num_signal": num_signal,
        "n_examples": sum(e["length"] // num_signal for e in entries),
    }
    write_metadata(out, meta)
    return meta


def preprocess(
    input_path: str,
    output_path: str,
    num_signal: int = 131072,
    sampling_rate: int = 44100,
    channels: int = 1,
    lazy: bool = False,
    workers: int = 8,
) -> dict:
    audios = search_for_audios(input_path)
    if not audios:
        raise FileNotFoundError(f"no audio files under {input_path}")
    out = Path(output_path)
    out.mkdir(parents=True, exist_ok=True)
    if lazy:
        return _preprocess_lazy(audios, out, num_signal, sampling_rate, channels, workers)

    writer = ArsWriter(str(out), num_signal, channels, sampling_rate)

    def decode(path):
        if have_ffmpeg():
            return list(load_audio_chunk_ffmpeg(path, num_signal, sampling_rate, channels))
        x = decode_file(path, sampling_rate, channels)
        if x is None:
            return []
        return [x[i * num_signal : (i + 1) * num_signal] for i in range(x.shape[0] // num_signal)]

    with ThreadPoolExecutor(max_workers=workers) as pool:
        for chunks in pool.map(decode, audios):
            for c in chunks:
                writer.append(c)
    writer.close()
    return read_metadata(out)
