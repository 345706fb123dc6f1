"""Audio decode helpers with backend fallback.

The port's copy of rave_tpu/data/audio_io.py (numpy, scipy and the ffmpeg
command; nothing of it changes). The reference shells out to ffmpeg for all
decoding (scripts/preprocess.py:58-84, rave/dataset.py:301-336). ffmpeg
remains the preferred backend when present (it is an OS tool); otherwise
scipy's wav reader covers .wav, which is the path a machine without ffmpeg
runs.
"""
from __future__ import annotations

import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

AUDIO_EXTENSIONS = (".wav", ".flac", ".ogg", ".mp3", ".aif", ".aiff", ".opus", ".m4a")


def have_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


def load_audio_chunk_ffmpeg(
    path: str, n_signal: int, sr: int, channels: int = 1
):
    """Yield successive int16 chunks of n_signal*channels samples
    (reference scripts/preprocess.py:58-84)."""
    proc = subprocess.Popen(
        [
            "ffmpeg", "-hide_banner", "-loglevel", "panic", "-i", path,
            "-ac", str(channels), "-ar", str(sr), "-f", "s16le", "-",
        ],
        stdout=subprocess.PIPE,
    )
    chunk_bytes = 2 * n_signal * channels
    buf = proc.stdout.read(chunk_bytes)
    while len(buf) == chunk_bytes:
        yield np.frombuffer(buf, dtype=np.int16).reshape(-1, channels)
        buf = proc.stdout.read(chunk_bytes)
    proc.stdout.close()
    proc.wait()


def decode_file(
    path: str, sr: int, channels: int = 1
) -> Optional[np.ndarray]:
    """Whole-file decode -> int16 [T, channels], resampled to sr."""
    p = str(path)
    if have_ffmpeg():
        out = subprocess.run(
            [
                "ffmpeg", "-hide_banner", "-loglevel", "panic", "-i", p,
                "-ac", str(channels), "-ar", str(sr), "-f", "s16le", "-",
            ],
            capture_output=True,
        ).stdout
        if out:
            return np.frombuffer(out, dtype=np.int16).reshape(-1, channels)
    if p.lower().endswith(".wav"):
        from scipy.io import wavfile
        from scipy.signal import resample_poly

        file_sr, data = wavfile.read(p)
        if data.ndim == 1:
            data = data[:, None]
        if data.dtype == np.int16:
            x = data.astype(np.float32) / 32768
        elif data.dtype == np.int32:
            x = data.astype(np.float32) / 2147483648
        elif data.dtype == np.uint8:
            x = (data.astype(np.float32) - 128) / 128
        else:
            x = data.astype(np.float32)
        # channel adaptation
        if x.shape[1] < channels:
            x = np.tile(x, (1, channels))[:, :channels]
        elif x.shape[1] > channels:
            x = x[:, :channels]
        if file_sr != sr:
            from math import gcd

            g = gcd(int(file_sr), int(sr))
            x = resample_poly(x, sr // g, file_sr // g, axis=0)
        return np.clip(x * 32768, -32768, 32767).astype(np.int16)
    return None


def _to_int16(data: np.ndarray) -> np.ndarray:
    if data.dtype == np.int16:
        return data
    if data.dtype == np.int32:
        return (data >> 16).astype(np.int16)
    if data.dtype == np.uint8:
        return ((data.astype(np.int16) - 128) << 8).astype(np.int16)
    return np.clip(data * 32768, -32768, 32767).astype(np.int16)


def _decode_slice_wav(
    path: str, start_sec: float, n_signal: int, sr: int, channels: int = 1
) -> np.ndarray:
    """ffmpeg-less seek-decode for .wav: scipy mmap's uncompressed PCM, so a
    slice read touches only the requested frames (no whole-file decode)."""
    from scipy.io import wavfile

    file_sr, data = wavfile.read(str(path), mmap=True)
    start = int(round(start_sec * file_sr))
    need = (
        n_signal
        if file_sr == sr
        else int(np.ceil(n_signal * file_sr / sr)) + 8
    )
    seg = np.asarray(data[start : start + need])
    if seg.ndim == 1:
        seg = seg[:, None]
    if seg.shape[1] < channels:
        seg = np.tile(seg, (1, channels))[:, :channels]
    elif seg.shape[1] > channels:
        seg = seg[:, :channels]
    # normalize dtype BEFORE resampling: the /32768 scaling below is only
    # valid for int16 (float32/int32/uint8 WAVs would be silently
    # corrupted otherwise — ADVICE r4)
    seg = _to_int16(seg)
    if file_sr != sr:
        from math import gcd

        from scipy.signal import resample_poly

        g = gcd(int(file_sr), int(sr))
        x = resample_poly(
            seg.astype(np.float32) / 32768.0, sr // g, file_sr // g, axis=0
        )
        seg = np.clip(x * 32768, -32768, 32767).astype(np.int16)
    if seg.shape[0] < n_signal:
        seg = np.pad(seg, ((0, n_signal - seg.shape[0]), (0, 0)))
    return seg[:n_signal]


def decode_slice_ffmpeg(
    path: str, start_sec: float, n_signal: int, sr: int, channels: int = 1
) -> np.ndarray:
    """Seek-decode a slice (reference rave/dataset.py:301-336); falls back
    to the mmap .wav reader when ffmpeg is absent."""
    if not have_ffmpeg() and str(path).lower().endswith(".wav"):
        return _decode_slice_wav(path, start_sec, n_signal, sr, channels)
    out = subprocess.run(
        [
            "ffmpeg", "-hide_banner", "-loglevel", "panic",
            "-ss", str(start_sec), "-i", str(path),
            "-ac", str(channels), "-ar", str(sr),
            "-t", str(n_signal / sr + 0.1), "-f", "s16le", "-",
        ],
        capture_output=True,
    ).stdout
    x = np.frombuffer(out, dtype=np.int16).reshape(-1, channels)
    if x.shape[0] < n_signal:
        x = np.pad(x, ((0, n_signal - x.shape[0]), (0, 0)))
    return x[:n_signal]


def probe_length(path: str) -> Tuple[float, int]:
    """(duration_seconds, channels) via ffprobe, or the .wav header when
    ffprobe is absent (scipy mmap — no sample data is read).

    The scipy probe accepts exactly the formats the training-time mmap
    slice reader (`_decode_slice_wav`) can serve — IEEE-float WAVs pass,
    24-bit PCM is rejected here rather than failing later mid-training
    (ADVICE r4)."""
    if shutil.which("ffprobe") is None and str(path).lower().endswith(".wav"):
        try:
            from scipy.io import wavfile

            file_sr, data = wavfile.read(str(path), mmap=True)
            ch = 1 if data.ndim == 1 else int(data.shape[1])
            return data.shape[0] / file_sr, ch
        except Exception:
            return 0.0, 0
    try:
        out = subprocess.run(
            [
                "ffprobe", "-v", "error", "-show_entries",
                "stream=duration,channels", "-of", "csv=p=0", str(path),
            ],
            capture_output=True,
            text=True,
        ).stdout.strip().split("\n")[0]
        parts = out.split(",")
        return float(parts[1]), int(parts[0])
    except Exception:
        return 0.0, 0


def search_for_audios(root: str):
    files = []
    for p in sorted(Path(root).rglob("*")):
        if p.suffix.lower() in AUDIO_EXTENSIONS and p.is_file():
            files.append(str(p))
    return files
