"""Datasets over the ARS store + the transform pipeline.

The port's counterpart of rave_tpu/data/dataset.py (numpy and scipy, the
same code): AudioDataset (preprocessed chunks), LazyAudioDataset
(path+length index, seek decode), the transform composition of
`get_dataset` (rave/dataset.py:206-261) and the seeded 98/2 split
(rave/dataset.py:264-278), and HTTPAudioDataset, the client of the REST
server of data/server.py (`cli remote_dataset`), over stdlib `urllib`.

As in the JAX package, an `http` store has no metadata to read: its
pipeline takes the caller's rate and is not lazy (rave_tpu/data/dataset.py:
123-124), and `store.get_training_channels` raises FileNotFoundError on
it, so `train` cannot take one (ROADMAP C20): a remote store reaches a
`Loader` through `get_dataset`.
"""
from __future__ import annotations

import base64
import json
from pathlib import Path
from urllib.request import urlopen
from typing import List, Optional, Sequence

import numpy as np

from rave_tpu_torch.data import transforms as T
from rave_tpu_torch.data.audio_io import decode_slice_ffmpeg
from rave_tpu_torch.data.store import ArsReader, read_metadata


class AudioDataset:
    """Preprocessed fixed-size chunks -> float32 [T, C]
    (reference rave/dataset.py:32-83)."""

    def __init__(self, db_path: str, transform: Optional[T.Transform] = None):
        self.reader = ArsReader(db_path)
        self.transform = transform

    def __len__(self):
        return len(self.reader)

    def get(self, i: int, rng: np.random.Generator) -> np.ndarray:
        x = self.reader[i].astype(np.float32) / 32767.0
        if self.transform is not None:
            x = self.transform(rng, x)
        return x


class LazyAudioDataset:
    """Path-indexed dataset decoding slices on demand
    (reference rave/dataset.py:87-160)."""

    def __init__(
        self, db_path: str, n_signal: int, transform: Optional[T.Transform] = None
    ):
        self.db = Path(db_path)
        self.meta = read_metadata(db_path)
        with open(self.db / "entries.json") as f:
            self.entries = json.load(f)
        self.sr = self.meta["sr"]
        self.channels = self.meta["channels"]
        self.n_signal = n_signal
        counts = [max(e["length"] // n_signal, 0) for e in self.entries]
        self.index = np.cumsum([0] + counts)
        self.transform = transform

    def __len__(self):
        return int(self.index[-1])

    def get(self, i: int, rng: np.random.Generator) -> np.ndarray:
        f = int(np.searchsorted(self.index, i, side="right") - 1)
        chunk = i - self.index[f]
        start_sec = chunk * self.n_signal / self.sr
        x = decode_slice_ffmpeg(
            self.entries[f]["path"], start_sec, self.n_signal, self.sr, self.channels
        ).astype(np.float32) / 32767.0
        if self.transform is not None:
            x = self.transform(rng, x)
        return x


class HTTPAudioDataset:
    """A store served over HTTP (routes /len and /get/<i>, data/server.py):
    float32 [T, C] records (reference rave/dataset.py:174-193)."""

    def __init__(self, host: str, transform: Optional[T.Transform] = None):
        self.host = host.rstrip("/")
        self.length = int(json.loads(self._get("/len"))["length"])
        self.transform = transform

    def _get(self, route: str) -> bytes:
        with urlopen(self.host + route) as r:
            return r.read()

    def __len__(self):
        return self.length

    def get(self, i: int, rng: np.random.Generator) -> np.ndarray:
        payload = json.loads(self._get(f"/get/{i}"))
        raw = base64.b64decode(payload["data"])
        x = (np.frombuffer(raw, dtype="<i2").reshape(-1, payload["channels"])
             .astype(np.float32) / 32767.0)
        if self.transform is not None:
            x = self.transform(rng, x)
        return x


def is_remote(db_path) -> bool:
    return str(db_path).startswith("http")


def get_dataset(
    db_path: str,
    sr: int,
    n_signal: int,
    derivative: bool = False,
    normalize: bool = False,
    rand_pitch=None,
    augmentations: Sequence[str] = (),
):
    """Build the transform pipeline + dataset (reference rave/dataset.py:206-261):
    RandomCrop -> RandomApply(phase mangle, .8) -> Dequantize(16)
    [-> RandomPitch] [-> Resample] [-> Normalize] [-> Derivator] [-> augs].
    """
    meta = {"sr": sr, "lazy": False} if is_remote(db_path) else read_metadata(db_path)
    pipeline: List[T.Transform] = [T.RandomCrop(n_signal)]
    if rand_pitch:
        max_factor = max(rand_pitch) if isinstance(rand_pitch, (list, tuple)) else rand_pitch
        pipeline.append(T.RandomPitch(n_signal, max_factor=max_factor))
    pipeline += [
        T.RandomApply(T.PhaseMangle(min_f=20, max_f=2000, amplitude=0.99, sr=sr), p=0.8),
        T.Dequantize(16),
    ]
    if meta.get("sr", sr) != sr:
        pipeline.append(T.Resample(meta["sr"], sr))
    if normalize:
        pipeline.append(T.Normalize())
    if derivative:
        pipeline.append(T.Derivator())
    pipeline += T.get_augmentations(augmentations, sr)
    transform = T.Compose(*pipeline)
    if is_remote(db_path):
        return HTTPAudioDataset(db_path, transform)
    if meta.get("lazy", False):
        return LazyAudioDataset(db_path, n_signal, transform)
    return AudioDataset(db_path, transform)


SPLIT_PERCENT, SPLIT_MAX_VAL, SPLIT_SEED = 98, 1000, 42


def split_dataset(dataset):
    """Seeded 98/2 index split with a cap on the validation size
    (reference rave/dataset.py:264-278)."""
    n = len(dataset)
    rng = np.random.default_rng(SPLIT_SEED)
    perm = rng.permutation(n)
    split2 = min(n * (100 - SPLIT_PERCENT) // 100, SPLIT_MAX_VAL)
    split1 = n - split2
    return perm[:split1], perm[split1:]
