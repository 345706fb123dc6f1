"""ARS — a flat mmap'd audio record store (the lmdb+protobuf equivalent).

The port's counterpart of rave_tpu/data/store.py, with the same files, so
that either package reads a store the other wrote:

    <db>/metadata.yaml   {channels, lazy, n_examples, n_seconds, num_signal, sr}
    <db>/data.ars        raw little-endian int16, record i at
                         i * num_signal * channels * 2

Lazy mode writes entries.json ([{path, length}]) instead of data.ars.
The port carries no yaml package: `write_metadata` writes the flat
`key: value` file that `yaml.safe_dump` writes for these keys (sorted keys,
`true`/`false`, PyYAML's float spelling) and `read_metadata` reads such a
file back, the JAX package's included.
"""
from __future__ import annotations

import math
from pathlib import Path
from typing import Optional

import numpy as np

METADATA = "metadata.yaml"


def _yaml_scalar(value) -> str:
    """A bool, int or float as `yaml.safe_dump` spells it."""
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value).lower()
        if "." not in text and "e" in text:  # PyYAML: '1e17' -> '1.0e17'
            text = text.replace("e", ".0e", 1)
        return text
    raise TypeError(f"metadata value {value!r} is not a bool, int or float")


def _parse_scalar(text: str):
    low = text.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in (".inf", "+.inf", "-.inf", ".nan"):
        return float(low.replace(".", ""))
    try:
        return int(text)
    except ValueError:
        return float(text)


def write_metadata(db_path: str, meta: dict) -> None:
    lines = [f"{key}: {_yaml_scalar(meta[key])}" for key in sorted(meta)]
    (Path(db_path) / METADATA).write_text("\n".join(lines) + "\n")


def read_metadata(db_path: str) -> dict:
    meta = {}
    for line in (Path(db_path) / METADATA).read_text().splitlines():
        if line.strip() and not line.lstrip().startswith("#"):
            key, sep, value = line.partition(":")
            if not sep:
                raise ValueError(f"{db_path}/{METADATA}: not a `key: value` line: {line!r}")
            meta[key.strip()] = _parse_scalar(value.strip())
    return meta


class ArsWriter:
    def __init__(self, db_path: str, num_signal: int, channels: int, sr: int):
        self.db = Path(db_path)
        self.db.mkdir(parents=True, exist_ok=True)
        self.num_signal = num_signal
        self.channels = channels
        self.sr = sr
        self.n = 0
        self._f = open(self.db / "data.ars", "wb")

    def append(self, chunk: np.ndarray):
        """chunk int16 [num_signal, channels]."""
        if chunk.shape != (self.num_signal, self.channels):
            raise ValueError(f"record of shape {chunk.shape}, expected "
                             f"{(self.num_signal, self.channels)}")
        self._f.write(np.ascontiguousarray(chunk, dtype="<i2").tobytes())
        self.n += 1

    def close(self):
        self._f.close()
        write_metadata(self.db, {
            "lazy": False,
            "channels": self.channels,
            "n_seconds": self.n * self.num_signal / self.sr,
            "sr": self.sr,
            "num_signal": self.num_signal,
            "n_examples": self.n,
        })


class ArsReader:
    def __init__(self, db_path: str):
        self.db = Path(db_path)
        self.meta = read_metadata(db_path)
        self.num_signal = self.meta["num_signal"]
        self.channels = self.meta["channels"]
        rec = self.num_signal * self.channels
        self._mm = np.memmap(self.db / "data.ars", dtype="<i2", mode="r")
        self.n = len(self._mm) // rec
        self._rec = rec

    def __len__(self):
        return self.n

    def __getitem__(self, i: int) -> np.ndarray:
        rec = self._mm[i * self._rec : (i + 1) * self._rec]
        return np.asarray(rec).reshape(self.num_signal, self.channels)

    def records(self) -> np.ndarray:
        """[N, num_signal, channels] int16 view of the whole store."""
        return np.asarray(self._mm[: self.n * self._rec]).reshape(
            self.n, self.num_signal, self.channels)

    def nbytes(self) -> int:
        return self.n * self._rec * 2


def get_training_channels(db_path: str, target: Optional[int] = None) -> int:
    """Channel inference from dataset metadata (reference
    rave/dataset.py:163-172, scripts/train.py:139-140)."""
    data_channels = read_metadata(db_path).get("channels", 1)
    if target is None:
        return data_channels
    if target > data_channels:
        raise ValueError(
            f"requested {target} channels but dataset has {data_channels}"
        )
    return target
