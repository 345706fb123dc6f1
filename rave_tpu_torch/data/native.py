"""The C++ ARS batch sampler (csrc/ars_pipeline.cc) and its plain numpy twin.

The port's counterpart of rave_tpu/data/native.py. `NativeSampler` makes
the standard pipeline's batches (record fetch, random crop, int16 ->
float32, the random allpass phase mangle, the dequantize dither) in C++
threads outside the GIL, from the mmap'd store. The library is built from
the port's own copy of the source, with the JAX package's flags, into
`build/kernels/` under a hashed name (ops/kernels/build.py), at the first
`NativeSampler`: nothing is built at import. A failed build or a store the
sampler cannot open raises, with the compiler's output; nothing falls back.

`sample_plain` computes the same batch in numpy, in the C++ order of draws
and operations (splitmix64 in uint64 arithmetic, the allpass recurrence in
float64): the yardstick of the tests and of chip_smoke.py. The compiler
may fuse multiply-adds, so it agrees to float32 rounding, not bit for bit.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import numpy as np

from rave_tpu_torch.ops.kernels import build

SOURCE = "ars_pipeline"
GOLDEN = np.uint64(0x9E3779B97F4A7C15)
EPOCH_MUL = np.uint64(0xD1B54A32D192ED03)
MANGLE_MIN_F, MANGLE_MAX_F, MANGLE_AMP = 20.0, 2000.0, 0.99


@functools.cache
def get_lib() -> ctypes.CDLL:
    """The sampler's library, built at the first call; raises if it cannot be built."""
    lib = ctypes.CDLL(str(build.build_host(SOURCE)))
    lib.ars_open.restype = ctypes.c_void_p
    lib.ars_open.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64]
    lib.ars_len.restype = ctypes.c_int64
    lib.ars_len.argtypes = [ctypes.c_void_p]
    lib.ars_close.argtypes = [ctypes.c_void_p]
    lib.ars_sample_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.c_float),
    ]
    return lib


class NativeSampler:
    """Threaded mmap batch sampler over `<db_path>/data.ars`: [B, crop, C]
    float32 batches (rave_tpu/data/native.py:71-129)."""

    def __init__(self, db_path: str, num_signal: int, channels: int, crop: int, sr: int,
                 dither_bits: int = 16, mangle_p: float = 0.8, seed: int = 0):
        self.lib = get_lib()
        data = Path(db_path) / "data.ars"
        self.handle = self.lib.ars_open(str(data).encode(), num_signal, channels)
        if not self.handle:
            raise RuntimeError(f"the native sampler could not open {data}")
        self.crop, self.channels, self.sr = crop, channels, sr
        self.dither_bits, self.mangle_p, self.seed = dither_bits, mangle_p, seed

    def __len__(self):
        return int(self.lib.ars_len(self.handle))

    def sample(self, indices: np.ndarray, epoch_tag: int = 0) -> np.ndarray:
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        out = np.empty((len(idx), self.crop, self.channels), dtype=np.float32)
        self.lib.ars_sample_batch(
            self.handle, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(idx),
            self.crop, ctypes.c_uint64(self.seed), ctypes.c_uint64(epoch_tag),
            self.dither_bits, self.mangle_p, float(self.sr),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return out

    def close(self):
        if self.handle:
            self.lib.ars_close(self.handle)
            self.handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def _splitmix64(states: np.ndarray) -> np.ndarray:
    """splitmix64's output for the already advanced states (uint64, wrapping)."""
    with np.errstate(over="ignore"):
        z = states.copy()
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


class _Stream:
    """One row's splitmix64 stream: the k-th draw advances the state by k golden steps."""

    def __init__(self, state: np.uint64):
        self.state, self.drawn = state, 0

    def uniform(self, n: int) -> np.ndarray:
        """The next `n` uniform01 draws, float64."""
        with np.errstate(over="ignore"):
            k = np.arange(self.drawn + 1, self.drawn + n + 1, dtype=np.uint64)
            z = _splitmix64(self.state + k * GOLDEN)
        self.drawn += n
        return (z >> np.uint64(11)).astype(np.float64) * (1.0 / 9007199254740992.0)


def sample_plain(records: np.ndarray, indices, crop: int, sr: int, seed: int = 0,
                 epoch_tag: int = 0, dither_bits: int = 16,
                 mangle_p: float = 0.8) -> np.ndarray:
    """`NativeSampler.sample` in numpy over the store's int16 records
    [N, num_signal, C]: a [B, crop, C] float32 batch, in the C++ order."""
    num_signal, C = records.shape[1:]
    scale = np.float32(1.0 / 32767.0)
    dither_amp = np.float32(1.0 / (1 << (dither_bits - 1))) if dither_bits > 0 else None
    out = np.empty((len(indices), crop, C), dtype=np.float32)
    for b, index in enumerate(np.asarray(indices, dtype=np.int64)):
        with np.errstate(over="ignore"):
            state = (np.uint64(seed) ^ (GOLDEN * np.uint64(int(index) + 1))
                     ^ (np.uint64(epoch_tag) * EPOCH_MUL))
        s = _Stream(state)
        max_off = num_signal - crop
        off = min(int(s.uniform(1)[0] * float(max_off + 1)), max_off) if max_off > 0 else 0
        dst = records[index, off:off + crop].astype(np.float32) * scale
        if mangle_p > 0 and s.uniform(1)[0] < mangle_p:
            lo, hi = math.log(MANGLE_MIN_F), math.log(MANGLE_MAX_F)
            f = math.exp(float(s.uniform(1)[0]) * (hi - lo) + lo)
            omega = 2.0 * math.pi * f / sr
            re = MANGLE_AMP * math.cos(omega)
            a1, a2 = -2.0 * re, MANGLE_AMP * MANGLE_AMP
            b0, b1, b2 = MANGLE_AMP * MANGLE_AMP, -2.0 * re, 1.0
            for c in range(C):
                x1 = x2 = y1 = y2 = 0.0
                col = dst[:, c].astype(np.float64).tolist()
                for i, x in enumerate(col):
                    y = b0 * x + b1 * x1 + b2 * x2 - a1 * y1 - a2 * y2
                    x2, x1, y2, y1 = x1, x, y1, y
                    col[i] = y
                dst[:, c] = np.asarray(col, dtype=np.float64).astype(np.float32)
        if dither_amp is not None:
            u = s.uniform(crop * C).astype(np.float32).reshape(crop, C)
            dst = dst + u * dither_amp
        out[b] = dst
    return out
