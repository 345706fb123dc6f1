"""Host-side (numpy) waveform transforms & augmentation registry.

The port's copy of rave_tpu/data/transforms.py: the same numpy and scipy
code, so that under the same `np.random.Generator` every transform gives
exactly the JAX package's output. An augmentation `.gin` file goes through
the port's gin reader (config_gin.augmentations_from_gin); the stock
`mute.gin` / `compress.gin` / `gain.gin` names without a file resolve to
their built-ins.

Capability parity with rave/transforms.py: RandomCrop, phase mangling,
Dequantize, RandomPitch, Resample, Compose, RandomApply, RandomGain,
RandomMute, FrequencyMasking, Compress/RandomCompress (compand-style
compressor implemented in numpy since sox is not vendored), plus the
gin-style augmentation registry (rave/transforms.py:202-210).

All transforms map float32 [T, C] -> [T, C] given a numpy Generator.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
from scipy.signal import lfilter, resample_poly


class Transform:
    def __call__(self, rng: np.random.Generator, x: np.ndarray) -> np.ndarray:
        raise NotImplementedError


class Compose(Transform):
    def __init__(self, *transforms):
        self.transforms = list(transforms)

    def __call__(self, rng, x):
        for t in self.transforms:
            x = t(rng, x)
        return x


class RandomApply(Transform):
    """Apply with probability p (reference rave/transforms.py:18-29)."""

    def __init__(self, transform: Transform, p: float = 0.5):
        self.transform = transform
        self.p = p

    def __call__(self, rng, x):
        if rng.random() < self.p:
            x = self.transform(rng, x)
        return x


class RandomCrop(Transform):
    """Random n_signal crop (reference rave/transforms.py:92-102)."""

    def __init__(self, n_signal: int):
        self.n_signal = n_signal

    def __call__(self, rng, x):
        if x.shape[0] <= self.n_signal:
            pad = self.n_signal - x.shape[0]
            return np.pad(x, ((0, pad), (0, 0)))
        start = rng.integers(0, x.shape[0] - self.n_signal + 1)
        return x[start : start + self.n_signal]


class Dequantize(Transform):
    """Add uniform dither at the source bit depth
    (reference rave/transforms.py:105-111)."""

    def __init__(self, bit_depth: int = 16):
        self.bit_depth = bit_depth

    def __call__(self, rng, x):
        return x + rng.random(x.shape).astype(x.dtype) / 2 ** (self.bit_depth - 1)


def random_angle(rng, min_f=20.0, max_f=8000.0, sr=24000):
    """Log-uniform angular frequency (reference rave/core.py:24-29)."""
    f = math.exp(rng.random() * (math.log(max_f) - math.log(min_f)) + math.log(min_f))
    return 2 * math.pi * f / sr


def pole_to_z_filter(omega, amplitude=0.9):
    """All-pass from a conjugate pole pair (reference rave/core.py:36-40)."""
    z0 = amplitude * np.exp(1j * omega)
    a = [1, -2 * np.real(z0), abs(z0) ** 2]
    b = [abs(z0) ** 2, -2 * np.real(z0), 1]
    return b, a


class PhaseMangle(Transform):
    """Random allpass phase mangling (reference rave/core.py:42-45,
    applied with p=.8 in rave/dataset.py:223-231)."""

    def __init__(self, min_f=20.0, max_f=2000.0, amplitude=0.99, sr=44100):
        self.min_f, self.max_f = min_f, max_f
        self.amplitude = amplitude
        self.sr = sr

    def __call__(self, rng, x):
        angle = random_angle(rng, self.min_f, self.max_f, self.sr)
        b, a = pole_to_z_filter(angle, self.amplitude)
        return lfilter(b, a, x, axis=0).astype(x.dtype)


class Resample(Transform):
    """Static integer-factor resample (reference rave/transforms.py:31-40)."""

    def __init__(self, orig_sr: int, target_sr: int):
        self.orig_sr, self.target_sr = orig_sr, target_sr

    def __call__(self, rng, x):
        g = math.gcd(self.orig_sr, self.target_sr)
        return resample_poly(
            x, self.target_sr // g, self.orig_sr // g, axis=0
        ).astype(x.dtype)


class RandomPitch(Transform):
    """Random rational pitch shift keeping length
    (reference rave/transforms.py:56-89)."""

    def __init__(self, n_signal: int, max_factor: float = 1.2):
        self.n_signal = n_signal
        self.max_factor = max_factor

    def __call__(self, rng, x):
        factor = self.max_factor ** (2 * rng.random() - 1)
        num = max(1, round(factor * 64))
        y = resample_poly(x, num, 64, axis=0).astype(x.dtype)
        if y.shape[0] < self.n_signal:
            y = np.pad(y, ((0, self.n_signal - y.shape[0]), (0, 0)))
        return y[: self.n_signal]


class RandomGain(Transform):
    """Random gain in dB, clipping-aware (reference rave/transforms.py:147-165;
    the reference's forward accidentally returns the un-gained tensor — here
    the gain is actually applied)."""

    def __init__(self, gain_range=(-6.0, 3.0), prob: float = 0.5,
                 limit: bool = True):
        # `prob`/`limit` take the reference's parameter names
        # (rave/transforms.py:149) so gin/JSON specs port unchanged
        self.gain_range = gain_range
        self.prob = prob
        self.limit = limit

    def __call__(self, rng, x):
        if self.prob < 1.0 and rng.random() >= self.prob:
            return x
        g = rng.uniform(*self.gain_range)
        amp = 10 ** (g / 20)
        if self.limit:
            peak = np.max(np.abs(x)) + 1e-9
            amp = min(amp, 1.0 / peak)
        return x * amp


class RandomMute(Transform):
    """Zero the example with probability p (reference rave/transforms.py:168-177).
    `prob` is accepted as the reference's name for the same parameter."""

    def __init__(self, p: float = 0.1, prob: Optional[float] = None):
        self.p = p if prob is None else prob

    def __call__(self, rng, x):
        if rng.random() < self.p:
            return np.zeros_like(x)
        return x


class FrequencyMasking(Transform):
    """Random band-stop via STFT masking (reference rave/transforms.py:180-195)."""

    def __init__(self, p: float = 0.5, n_fft: int = 1024, max_width: int = 128):
        self.p, self.n_fft, self.max_width = p, n_fft, max_width

    def __call__(self, rng, x):
        if rng.random() > self.p:
            return x
        T, C = x.shape
        hop = self.n_fft // 4
        pad = (-T) % hop
        xp = np.pad(x, ((0, pad + self.n_fft), (0, 0)))
        frames = np.lib.stride_tricks.sliding_window_view(xp, self.n_fft, axis=0)[
            ::hop
        ]  # [F, C, n_fft]
        win = np.hanning(self.n_fft)
        S = np.fft.rfft(frames * win, axis=-1)
        bins = S.shape[-1]
        f0 = rng.integers(0, bins)
        w = rng.integers(1, self.max_width)
        S[..., f0 : f0 + w] = 0
        rec = np.fft.irfft(S, axis=-1) * win
        out = np.zeros_like(xp)
        norm = np.zeros((xp.shape[0], 1))
        for i in range(rec.shape[0]):
            out[i * hop : i * hop + self.n_fft] += rec[i].T
            norm[i * hop : i * hop + self.n_fft, 0] += win**2
        out = out / np.maximum(norm, 1e-8)
        return out[:T].astype(x.dtype)


# ---- sox `compand` (reference rave/transforms.py:114-145 shells out to
# torchaudio sox_effects; here the algorithm itself: a per-sample
# attack/release envelope follower + a piecewise-linear dB transfer curve
# with C1 quadratic soft knees, per sox compand.c / compandt.c semantics) --


def parse_sox_transfer(lookup: str):
    """Parse a sox transfer spec `[soft-knee-dB:]v1,v2,...` into
    (knee_db, [(in_db, out_db), ...]).

    sox pairs the values left-to-right; with an odd count the first value
    is a lone in-dB whose out-dB equals itself (the man-page example
    `6:-70,-60,-20` reads as points (-70,-70),(-60,-20): "very soft sounds
    (below -70dB) will remain unchanged ... -60dB to 0dB boosted"). A final
    (0,0) point is appended when the curve does not already reach 0 dB in
    (same example: "60dB dynamic range compressed 3-to-1 into a 20dB
    range" = the (-60,-20)->(0,0) segment)."""
    s = lookup.strip()
    knee = 0.01
    head = s.split(",", 1)[0]
    if ":" in head:
        k, s = s.split(":", 1)
        knee = max(float(k), 0.01)
    vals = [float(v) for v in s.split(",") if v.strip()]
    if len(vals) % 2:
        pts = [(vals[0], vals[0])] + list(zip(vals[1::2], vals[2::2]))
    else:
        pts = list(zip(vals[0::2], vals[1::2]))
    pts = sorted(pts)
    if pts[-1][0] < 0.0:
        pts.append((0.0, 0.0))
    return knee, pts


class TransferFn:
    """Piecewise-linear transfer in the log-amplitude domain with quadratic
    soft-knee joints (C1: each knee matches value+slope of both adjacent
    straight segments). Input/output are linear amplitudes."""

    def __init__(self, points_db, knee_db: float = 0.01):
        L = math.log(10) / 20  # dB -> natural log amplitude
        xs = np.asarray([p[0] for p in points_db], np.float64) * L
        ys = np.asarray([p[1] for p in points_db], np.float64) * L
        r = knee_db * L / 2
        # knots: [x0] + per-interior-vertex knee windows + [xN]
        brk, coef = [], []  # segment start x; (a, b, y0) with
        # y(x) = a*(x-x0)^2 + b*(x-x0) + y0 on [x0, next)
        slopes = np.diff(ys) / np.maximum(np.diff(xs), 1e-12)
        cur_x, cur_y = xs[0], ys[0]
        for j in range(1, len(xs) - 1):
            m1, m2 = slopes[j - 1], slopes[j]
            rj = min(r, (xs[j] - cur_x) / 2, (xs[j + 1] - xs[j]) / 2)
            rj = max(rj, 0.0)
            # straight run up to the knee window
            brk.append(cur_x)
            coef.append((0.0, m1, cur_y))
            x0 = xs[j] - rj
            y0 = ys[j] - m1 * rj
            if rj > 0:
                a = (m2 - m1) / (4 * rj)
                brk.append(x0)
                coef.append((a, m1, y0))
                cur_x = xs[j] + rj
                cur_y = ys[j] + m2 * rj
            else:
                cur_x, cur_y = xs[j], ys[j]
        brk.append(cur_x)
        coef.append((0.0, slopes[-1], cur_y))
        self._brk = np.asarray(brk)
        self._coef = np.asarray(coef)  # [S, 3]
        self._in_min = math.exp(xs[0])
        self._out_min = math.exp(ys[0])
        self._x_end, self._y_end = xs[-1], ys[-1]

    def __call__(self, v: np.ndarray) -> np.ndarray:
        """Linear envelope -> linear output level (sox lsx_compandt:
        flat at out_min below the first point; the last segment's slope
        extends beyond the last point)."""
        v = np.asarray(v, np.float64)
        lo = v <= self._in_min
        x = np.log(np.maximum(v, 1e-30))
        i = np.clip(np.searchsorted(self._brk, x, side="right") - 1, 0, len(self._brk) - 1)
        a, b, y0 = self._coef[i, 0], self._coef[i, 1], self._coef[i, 2]
        d = x - self._brk[i]
        y = y0 + d * (a * d + b)
        return np.where(lo, self._out_min, np.exp(y))


def envelope_follow(
    level: np.ndarray, attack_coef: float, release_coef: float, v0: float
) -> np.ndarray:
    """One-pole envelope with separate attack/release rates
    (sox compand.c doVolume). `level` is [T] >= 0."""
    if attack_coef == release_coef:
        # single linear one-pole: vectorized exactly via lfilter
        c = attack_coef
        zi = np.asarray([(1 - c) * v0])
        y, _ = lfilter([c], [1, -(1 - c)], level, zi=zi)
        return y
    out = np.empty_like(level, dtype=np.float64)
    v = v0
    ac, rc = attack_coef, release_coef
    lv = level.tolist()
    for t, s in enumerate(lv):
        v += (s - v) * (ac if s > v else rc)
        out[t] = v
    return out


def compand(
    x: np.ndarray,
    sr: int,
    attack: float,
    release: float,
    lookup: str,
    gain_db: float = 0.0,
    initial_volume_db: float = -120.0,
) -> np.ndarray:
    """sox `compand attack,release lookup gain` on [T, C] float audio.

    Channels are linked through a shared max-amplitude envelope, matching
    sox's behavior when a single attack/release pair drives multichannel
    audio (sox compand.c: expectedChannels == 1)."""
    knee, pts = parse_sox_transfer(lookup)
    tf = TransferFn(pts, knee)
    ac = 1 - math.exp(-1 / (sr * attack)) if attack > 1 / sr else 1.0
    rc = 1 - math.exp(-1 / (sr * release)) if release > 1 / sr else 1.0
    level = np.max(np.abs(x), axis=1) if x.ndim == 2 else np.abs(x)
    v = envelope_follow(level, ac, rc, 10 ** (initial_volume_db / 20))
    g = tf(v) / np.maximum(v, 1e-30) * 10 ** (gain_db / 20)
    y = x * (g[:, None] if x.ndim == 2 else g)
    return np.clip(y, -1.0, 1.0).astype(x.dtype)


class Compress(Transform):
    """sox compand with an explicit transfer spec
    (reference rave/transforms.py:114-123; normalize_ambient.gin:1-8)."""

    def __init__(
        self, time: str = "0.1,0.1", lookup: str = "6:-70,-60,-20",
        gain: str = "0", sr: int = 44100,
    ):
        a, r = (float(v) for v in time.split(","))
        self.attack, self.release = a, r
        self.lookup = lookup
        self.gain = float(gain)
        self.sr = sr

    def __call__(self, rng, x):
        return compand(x, self.sr, self.attack, self.release, self.lookup, self.gain)


class RandomCompress(Transform):
    """Compressor with a random makeup point: sox
    `compand attack,release 6:-80,<threshold>,<amp>` with
    amp ~ U(amp_range), applied with probability `prob`
    (reference rave/transforms.py:125-145)."""

    def __init__(
        self, threshold: float = -40.0, amp_range=(-60.0, 0.0),
        attack: float = 0.1, release: float = 0.1,
        prob: float = 0.8, sr: int = 44100,
    ):
        self.threshold = threshold
        self.amp_range = amp_range
        self.attack, self.release = attack, release
        self.prob = prob
        self.sr = sr

    def __call__(self, rng, x):
        if rng.random() > self.prob:
            return x
        amp = rng.uniform(*self.amp_range)
        lookup = f"6:-80,{self.threshold},{amp}"
        return compand(x, self.sr, self.attack, self.release, lookup)


def get_derivator_integrator(sr: int):
    """The exact derivator/integrator filter pair the reference trains and
    logs with (reference rave/dataset.py:24-29): a half-gain first difference
    and its leaky inverse (double pole at ``alpha``, 10 Hz cutoff). Note the
    cascade is NOT unity — passband gain is ``alpha**2 / 2`` (~0.499) with a
    2nd-order 10 Hz highpass; we replicate that, not an idealized inverse."""
    alpha = 1 / (1 + 1 / sr * 2 * np.pi * 10)
    derivator = ([0.5, -0.5], [1.0])
    integrator = ([alpha**2, -(alpha**2)], [1.0, -2 * alpha, alpha**2])
    return (
        lambda x: lfilter(*derivator, x, axis=0),
        lambda x: lfilter(*integrator, x, axis=0),
    )


class Derivator(Transform):
    """Half-gain first difference applied to training data when
    ``--derivative`` is set (reference rave/dataset.py:26,244-245)."""

    def __call__(self, rng, x):
        return lfilter([0.5, -0.5], [1.0], x, axis=0).astype(x.dtype)


class Normalize(Transform):
    def __call__(self, rng, x):
        return (x / (np.max(np.abs(x)) + 1e-9)).astype(x.dtype)


# ---- augmentation registry & resolution (reference rave/transforms.py:
# 202-210 + scripts/train.py:127-132: any gin file calling
# `add_augmentation` is accepted; here the equivalents are registry names,
# inline JSON specs, and user Python files) ---------------------------------

_AUGMENTATIONS: Dict[str, Callable[[int], Transform]] = {
    # built-ins mirror configs/augmentations/{mute,compress,gain}.gin,
    # which instantiate the transforms with their class defaults
    "mute": lambda sr: RandomMute(p=0.1),
    "compress": lambda sr: RandomCompress(sr=sr),
    "gain": lambda sr: RandomGain((-6.0, 3.0), prob=0.5),
}


def add_augmentation(name: str, factory: Callable[[int], Transform]):
    _AUGMENTATIONS[name] = factory


def _from_spec(spec: dict, sr: int) -> Transform:
    """{"type": "<Transform class>", **kwargs} -> instance. Classes that
    take a sampling rate get it injected unless overridden."""
    import inspect

    kw = dict(spec)
    cls = globals()[kw.pop("type")]
    if not (isinstance(cls, type) and issubclass(cls, Transform)):
        raise TypeError(f"{spec['type']} is not a Transform")
    params = inspect.signature(cls.__init__).parameters
    if "sr" in params and "sr" not in kw:
        kw["sr"] = sr
    for k, v in kw.items():
        if isinstance(v, list):
            kw[k] = tuple(v)
    return cls(**kw)


def get_augmentations(names: Sequence[str], sr: int) -> List[Transform]:
    """Resolve augmentation specs in CLI order. Each spec is one of:
      * a registry name ("mute", "compress", "gain", or user-registered);
      * an inline JSON object spec: '{"type": "RandomCompress", "prob": 0.5}';
      * a path to a Python file that calls `add_augmentation(transform)` or
        `add_augmentation(name, factory)` (the gin augmentation-file
        equivalent, reference transforms.py:202-210)."""
    import json as _json
    from pathlib import Path

    out: List[Transform] = []
    for n in names:
        s = str(n).strip()
        if s in _AUGMENTATIONS:
            out.append(_AUGMENTATIONS[s](sr))
        elif s.startswith("{"):
            out.append(_from_spec(_json.loads(s), sr))
        elif s.endswith(".gin"):
            # reference augmentation gin file (configs/augmentations/*.gin,
            # scripts/train.py:127-132) — a reference user's literal
            # `--augment mute.gin` works unchanged; a stock name with the
            # extension but no file resolves to the built-in equivalent
            stem = Path(s).stem
            if not Path(s).is_file() and stem in _AUGMENTATIONS:
                out.append(_AUGMENTATIONS[stem](sr))
                continue
            from rave_tpu_torch.config_gin import augmentations_from_gin

            for spec in augmentations_from_gin(s):
                out.append(_from_spec(_json.loads(spec), sr))
        elif s.endswith(".py") or Path(s).is_file():
            out.extend(load_augmentation_file(s, sr))
        else:
            raise KeyError(
                f"unknown augmentation '{s}': not a registry name "
                f"({sorted(_AUGMENTATIONS)}), JSON spec, .gin/.py file"
            )
    return out


def load_augmentation_file(path: str, sr: int) -> List[Transform]:
    """Execute a user augmentation file. The file sees this module's
    namespace (all Transform classes, SR) plus `add_augmentation`, which —
    like the reference gin files — appends a transform to the pipeline;
    the two-argument registry form is also accepted."""
    from pathlib import Path

    collected: List[Transform] = []

    def _add(a, b=None):
        if b is None:
            collected.append(a if isinstance(a, Transform) else a(sr))
        else:  # registry form: add_augmentation(name, factory)
            add_augmentation(a, b)

    ns = {k: v for k, v in globals().items() if not k.startswith("_")}
    ns.update(add_augmentation=_add, SR=sr, np=np)
    code = Path(path).read_text()
    exec(compile(code, path, "exec"), ns)  # noqa: S102 — user-owned config
    return collected
