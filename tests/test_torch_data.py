"""The port's data path against rave_tpu's: store, preprocess, transforms,
datasets, split, loader, and the device-resident pipeline's maths.

Where both sides are the same numpy code (store, metadata, preprocess,
transforms, split, Loader) the port must be exact: the same bytes and the
same float32 values. The device pipeline is torch against jax.numpy: the
allpass mangle and the assembled batch are held to 1e-5 absolute on
unit-scale audio from the exact filter, scipy.signal.lfilter in float64 on
the same draws, and to the JAX package's result within 1e-5 plus that
result's own distance from the exact filter. The JAX package evaluates the
biquad's response as expanded float32 polynomials, whose denominator cancels
near the pole: at these draws its mangle is up to 5.7e-5 from the exact
filter, and which way it errs turns on the last bit of its float32 cos, so
no float32 evaluation can be held to it alone at 1e-5. The port evaluates
the same filter in factored form (data/device_data.py), 3-4e-7 from exact.
The allpass is also held to scipy.signal.lfilter at 2e-4 with a pinned
angle, as tests/test_device_data.py holds the JAX one.
"""
import json

import jax
import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile
from scipy.signal import lfilter

from rave_tpu.data import device_data as jax_device_data
from rave_tpu.data import transforms as jax_T
from rave_tpu.data.dataset import get_dataset as jax_get_dataset
from rave_tpu.data.dataset import split_dataset as jax_split_dataset
from rave_tpu.data.loader import Loader as JaxLoader
from rave_tpu.data.preprocess import preprocess as jax_preprocess
from rave_tpu.data.store import ArsReader as JaxReader
from rave_tpu.data.store import ArsWriter as JaxWriter
from rave_tpu.data.store import read_metadata as jax_read_metadata
from rave_tpu_torch.data import device_data, store
from rave_tpu_torch.data import transforms as T
from rave_tpu_torch.data.dataset import get_dataset, split_dataset
from rave_tpu_torch.data.loader import Loader
from rave_tpu_torch.data.preprocess import preprocess
from rave_tpu_torch.train.loop import use_device_data
from rave_tpu_torch.config import compose

SR = 44100
MANGLE_TOL = 1e-5
WRITERS = {"jax": (JaxWriter, JaxReader), "port": (store.ArsWriter, store.ArsReader)}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Three seeded .wav files: a tone, a chirp and noise, of lengths that
    leave partial records (and one at 22050 Hz, resampled on decode)."""
    d = tmp_path_factory.mktemp("torch_corpus")
    rng = np.random.default_rng(0)
    t = np.arange(9 * 2048 + 300) / SR
    sigs = {"tone": 0.4 * np.sin(2 * np.pi * 330 * t),
            "chirp": 0.3 * np.sin(2 * np.pi * (100 + 2000 * t) * t),
            "noise": 0.2 * rng.standard_normal(t.size)}
    for name, x in sigs.items():
        wavfile.write(d / f"{name}.wav", SR, (x * 32767).astype(np.int16))
    x = 0.3 * np.sin(2 * np.pi * 220 * np.arange(5 * 2048) / 22050)
    wavfile.write(d / "low_rate.wav", 22050, (x * 32767).astype(np.int16))
    return d


@pytest.fixture(scope="module")
def dbs(corpus, tmp_path_factory):
    """The corpus preprocessed by each package, 2048-sample records."""
    root = tmp_path_factory.mktemp("torch_dbs")
    jax_preprocess(str(corpus), str(root / "jax"), 2048, SR, 1, workers=2)
    preprocess(str(corpus), str(root / "port"), 2048, SR, 1, workers=2)
    return str(root / "jax"), str(root / "port")


# ---- store and metadata ---------------------------------------------------

@pytest.mark.parametrize("value", [True, False, 0, 1, 131072, 0.0, 1.5, 297.2154195011338,
                                   1e17, 1e-05, -2.5e-300, float("inf"), float("-inf")])
def test_metadata_scalar_spelled_as_yaml(value):
    assert f"k: {store._yaml_scalar(value)}\n" == yaml.safe_dump({"k": value})
    assert store._parse_scalar(store._yaml_scalar(value)) == value


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_store_read_by_the_other_package(tmp_path, writer):
    write_cls, _ = WRITERS[writer]
    _, read_cls = WRITERS["port" if writer == "jax" else "jax"]
    rng = np.random.default_rng(1)
    recs = [(rng.standard_normal((512, 2)) * 8000).astype(np.int16) for _ in range(7)]
    w = write_cls(str(tmp_path / "db"), num_signal=512, channels=2, sr=22050)
    for r in recs:
        w.append(r)
    w.close()
    reader = read_cls(str(tmp_path / "db"))
    assert len(reader) == 7
    for i, r in enumerate(recs):
        np.testing.assert_array_equal(reader[i], r)
    meta = store.read_metadata(str(tmp_path / "db"))
    assert meta == jax_read_metadata(str(tmp_path / "db"))
    assert meta == yaml.safe_load((tmp_path / "db" / "metadata.yaml").read_text())
    assert meta == {"lazy": False, "channels": 2, "n_seconds": 7 * 512 / 22050, "sr": 22050,
                    "num_signal": 512, "n_examples": 7}
    assert store.ArsReader(str(tmp_path / "db")).nbytes() == 7 * 512 * 2 * 2


def test_preprocess_byte_identical(dbs):
    jax_db, port_db = dbs
    a = open(f"{jax_db}/data.ars", "rb").read()
    assert len(a) > 0 and a == open(f"{port_db}/data.ars", "rb").read()
    assert (open(f"{jax_db}/metadata.yaml").read() == open(f"{port_db}/metadata.yaml").read())
    assert store.read_metadata(port_db)["n_examples"] == 9 + 9 + 9 + 10


def test_preprocess_lazy_identical(corpus, tmp_path):
    jax_meta = jax_preprocess(str(corpus), str(tmp_path / "jax"), 2048, SR, 1, lazy=True,
                              workers=2)
    meta = preprocess(str(corpus), str(tmp_path / "port"), 2048, SR, 1, lazy=True, workers=2)
    assert meta == jax_meta
    for name in ("entries.json", "metadata.yaml"):
        assert (tmp_path / "jax" / name).read_text() == (tmp_path / "port" / name).read_text()
    # the lazy datasets decode the same slices through the same pipeline
    ref = jax_get_dataset(str(tmp_path / "jax"), SR, 1024)
    ds = get_dataset(str(tmp_path / "port"), SR, 1024)
    assert len(ds) == len(ref) > 0
    for i in (0, len(ds) // 2, len(ds) - 1):
        np.testing.assert_array_equal(ds.get(i, np.random.default_rng(i)),
                                      ref.get(i, np.random.default_rng(i)))


# ---- transforms, datasets, split, loader -----------------------------------

TRANSFORMS = {
    "RandomCrop": lambda m: m.RandomCrop(1500),
    "RandomCrop-pad": lambda m: m.RandomCrop(5000),
    "Dequantize": lambda m: m.Dequantize(16),
    "PhaseMangle": lambda m: m.PhaseMangle(sr=SR),
    "RandomApply": lambda m: m.RandomApply(m.PhaseMangle(sr=SR), p=0.5),
    "Resample": lambda m: m.Resample(22050, SR),
    "RandomPitch": lambda m: m.RandomPitch(2048, max_factor=1.2),
    "RandomGain": lambda m: m.RandomGain(prob=1.0),
    "RandomMute": lambda m: m.RandomMute(p=0.5),
    "FrequencyMasking": lambda m: m.FrequencyMasking(p=1.0),
    "Compress": lambda m: m.Compress(sr=SR),
    "RandomCompress": lambda m: m.RandomCompress(prob=1.0, sr=SR),
    "Derivator": lambda m: m.Derivator(),
    "Normalize": lambda m: m.Normalize(),
    "Compose": lambda m: m.Compose(m.RandomCrop(1024), m.Dequantize(16)),
    **{f"registry-{n}": (lambda n: lambda m: m.Compose(*m.get_augmentations([n], SR)))(n)
       for n in ("mute", "compress", "gain", "gain.gin",
                 '{"type": "RandomCompress", "prob": 0.5}')},
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_exact(name):
    x = (np.random.default_rng(2).standard_normal((2048, 2)) * 0.3).astype(np.float32)
    for seed in range(3):
        got = TRANSFORMS[name](T)(np.random.default_rng(seed), x.copy())
        want = TRANSFORMS[name](jax_T)(np.random.default_rng(seed), x.copy())
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_derivator_integrator_exact():
    x = np.random.default_rng(3).standard_normal(4096)
    for mine, theirs in zip(T.get_derivator_integrator(SR), jax_T.get_derivator_integrator(SR)):
        np.testing.assert_array_equal(mine(x), theirs(x))


def test_unported_augmentation_file_raises(tmp_path):
    """An augmentation gin file, refused until the gin reader was ported
    (A19), gives the JAX package's specs and transforms (the reader's own
    corpus: tests/test_torch_config_gin.py)."""
    from rave_tpu.config_gin import augmentations_from_gin as jax_specs
    from rave_tpu_torch.config_gin import augmentations_from_gin

    gin = tmp_path / "my_aug.gin"
    gin.write_text("add_augmentation.aug = @RandomMute()\nRandomMute.prob = 0.9\n")
    assert augmentations_from_gin(str(gin)) == jax_specs(str(gin))
    got, want = T.get_augmentations([str(gin)], SR), jax_T.get_augmentations([str(gin)], SR)
    assert [type(a).__name__ for a in got] == [type(a).__name__ for a in want] == ["RandomMute"]
    x = np.random.default_rng(4).standard_normal((4096, 1)).astype(np.float32)
    for seed in range(4):
        np.testing.assert_array_equal(got[0](np.random.default_rng(seed), x.copy()),
                                      want[0](np.random.default_rng(seed), x.copy()))


def test_dataset_and_split_match(dbs):
    jax_db, port_db = dbs
    ref = jax_get_dataset(jax_db, SR, 1500, augmentations=("gain",))
    ds = get_dataset(port_db, SR, 1500, augmentations=("gain",))
    assert len(ds) == len(ref)
    for i in range(0, len(ds), 7):
        np.testing.assert_array_equal(ds.get(i, np.random.default_rng((0, i))),
                                      ref.get(i, np.random.default_rng((0, i))))
    for n in (37, 50, 120, 5000):
        a, b = split_dataset(range(n)), jax_split_dataset(range(n))
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False), (True, False)],
                         ids=["shuffled", "ragged", "shuffled-ragged"])
def test_loader_same_batches(dbs, shuffle, drop_last):
    """The same seed and epoch give the same batches, [B, C, T] here and
    [B, T, C] in the JAX package; 37 records in batches of 8 leave a
    ragged last batch of 5."""
    jax_db, port_db = dbs
    ds, ref = get_dataset(port_db, SR, 1024), jax_get_dataset(jax_db, SR, 1024)
    idx = np.arange(len(ds))
    for epoch in (0, 1):
        got = list(Loader(ds, idx, 8, seed=3, shuffle=shuffle, workers=3,
                          drop_last=drop_last).epoch(epoch))
        want = list(JaxLoader(ref, idx, 8, seed=3, shuffle=shuffle, workers=3,
                              drop_last=drop_last).epoch(epoch))
        assert len(got) == len(want) == (4 if drop_last else 5)
        for g, w in zip(got, want):
            assert g.dtype == np.float32 and g.flags.c_contiguous
            np.testing.assert_array_equal(g, w.transpose(0, 2, 1))
    assert got[-1].shape[0] == (8 if drop_last else 5)


def test_loader_stops_cleanly(dbs):
    """Leaving an epoch early (as validation's max_batches does) ends it."""
    ds = get_dataset(dbs[1], SR, 1024)
    loader = Loader(ds, np.arange(len(ds)), 4, workers=2)
    it = loader.epoch(0)
    first = next(it)
    it.close()
    np.testing.assert_array_equal(first, next(loader.epoch(0)))
    forever = loader.forever()
    assert len([next(forever) for _ in range(2 * len(loader) + 1)]) == 2 * len(loader) + 1


# ---- the device-resident pipeline -------------------------------------------

def jax_mangle_draws(key, batch, p=0.8):
    kf, kp = jax.random.split(key)
    u = np.array(jax.random.uniform(kf, (batch,)))
    apply = np.array(jax.random.uniform(kp, (batch, 1, 1)) < p).reshape(batch)
    return torch.from_numpy(u), torch.from_numpy(apply)


def exact_mangle(x, u, apply):
    """The allpass of each applied row of x [B, C, T] by lfilter in float64,
    its angle from the float32 draw `u` as both packages compute it."""
    f32 = np.float32
    omega = f32(2 * np.pi / SR) * np.exp(u.numpy() * f32(np.log(2000.0) - np.log(20.0))
                                          + f32(np.log(20.0)))
    y = x.astype(np.float64)
    for b in np.nonzero(apply.numpy())[0]:
        y[b] = lfilter(*jax_T.pole_to_z_filter(float(omega[b]), 0.99), y[b], axis=-1)
    return y


def check_against_jax(got, want, exact):
    """got within MANGLE_TOL of exact, and of want beyond want's own error."""
    jax_err = np.abs(want - exact).max()
    assert np.abs(got - exact).max() <= MANGLE_TOL
    assert np.abs(got - want).max() <= jax_err + MANGLE_TOL, jax_err


@pytest.mark.parametrize("seed", [0, 5, 9])
def test_allpass_matches_jax(seed):
    """The torch allpass on the JAX pipeline's draws (replayed) against
    rave_tpu's allpass_mangle and the exact filter."""
    x = (np.random.default_rng(seed).standard_normal((6, 3000, 2)) * 0.3).astype(np.float32)
    key = jax.random.key(seed)
    want = np.asarray(jax_device_data.allpass_mangle(jax.numpy.asarray(x), key, SR))
    u, apply = jax_mangle_draws(key, 6)
    assert 0 < int(apply.sum()) <= 6
    x = x.transpose(0, 2, 1).copy()
    got = device_data.allpass_mangle(torch.from_numpy(x), u, apply, SR)
    check_against_jax(got.numpy(), want.transpose(0, 2, 1), exact_mangle(x, u, apply))


@pytest.mark.parametrize("freq_hz", [20.0, 440.0, 1999.0])
def test_allpass_matches_lfilter(freq_hz):
    """A pinned pole angle (min_f == max_f) against scipy's time-domain IIR."""
    x = (np.random.default_rng(0).standard_normal((1, 1, 8192)) * 0.3).astype(np.float32)
    y = device_data.allpass_mangle(torch.from_numpy(x), torch.zeros(1), torch.ones(1, dtype=bool),
                                   SR, min_f=freq_hz, max_f=freq_hz)
    b, a = jax_T.pole_to_z_filter(2 * np.pi * freq_hz / SR, 0.99)
    np.testing.assert_allclose(y[0, 0].numpy(), lfilter(b, a, x[0, 0]).astype(np.float32),
                               atol=2e-4)


def test_allpass_apply_mask_passes_rows_through():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 1, 2048)).astype(np.float32))
    apply = torch.tensor([True, False, True, False])
    y = device_data.allpass_mangle(x, torch.rand(4), apply, SR)
    assert torch.equal(y[~apply], x[~apply])
    assert ((y[apply] - x[apply]).abs().amax(dim=(1, 2)) > 1e-4).all()


def test_pipeline_matches_jax_with_its_draws(dbs):
    """The port's assemble, fed the draws of the JAX pipeline's batch at a
    step (replayed with jax.random), makes that batch (rule of
    check_against_jax)."""
    jax_db, port_db = dbs
    indices = list(range(3, 30))
    seed, step, B, n = 7, 5, 4, 1500
    ref = jax_device_data.DeviceDataPipeline(jax_db, indices, B, n, SR, seed=seed)
    pipe = device_data.DeviceDataPipeline(port_db, indices, B, n, SR, seed=seed, device="cpu")
    key = jax.random.fold_in(jax.random.key(seed), step)
    k_row, k_off, k_mangle, k_dither = jax.random.split(key, 4)
    rows = np.asarray(indices)[np.array(jax.random.randint(k_row, (B,), 0, len(indices)))]
    offsets = np.array(jax.random.randint(k_off, (B,), 0, 2048 - n + 1))
    u, apply = jax_mangle_draws(k_mangle, B)
    dither = np.asarray(jax.random.uniform(k_dither, (B, n, 1))).transpose(0, 2, 1).copy()
    draws = device_data.Draws(torch.from_numpy(rows), torch.from_numpy(offsets), u, apply,
                              torch.from_numpy(dither))
    crops = np.stack([JaxReader(jax_db)[r][o : o + n].T for r, o in zip(rows, offsets)])
    exact = exact_mangle(crops.astype(np.float32) / np.float32(32767.0), u, apply) + dither / 2**15
    check_against_jax(pipe.assemble(draws).numpy(),
                      np.asarray(ref.batch_at(step)).transpose(0, 2, 1), exact)


def test_pipeline_deterministic_in_seed_and_step(dbs):
    port_db = dbs[1]
    make = lambda seed: device_data.DeviceDataPipeline(  # noqa: E731
        port_db, list(range(30)), 4, 1500, SR, seed=seed, device="cpu")
    a, b = make(7), make(7)
    unbroken = [a.batch_at(s) for s in range(4)]  # a run from step 0
    assert unbroken[0].shape == (4, 1, 1500) and unbroken[0].dtype == torch.float32
    assert unbroken[0].abs().max() <= 1.0 + 2 ** -14
    assert torch.equal(b.batch_at(3), unbroken[3])  # a run resumed at step 3
    assert (unbroken[2] - unbroken[3]).abs().max() > 1e-3
    assert (make(8).batch_at(3) - unbroken[3]).abs().max() > 1e-3
    assert device_data.db_nbytes(port_db) == 37 * 2048 * 2


def test_device_data_rule(dbs, monkeypatch, tmp_path):
    """The JAX loop's choice: on unless off, augmented, lazy or over budget on 'auto'."""
    port_db = dbs[1]
    cfg = compose(["v2"])
    assert use_device_data(cfg, port_db, "auto") and not use_device_data(cfg, port_db, "off")
    monkeypatch.setenv("RAVE_TPU_DEVICE_DATA_MAX_GB", "1e-6")
    assert not use_device_data(cfg, port_db, "auto") and use_device_data(cfg, port_db, "on")
    assert not use_device_data(compose(["v2"], ['data.augmentations=["mute"]']), port_db, "on")
    lazy = tmp_path / "lazy"
    lazy.mkdir()
    store.write_metadata(lazy, {"lazy": True, "channels": 1, "sr": SR, "num_signal": 2048,
                                "n_examples": 0, "n_seconds": 0.0})
    (lazy / "entries.json").write_text(json.dumps([]))
    assert not use_device_data(cfg, str(lazy), "on")
