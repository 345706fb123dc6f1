"""The C++ ARS sampler and the loaders: rave_tpu_torch against rave_tpu.

Both packages build the same sampler source with the same g++ flags here,
so the port's `NativeSampler` must give the JAX package's batches bit for
bit, over seeds, epoch tags, crops (a random offset and none), channels,
`dither_bits` 0 and 16 and `mangle_p` 0 and 0.8. The numpy twin
`sample_plain` is held to it within 1e-6 (the compiler may fuse the
allpass's multiply-adds). `NativeLoader` and a sharded `Loader` must give
the JAX loaders' batches, transposed to [B, C, T], for 1 to 3 hosts. The
library is built under a hashed name, a failed build raises with the
compiler's output, and an unopenable store raises.
"""
import numpy as np
import pytest

from rave_tpu.data import native as jax_native
from rave_tpu.data.dataset import get_dataset as jax_get_dataset
from rave_tpu.data.loader import Loader as JaxLoader
from rave_tpu.data.loader import NativeLoader as JaxNativeLoader
from rave_tpu_torch.data import native
from rave_tpu_torch.data.dataset import get_dataset
from rave_tpu_torch.data.loader import Loader, NativeLoader
from rave_tpu_torch.data.store import ArsReader, ArsWriter
from rave_tpu_torch.ops.kernels import build

SR = 44100
NUM_SIGNAL, N_RECORDS = 4096, 13
PLAIN_TOL = 1e-6


def make_store(root, channels: int, lazy_meta: bool = False) -> str:
    w = ArsWriter(str(root), num_signal=NUM_SIGNAL, channels=channels, sr=SR)
    rng = np.random.default_rng(channels)
    t = np.arange(NUM_SIGNAL) / SR
    for i in range(N_RECORDS):
        x = 0.4 * np.sin(2 * np.pi * (100 + 37 * i) * t)[:, None] + 0.1 * rng.standard_normal(
            (NUM_SIGNAL, channels))
        w.append((np.clip(x, -1, 1) * 32767).astype(np.int16))
    w.close()
    return str(root)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_native")
    return {c: make_store(root / f"c{c}", c) for c in (1, 2)}


@pytest.fixture(scope="module")
def jax_lib():
    lib = jax_native.get_lib()
    assert lib is not None, "the JAX package's sampler did not build"
    return lib


CASES = [  # (channels, crop, seed, epoch_tag, dither_bits, mangle_p)
    (1, 1024, 0, 0, 16, 0.8), (1, 1024, 7, 3, 0, 0.8), (1, 4096, 3, 1, 16, 0.0),
    (2, 1024, 11, 2, 16, 0.8), (2, 2000, 5, 9, 0, 0.0), (2, 4096, 1, 4, 16, 0.8),
    (1, 3000, 123456789, 2**40, 16, 0.8),
]


@pytest.mark.parametrize("C, crop, seed, epoch_tag, dither_bits, mangle_p", CASES)
def test_sampler_bit_equal_to_jax(stores, jax_lib, C, crop, seed, epoch_tag, dither_bits,
                                  mangle_p):
    kw = dict(crop=crop, sr=SR, dither_bits=dither_bits, mangle_p=mangle_p, seed=seed)
    ours = native.NativeSampler(stores[C], NUM_SIGNAL, C, **kw)
    ref = jax_native.NativeSampler(stores[C], NUM_SIGNAL, C, **kw)
    assert len(ours) == len(ref) == N_RECORDS
    idx = np.array([0, 5, 12, 3, 5, 9, 1, 7])
    got, want = ours.sample(idx, epoch_tag), ref.sample(idx, epoch_tag)
    assert got.shape == (len(idx), crop, C) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    plain = native.sample_plain(ArsReader(stores[C]).records(), idx, crop, SR, seed=seed,
                                epoch_tag=epoch_tag, dither_bits=dither_bits,
                                mangle_p=mangle_p)
    assert np.abs(plain - got).max() <= PLAIN_TOL
    # rows 1 and 4 are the same record: the same stream, so the same row
    np.testing.assert_array_equal(got[1], got[4])


def test_plain_draws_change_with_the_row_stream(stores):
    records = ArsReader(stores[1]).records()
    a = native.sample_plain(records, [2], 1024, SR, seed=1, epoch_tag=1)
    for kw in ({"seed": 2, "epoch_tag": 1}, {"seed": 1, "epoch_tag": 2}):
        assert not np.array_equal(a, native.sample_plain(records, [2], 1024, SR, **kw))
    exact = native.sample_plain(records, [2], NUM_SIGNAL, SR, dither_bits=0, mangle_p=0.0)
    np.testing.assert_array_equal(exact[0], records[2].astype(np.float32) * np.float32(1 / 32767))


@pytest.mark.parametrize("host_count", [1, 2, 3])
def test_native_loader_matches_jax(stores, jax_lib, host_count):
    idx = np.arange(N_RECORDS)[::-1].copy()
    for host_id in range(host_count):
        ours = NativeLoader(stores[2], idx, 2, 1024, SR, seed=4, host_id=host_id,
                            host_count=host_count)
        ref = JaxNativeLoader(stores[2], idx, 2, 1024, SR, seed=4, host_id=host_id,
                              host_count=host_count)
        assert len(ours) == len(ref) == len(idx[host_id::host_count]) // 2
        for epoch in (0, 1):
            got, want = list(ours.epoch(epoch)), list(ref.epoch(epoch))
            assert len(got) == len(want) == len(ours)
            for g, w in zip(got, want):
                assert g.flags.c_contiguous and g.shape == (2, 2, 1024)
                np.testing.assert_array_equal(g, w.transpose(0, 2, 1))


@pytest.mark.parametrize("host_count", [1, 2, 3])
def test_sharded_loader_matches_jax(stores, host_count):
    ds, ref = get_dataset(stores[1], SR, 1024), jax_get_dataset(stores[1], SR, 1024)
    idx = np.arange(N_RECORDS)
    shards = []
    for host_id in range(host_count):
        ours = Loader(ds, idx, 2, seed=3, workers=2, host_id=host_id, host_count=host_count,
                      drop_last=False)
        want = list(JaxLoader(ref, idx, 2, seed=3, workers=2, host_id=host_id,
                              host_count=host_count, drop_last=False).epoch(1))
        got = list(ours.epoch(1))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w.transpose(0, 2, 1))
        shards.append(ours.indices)
    np.testing.assert_array_equal(np.sort(np.concatenate(shards)), idx)


def test_native_loader_refuses_a_lazy_store(tmp_path):
    (tmp_path / "metadata.yaml").write_text("lazy: true\nchannels: 1\nsr: 44100\n")
    with pytest.raises(ValueError, match="non-lazy"):
        NativeLoader(str(tmp_path), np.arange(3), 1, 1024, SR)


def test_unopenable_store_raises(tmp_path):
    with pytest.raises(RuntimeError, match="could not open"):
        native.NativeSampler(str(tmp_path / "missing"), NUM_SIGNAL, 1, crop=1024, sr=SR)


def test_library_hashed_and_build_failure_raises(tmp_path, monkeypatch):
    lib = build.build_host(native.SOURCE)
    assert lib.parent == build.BUILD_DIR and lib.name.startswith("libars_pipeline-")
    target = build.host_target("g++")
    assert target and lib == build.library_path(native.SOURCE, build.GXX_FLAGS, ".cc", target)
    assert lib != build.library_path(native.SOURCE, build.GXX_FLAGS, ".cc", target + b"x")
    assert not list(build.BUILD_DIR.glob("*.tmp"))
    (tmp_path / "broken.cc").write_text("this is not C++\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build broken.cc") as info:
        build.build_host("broken")
    assert "error" in str(info.value)
    assert not list((tmp_path / "out").glob("*.so"))
