"""The port's native artifact host (csrc/rtpu_host.cc) on the CPU, against the port's Python artifact.

The host is built once from the repository's source by `ensure_host()`
(g++ against the installed torch) and run as a subprocess on tiny
artifacts exported here on the CPU:

  * every step program's `.ts` gives outputs and state bit-equal to its
    `.pt2` program's on the same inputs, and the manifest names a `ts_file`
    and a `state_file` for every step;
  * `info` agrees with the manifest and reports the CPU;
  * `encode` latents and the state after them are bit-equal to the port's
    Python artifact streamed block by block from the same seed chain;
    `forward` and `decode` wavs within 1/32767 of its output (the wav's
    int16 rounding), their states bit-equal;
  * a step that draws (a variational `encode`, every `decode`) is held to
    the Python artifact, which tests/test_torch_stream_graph.py holds to
    rave_tpu with the draws injected; the steps that draw nothing are held
    to rave_tpu by tests/test_torch_native_host_jax.py;
  * the AdaIN sequence in three processes (learn the target, learn the
    source, transfer; `--save-state` / `--load-state`) equals one Python
    stream with the same setter calls;
  * `prior` equals `sample_prior(n_frames, seed)` bit for bit, and with
    `--no-dither` the same chain decoded without the dither;
  * the host refuses a stream_batch 2 artifact, an unknown `--attr`, and an
    artifact exported on `cuda` where there is no card.

The host and the Python side both run with 2 CPU threads.
"""
import json
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from rave_tpu_torch import config
from rave_tpu_torch.export.artifact import STEP_METHODS, ExportedRAVE, prior_step_seed
from rave_tpu_torch.export.export import export_model
from rave_tpu_torch.export.native_host import ensure_host, read_state
from rave_tpu_torch.prior.core import DiagonalShift, QuantizedNormal
from rave_tpu_torch.prior.model import Prior
from rave_tpu_torch.train.state import create_train_state
from rave_tpu_torch.utils.checkpoint import save_checkpoint, save_prior_checkpoint
from rave_tpu_torch.utils.rng import normal_from_seed

TINY = ["capacity=2", "discriminator.capacity=2", "latent_size=8", "ratios=[4,4,2]",
        "dilations=[[1],[1],[1]]"]
FIDELITY = [0.3, 0.6, 0.8, 0.9, 0.96, 0.98, 0.99, 1.0]  # 0.95 -> 4 dims of 8
TINY_V3 = ["capacity=4", "latent_size=4", "ratios=[4,4,2]", "dilations=[[1,3],[1],[1]]"]
PRIOR = dict(latent_size=2, resolution=8, res_size=16, skp_size=8, kernel_size=3,
             cycle_size=4, n_layers=3)
MODEL_TOL = 1e-4  # the serving path's bound (tests/test_torch_stream_graph.py)
WAV_TOL = 1 / 32767 + 1e-7  # the wav's int16 rounding (truncation toward zero)
N_SIGNAL, N_BLOCKS, SEED = 8192, 6, 77
THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def host():
    return ensure_host()


def run_host(host, *args, ok=True):
    proc = subprocess.run([host, *map(str, args)], capture_output=True, text=True, timeout=300,
                          env={**os.environ, "OMP_NUM_THREADS": str(THREADS)})
    if ok:
        assert proc.returncode == 0, proc.stderr
    return proc


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def port_run(root, names, overrides, fidelity=None, seed=0):
    """A port run directory of a seeded generator; `fidelity` sets its
    explained-variance curve (and a random rotation), hence the latent size."""
    cfg = config.compose(names, overrides)
    cfg.data.n_signal = N_SIGNAL
    state = create_train_state(cfg, seed=seed, device="cpu")
    if fidelity is not None:
        D, r = cfg.latent_size, np.random.default_rng(seed)
        with torch.no_grad():
            state.model.fidelity.copy_(torch.tensor(fidelity))
            state.model.latent_pca.copy_(torch.from_numpy(
                np.linalg.qr(r.standard_normal((D, D)))[0].astype(np.float32)))
            state.model.latent_mean.copy_(torch.from_numpy(
                (r.standard_normal(D) * 0.1).astype(np.float32)))
    run = root / "run"
    run.mkdir()
    (run / "config.json").write_text(config.snapshot(cfg))
    save_checkpoint(str(run), state)
    return run


@pytest.fixture(scope="module")
def v2(tmp_path_factory):
    """The port's v2 streaming artifact (latent 4 of 8: decode pads with
    draws), mono, and the same run exported stereo (stream batch 2)."""
    root = tmp_path_factory.mktemp("host_v2")
    run = port_run(root, ["v2"], TINY, FIDELITY)
    return {"mono": export_model(run=str(run), output=str(root / "mono"), streaming=True,
                                 device="cpu"),
            "stereo": export_model(run=str(run), output=str(root / "stereo"), streaming=True,
                                   stereo=True, device="cpu")}


@pytest.fixture(scope="module")
def v3(tmp_path_factory):
    root = tmp_path_factory.mktemp("host_v3")
    run = port_run(root, ["v3"], TINY_V3, [0.2, 0.4, 0.6, 1.0], seed=3)
    return export_model(run=str(run), output=str(root / "art"), streaming=True, device="cpu")


@pytest.fixture(scope="module")
def prior_art(tmp_path_factory):
    """A v2 artifact with a seeded prior bundled."""
    root = tmp_path_factory.mktemp("host_prior")
    run = port_run(root, ["v2"], TINY, FIDELITY, seed=5)
    torch.manual_seed(6)
    prior = Prior(**PRIOR)
    prior_run = root / "prior"
    prior_run.mkdir()
    (prior_run / "prior_config.json").write_text(
        json.dumps(dict(vae_run=str(run), **PRIOR, fidelity=0.95)))
    save_prior_checkpoint(str(prior_run), 2, prior, torch.optim.Adam(prior.parameters()))
    return export_model(run=str(run), prior=str(prior_run), output=str(root / "art"),
                        device="cpu")


def signal(n, seed, scale=0.3):
    return (np.random.default_rng(seed).standard_normal(n) * scale).astype(np.float32)


def write_wav(path, x):
    wavfile.write(path, 44100, x)  # float32: read back exactly
    return path


def python_stream(art, method, blocks, seed_base):
    """`method` streamed block by block through the Python artifact from the
    zero state, block i with the host's seed of block i."""
    return [getattr(art, method)(b, streaming=True, seed=prior_step_seed(seed_base, i))
            for i, b in enumerate(blocks)]


def wav_blocks(x, block, n_blocks):
    xp = np.zeros(n_blocks * block, np.float32)
    xp[:len(x)] = x
    return [torch.from_numpy(xp[i * block:(i + 1) * block]).reshape(1, 1, block)
            for i in range(n_blocks)]


def states_equal(a, b):
    return len(a) == len(b) and all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))


@pytest.mark.parametrize("which", ["v2", "v3", "prior"])
def test_ts_programs_match_pt2(v2, v3, prior_art, which):
    """Each `.ts` against its `.pt2` on the same inputs and seeds over 3
    chained calls from the initial state in its `state_file`: outputs and
    state bit-equal; the manifest names both files for every step."""
    path = {"v2": v2["mono"], "v3": v3, "prior": prior_art}[which]
    art = ExportedRAVE(path, device="cpu")
    aot = art.manifest["aot"]
    methods = ["prior"] if which == "prior" else list(STEP_METHODS)
    assert set(aot) == {f"{m}_step" for m in STEP_METHODS} | ({"prior_step"} if
                                                             which == "prior" else set())
    rng = np.random.default_rng(4)
    for m in methods:
        entry = aot[f"{m}_step"]
        assert entry["ts_file"] == f"{m}_step.ts" and entry["state_file"] == f"{m}_step.state"
        state0 = art.prior_state() if m == "prior" else list(art.state)
        loaded = read_state(art.path / entry["state_file"], state0)
        assert states_equal(loaded, state0), m
        program, ts = art.load_program(m), torch.jit.load(str(art.path / entry["ts_file"]))
        spec = entry["inputs"][entry["n_state"]]
        s_pt2, s_ts = list(state0), list(state0)
        with torch.no_grad(), torch.jit.optimized_execution(False):
            for i in range(3):
                x = torch.from_numpy((rng.standard_normal(spec["shape"]) * 0.3).astype(np.float32))
                seed = torch.tensor(prior_step_seed(9, i))
                y_pt2, s_pt2 = program(s_pt2, x, seed)
                y_ts, s_ts = ts(s_ts, x, seed)
                assert torch.equal(y_ts, y_pt2) and states_equal(s_ts, s_pt2), (m, i)


def test_info_agrees_with_manifest(host, v2):
    out = run_host(host, v2["mono"], "info").stdout
    fields = {}
    for line in out.splitlines():
        key, _, value = line.partition(": ")
        fields.setdefault(key, []).append(value)
    man = json.loads(open(os.path.join(v2["mono"], "manifest.json")).read())
    for key in ("name", "sampling_rate", "block_size", "n_channels", "stream_batch",
                "latent_size", "latent_family"):
        assert fields[key] == [str(man[key])], key
    ratio = man["methods"]["encode"]["out_ratio"]
    assert fields["frames_per_block"] == [str(man["block_size"] // ratio)]
    assert fields["total_latency_samples"] == [str(man["latency"]["total_samples"])]
    assert fields["device"] == ["cpu"]
    assert sorted(fields["aot_method"]) == sorted(man["aot"])
    assert fields["torchscript"] == ["profiling_executor 0 profiling_mode 0 optimize 0"]
    assert fields["cudnn"] == ["enabled 1 deterministic 0 benchmark 0 allow_tf32 0"]
    assert fields["matmul"] == ["allow_tf32 0"]
    assert "attribute" not in fields  # v2 has no AdaIN


def test_stream_matches_python(host, v2, tmp_path):
    """encode bit-equal, then decode of those latents and forward within the
    wav's rounding, each with its saved state bit-equal to the Python
    artifact's after the same blocks."""
    path = v2["mono"]
    art = ExportedRAVE(path, device="cpu")
    B, L = art.block_size, art.latent_size
    x = signal(N_BLOCKS * B - 100, 1)  # ragged: the last block is zero-padded
    wav = write_wav(tmp_path / "in.wav", x)
    blocks = wav_blocks(x, B, N_BLOCKS)

    run_host(host, "--save-state", tmp_path / "enc.state", path, "encode", wav,
             tmp_path / "z.f32", SEED)
    z = np.fromfile(tmp_path / "z.f32", np.float32).reshape(-1, L)
    want = torch.cat(python_stream(art, "encode", blocks, SEED), -1)[0].T.numpy()
    np.testing.assert_array_equal(z, want)
    assert states_equal(read_state(tmp_path / "enc.state", art.state), art.state)

    art.reset_stream()
    run_host(host, "--save-state", tmp_path / "dec.state", path, "decode", tmp_path / "z.f32",
             tmp_path / "dec.wav", SEED + 1)
    frames = B // art.cfg.decimation()
    zb = [torch.from_numpy(z[i * frames:(i + 1) * frames].T.copy())[None] for i in range(N_BLOCKS)]
    y = torch.cat(python_stream(art, "decode", zb, SEED + 1), -1)[0, 0].clamp(-1, 1).numpy()
    sr, written = wavfile.read(tmp_path / "dec.wav")
    assert sr == 44100 and written.shape == y.shape
    assert np.abs(written / 32767 - y).max() <= WAV_TOL
    assert states_equal(read_state(tmp_path / "dec.state", art.state), art.state)

    art.reset_stream()
    run_host(host, "--save-state", tmp_path / "fwd.state", path, "forward", wav,
             tmp_path / "fwd.wav", SEED + 2)
    y = torch.cat(python_stream(art, "forward", blocks, SEED + 2), -1)[0, 0, :len(x)]
    _, written = wavfile.read(tmp_path / "fwd.wav")
    assert written.shape == (len(x),)
    assert np.abs(written / 32767 - y.clamp(-1, 1).numpy()).max() <= WAV_TOL
    assert states_equal(read_state(tmp_path / "fwd.state", art.state), art.state)


def test_adain_sequence_across_processes(host, v3, tmp_path):
    """learn_target over a target, then learn_source over a source, then the
    transfer, each a process of its own carrying the state in a file: the
    outputs and states equal one Python stream with the same setters."""
    art = ExportedRAVE(v3, device="cpu")
    assert set(art.manifest["attributes"]) == {"learn_target", "reset_target", "learn_source",
                                               "reset_source"}
    B = art.block_size
    target, source = signal(3 * B, 5, 0.5), signal(3 * B, 6, 0.1)
    wt, ws = write_wav(tmp_path / "target.wav", target), write_wav(tmp_path / "source.wav", source)
    plan = [(["--attr", "learn_target=1"], wt, 10, [("set_learn_target", True)]),
            (["--attr", "learn_target=0", "--attr", "learn_source"], ws, 20,
             [("set_learn_target", False), ("set_learn_source", True)]),
            (["--attr", "learn_source=0"], ws, 30, [("set_learn_source", False)])]
    for k, (flags, wav, seed, setters) in enumerate(plan):
        load = ["--load-state", tmp_path / f"s{k - 1}.state"] if k else []
        run_host(host, *flags, *load, "--save-state", tmp_path / f"s{k}.state", v3, "forward",
                 wav, tmp_path / f"out{k}.wav", seed)
        for name, on in setters:
            getattr(art, name)(on)
        x = target if wav == wt else source
        y = torch.cat(python_stream(art, "forward", wav_blocks(x, B, 3), seed), -1)[0, 0]
        _, written = wavfile.read(tmp_path / f"out{k}.wav")
        assert np.abs(written / 32767 - y.clamp(-1, 1).numpy()).max() <= WAV_TOL, k
        assert states_equal(read_state(tmp_path / f"s{k}.state", art.state), art.state), k
    learned = [float(s.flatten()[0]) for (name, _, _), s in zip(art.slots, art.state)
               if name.endswith("num_update_y")]
    assert learned and all(n > 0 for n in learned)


def test_prior_matches_sample_prior(host, prior_art, tmp_path):
    art = ExportedRAVE(prior_art, device="cpu")
    L, n = art.latent_size, 9
    run_host(host, prior_art, "prior", n, tmp_path / "z.f32", 123)
    z = np.fromfile(tmp_path / "z.f32", np.float32).reshape(n, L)
    want = art.sample_prior(n, seed=123)[0].T.numpy()
    np.testing.assert_array_equal(z, want)
    # without the dither: the same chain's bins at their lower edges
    run_host(host, "--no-dither", prior_art, "prior", n, tmp_path / "nd.f32", 123)
    nd = np.fromfile(tmp_path / "nd.f32", np.float32).reshape(n, L)
    D, R = PRIOR["latent_size"], PRIOR["resolution"]
    state, x, ys = art.prior_state(), torch.zeros(1, D * R, 1), []
    with torch.no_grad():
        for i in range(n + D - 1):
            x, state = art.prior_step(state, x, torch.tensor(prior_step_seed(123, i)))
            ys.append(x)
    q = DiagonalShift().inverse(QuantizedNormal(R).decode(torch.cat(ys, -1)))
    pad = normal_from_seed(123, (1, L - D, n), 6)
    np.testing.assert_array_equal(nd, torch.cat([q, pad], 1)[0].T.numpy())


def test_host_refuses(host, v2, v3, tmp_path):
    """A stream_batch 2 artifact, an unknown attribute, and a `cuda`
    artifact without a card: a non-zero exit naming the cause."""
    wav = write_wav(tmp_path / "in.wav", signal(1024, 7))
    proc = run_host(host, v2["stereo"], "forward", wav, tmp_path / "o.wav", ok=False)
    assert proc.returncode != 0 and "stream_batch" in proc.stderr
    proc = run_host(host, "--attr", "learn_style=1", v3, "forward", wav, tmp_path / "o.wav",
                    ok=False)
    assert proc.returncode != 0 and "no attribute 'learn_style'" in proc.stderr
    proc = run_host(host, "--attr", "learn_target", v2["mono"], "forward", wav,
                    tmp_path / "o.wav", ok=False)  # v2 has no attributes
    assert proc.returncode != 0 and "no attribute 'learn_target'" in proc.stderr
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda artifact would run")
    card = tmp_path / "card.rtpu"
    shutil.copytree(v2["mono"], card)
    man = json.loads((card / "manifest.json").read_text())
    for entry in man["aot"].values():
        entry["device"] = "cuda"
    (card / "manifest.json").write_text(json.dumps(man))
    for args in (["info"], ["forward", wav, tmp_path / "o.wav"]):
        proc = run_host(host, card, *args, ok=False)
        assert proc.returncode != 0 and "cuda" in proc.stderr and "no CUDA device" in proc.stderr
        assert not proc.stdout
