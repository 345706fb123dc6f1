"""The port's command line, `python -m rave_tpu_torch.cli`, on the CPU.

preprocess -> train -> resume -> eval through `main(argv)` with
`--device cpu`, at the tiny config, with the receptive-field crop on
(n_signal 16384 leaves frames after it); then a two-step `--bf16`
`--smoke_test` run and a run with a profiler window; a run's `export`
and `generate`, offline and streaming, against the artifact's own forward.
Every `--config` takes a reference `.gin` file stacked with presets and
overrides: `train` on one (and with the spectral critic), as the JAX
package composes it. `remote_dataset` serves the store to the port's HTTP
client.
"""
import io
import json
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from rave_tpu_torch import cli, config

SR, N_SIGNAL = 22050, 16384
TINY = ["sampling_rate=22050", "capacity=2", "discriminator.capacity=2", "latent_size=4",
        "ratios=[4,4,2]", "dilations=[[1],[1],[1]]", "distance.scales=[512,256]",
        "train.phase_1_duration=2", "train.update_discriminator_every=2"]


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Two torch threads for this module: beside the suite's other parallel
    workers, torch's default of one thread per core oversubscribes the host
    and slows these tests several-fold (alone, two threads are as fast)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(args):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        code = cli.main([str(a) for a in args])
    return code, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli")
    (root / "corpus").mkdir()
    rng = np.random.default_rng(0)
    t = np.arange(52 * N_SIGNAL) / SR  # 52 records: 51 train, 1 val
    x = 0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(t.size)
    wavfile.write(root / "corpus" / "a.wav", SR, (x * 32767).astype(np.int16))
    code, out, _ = run(["preprocess", "--input_path", root / "corpus", "--output_path",
                        root / "db", "--num_signal", N_SIGNAL, "--sampling_rate", SR,
                        "--workers", 2])
    assert code == 0 and "'n_examples': 52" in out
    return root


def train_args(root, *extra):
    args = ["train", "--device", "cpu", "--name", "cli", "--db_path", root / "db",
            "--out_path", root / "runs", "--batch", 4, "--n_signal", N_SIGNAL, "--workers", 2,
            "--val_every", 2, "--save_every", 100, "--no_progress", *extra]
    for o in TINY:
        args += ["--override", o]
    return args


def test_preprocess_train_resume_eval(db):
    code, out, _ = run(train_args(db, "--max_steps", 3, "--device_data", "off"))
    assert code == 0
    run_dir = Path(out.strip().splitlines()[-1].removeprefix("run dir: "))
    cfg = config.from_dict(json.loads((run_dir / "config.json").read_text()))
    assert (cfg.sampling_rate, cfg.data.n_signal) == (SR, N_SIGNAL)
    assert cfg.train.valid_signal_crop
    ckpts = sorted(p.name for p in (run_dir / "checkpoints").iterdir())
    assert ckpts == ["step_0000000002.pt", "step_0000000003.pt"]
    rows = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows if "validation" in r] == [2, 3]
    assert all(np.isfinite(v) for r in rows for v in r.values())

    code, out, _ = run(train_args(db, "--max_steps", 4))  # resumes, device pipeline on the CPU
    assert code == 0 and Path(out.strip().splitlines()[-1].removeprefix("run dir: ")) == run_dir
    assert (run_dir / "checkpoints" / "step_0000000004.pt").is_file()

    evals = []
    for _ in range(2):
        code, out, _ = run(["eval", "--device", "cpu", "--run", run_dir, "--db_path", db / "db"])
        assert code == 0
        evals.append(json.loads(out.strip().splitlines()[-1]))
    assert evals[0] == evals[1]
    ev = evals[0]
    assert (ev["step"], ev["split"], ev["n_clips"]) == (4, "val", 1)
    for k in ("spectral_distance", "waveform_l1", "frechet_mel_distance"):
        assert np.isfinite(ev[k]), k
    code, out, _ = run(["eval", "--device", "cpu", "--run", run_dir, "--db_path", db / "db",
                        "--step", 2, "--split", "train", "--max_batches", 1, "--batch", 2])
    ev2 = json.loads(out.strip().splitlines()[-1])
    assert code == 0 and (ev2["step"], ev2["n_clips"]) == (2, 2)


def test_bf16_smoke_test(db):
    code, out, _ = run(train_args(db, "--bf16", "--smoke_test", "--name", "bf16"))
    assert code == 0
    run_dir = Path(out.strip().splitlines()[-1].removeprefix("run dir: "))
    cfg = config.from_dict(json.loads((run_dir / "config.json").read_text()))
    assert cfg.train.bf16 and cfg.train.bf16_dis
    rows = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows if "validation" in r] == [1, 2]
    assert [r["step"] for r in rows if "loss_gen" in r] == [1, 2]


def test_trace_steps_writes_a_profile(db):
    """`--trace_steps 1`: a torch.profiler window over the step after the
    first three, written to <run>/trace."""
    code, out, _ = run(train_args(db, "--name", "trace", "--max_steps", 5, "--trace_steps", 1,
                                  "--no_resume", "--override", "train.valid_signal_crop=false"))
    run_dir = Path(out.strip().splitlines()[-1].removeprefix("run dir: "))
    trace = json.loads((run_dir / "trace" / "trace.json").read_text())
    assert code == 0 and trace["traceEvents"]


def test_export_generate(db, tmp_path):
    """train -> export -> generate, offline and `--streaming`: each written
    wav is the artifact's forward of the file (same seed chain), clipped and
    truncated to int16, within one step of 1/32767."""
    code, out, _ = run(train_args(db, "--name", "export", "--max_steps", 2, "--no_resume",
                                  "--override", "train.valid_signal_crop=false"))
    assert code == 0
    run_dir = out.strip().splitlines()[-1].removeprefix("run dir: ")
    code, out, _ = run(["export", "--device", "cpu", "--run", run_dir, "--streaming",
                        "--output", tmp_path])
    assert code == 0
    art_dir = Path(out.strip().splitlines()[-1].removeprefix("exported: "))
    assert art_dir == tmp_path / "v2_streaming.rtpu"
    assert {p.name for p in art_dir.iterdir()} == {"manifest.json", "weights.pt"} | {
        f"{m}_step.{ext}" for m in ("encode", "decode", "forward") for ext in ("pt2", "ts", "state")}

    from rave_tpu_torch.export.artifact import ExportedRAVE

    block = json.loads((art_dir / "manifest.json").read_text())["block_size"]
    n = 3 * block + 100  # ragged against the block
    t = np.arange(n) / SR
    wav = tmp_path / "in.wav"
    wavfile.write(wav, SR, (0.4 * np.sin(2 * np.pi * 330 * t) * 32767).astype(np.int16))
    x = torch.from_numpy(wavfile.read(wav)[1].astype(np.float32) / 32768)
    x = torch.nn.functional.pad(x, (0, (-n) % block))[None, None]
    for mode in ([], ["--streaming"]):
        out_dir = tmp_path / f"gen{len(mode)}"
        code, out, _ = run(["generate", "--device", "cpu", "--model", art_dir, "--input", wav,
                            "--out_path", out_dir, "--seed", 3, *mode])
        assert code == 0
        sr, y = wavfile.read(out_dir / "in_reconstructed.wav")
        assert sr == SR and y.shape == (n,) and y.dtype == np.int16
        art = ExportedRAVE(str(art_dir), device="cpu", seed=3)
        if mode:
            want = torch.cat([art.forward(x[..., i:i + block], streaming=True)
                              for i in range(0, x.shape[-1], block)], -1)
        else:
            want = art.forward(x)
        want = want[0, 0, :n].clamp(-1, 1).numpy()
        assert np.abs(y / 32767 - want).max() <= 1 / 32767 + 1e-7
        assert np.abs(want).max() > 0


def test_remote_dataset_serves_the_store(db):
    """`cli remote_dataset` in its own process serves the store: the port's
    client reads every record as the store holds it, then the server is
    stopped."""
    import socket
    import subprocess
    import sys

    from rave_tpu_torch.data.dataset import HTTPAudioDataset
    from rave_tpu_torch.data.store import ArsReader

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    server = subprocess.Popen(
        [sys.executable, "-m", "rave_tpu_torch.cli", "remote_dataset", "--db_path",
         str(db / "db"), "--port", str(port)],
        cwd=Path(__file__).resolve().parents[1], stdout=subprocess.PIPE, text=True)
    try:
        assert "(52 examples)" in server.stdout.readline()
        remote = HTTPAudioDataset(f"http://127.0.0.1:{port}")
        reader = ArsReader(str(db / "db"))
        assert len(remote) == len(reader) == 52
        for i in (0, 17, 51):
            np.testing.assert_array_equal(remote.get(i, None),
                                          reader[i].astype(np.float32) / 32767.0)
    finally:
        server.kill()
        server.wait()


RUN_GIN = """include "configs/v2.gin"
SAMPLING_RATE = 22050
CAPACITY = 2
LATENT_SIZE = 4
RATIOS = [4, 4, 2]
DILATIONS = [[1], [1], [1]]
MultiScaleSTFT.scales = [512, 256]
"""
GIN_STACKS = {"train": [], "train-spectral": ["spectral_discriminator"]}


@pytest.mark.parametrize("stack", list(GIN_STACKS))
def test_train_takes_a_gin_config(db, tmp_path, stack):
    """`train --config run.gin [--config spectral_discriminator]` with the
    schedule's overrides: the run's config is the JAX package's compose of
    the same stack (model, critic and distance fields), its name the gin
    file's, and two steps train (the second adversarial, through the critic)."""
    from rave_tpu.config import compose as jax_compose

    gin = tmp_path / "run.gin"
    gin.write_text(RUN_GIN)
    names = [str(gin)] + GIN_STACKS[stack]
    overrides = ["discriminator.encodec_capacity=2", "discriminator.spectral_scales=[512,256]",
                 "train.phase_1_duration=1", "train.update_discriminator_every=2",
                 "train.valid_signal_crop=false"]
    args = ["train", "--device", "cpu", "--name", "gin", "--db_path", db / "db", "--out_path",
            tmp_path / "runs", "--batch", 2, "--n_signal", N_SIGNAL, "--workers", 2,
            "--max_steps", 2, "--val_every", 100, "--no_progress", "--device_data", "off"]
    for name in names:
        args += ["--config", name]
    for o in overrides:
        args += ["--override", o]
    code, out, err = run(args)
    assert code == 0, err
    run_dir = Path(out.strip().splitlines()[-1].removeprefix("run dir: "))
    cfg = config.from_dict(json.loads((run_dir / "config.json").read_text()))
    want = jax_compose(names, overrides)
    for section in ("encoder", "decoder", "latent", "discriminator", "distance"):
        assert vars(getattr(cfg, section)) == vars(getattr(want, section)), section
    assert (cfg.name, cfg.sampling_rate, cfg.capacity, cfg.ratios) == (
        want.name, want.sampling_rate, want.capacity, want.ratios) == ("run", SR, 2, (4, 4, 2))
    assert cfg.discriminator.kind == ("spectral" if GIN_STACKS[stack] else "combined")
    rows = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows if "loss_dis" in r] == [1, 2]


def test_usage_and_unknown_command():
    assert run([])[0] == 0
    code, _, err = run(["frobnicate"])
    assert code != 0 and "unknown command" in err
