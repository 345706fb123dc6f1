"""The port's command line, `python -m rave_tpu_torch.cli`, on the CPU.

preprocess -> train -> resume -> eval through `main(argv)` with
`--device cpu`, at the tiny config, with the receptive-field crop on
(n_signal 16384 leaves frames after it); then a two-step `--bf16`
`--smoke_test` run and a run with a profiler window. The commands not
ported exit non-zero and name their ROADMAP item.
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


@pytest.mark.parametrize("command", sorted(cli.NOT_PORTED))
def test_unported_commands_name_their_item(command):
    code, _, err = run([command, "--run", "x"])
    assert code != 0
    assert f"ROADMAP {cli.NOT_PORTED[command]}" in err and "A1" in err


def test_usage_and_unknown_command():
    assert run([])[0] == 0
    code, _, err = run(["frobnicate"])
    assert code != 0 and "unknown command" in err
