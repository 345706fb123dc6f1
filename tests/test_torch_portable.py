"""The portable full graph (rave_tpu_torch/export/portable.py) and the
registered op its traces record (ops/kernels/unit_op.py), on the CPU.

The op's CPU implementation is held to `fused_dilated_unit_reference`;
`cli export_onnx --device cpu` writes each family's portable program at a
tiny width, and one process that imports torch alone
(tools/torch_portable_run.py) loads the op library and every program and
runs it against the live forward on the same input and seed (the same
ATen kernels: 1e-6), and the `.pt2` against the `.ts`. The JAX half is
tests/test_torch_portable_jax.py; the CUDA path (the op launching the
Hopper kernel, its profile) is checked on the card by chip_smoke.py's
phase `portable`.
"""
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from rave_tpu_torch import cli, config
from rave_tpu_torch.export.portable import (
    FORMAT, PortableForward, export_portable, load_portable, unit_nodes,
)
from rave_tpu_torch.models.blocks import FusedDilatedResidual
from rave_tpu_torch.nn.conv import get_padding
from rave_tpu_torch.ops.kernels import dilated_unit, unit_op
from rave_tpu_torch.train.state import create_train_state
from rave_tpu_torch.utils.checkpoint import load_run, save_checkpoint

ROOT = Path(__file__).resolve().parents[1]
CONSUMER = ROOT / "tools" / "torch_portable_run.py"
OP_TOL, PROGRAM_TOL = 1e-6, 1e-6
N_SIGNAL, BATCH, SEED = 8192, 2, 1234
TINY = ["capacity=4", "latent_size=4", "n_band=4", "ratios=[4,2]"]
V2_TINY = TINY + ["dilations=[[1,3],[1]]", "discriminator.capacity=2"]
# family -> (compose names, overrides, n_channels)
FAMILIES = {
    "v1": (["v1"], TINY, 1),
    "v2": (["v2"], V2_TINY, 1),
    "v3": (["v3"], ["capacity=4", "latent_size=4", "ratios=[4,4,2]",
                    "dilations=[[1],[1],[1]]"], 1),
    "discrete": (["discrete"], ["capacity=2", "latent_size=4", "latent.num_quantizers=2",
                                "latent.codebook_size=16", "latent.noise_augmentation=2"], 1),
    "wasserstein": (["v2", "wasserstein"], V2_TINY, 1),
    "spherical": (["v2", "spherical"], V2_TINY, 1),
    "v2_small": (["v2_small"], ["capacity=2", "latent_size=4", "ratios=[4,2]",
                                "dilations=[[1],[1]]", "decoder.noise_hidden=4"], 1),
    "hybrid": (["hybrid"], ["capacity=2", "latent_size=4", "n_mels=16", "mel_n_fft=512",
                            "mel_hop=128", "encoder.ratios=[4]", "ratios=[4,4,2]",
                            "dilations=[[1],[1],[1]]"], 1),
    "stereo": (["v2"], V2_TINY + ["data.n_channels=2"], 2),
}
MANIFEST_KEYS = {"format", "input", "inputs", "outputs", "kept_inputs", "sampling_rate",
                 "config", "device", "device_name", "op_library", "kernel_library", "units",
                 "layout", "programs", "seed", "torch"}


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def op_library():
    return unit_op.load_unit_op()


def _cli(args):
    out = io.StringIO()
    with redirect_stdout(out):
        code = cli.main([str(a) for a in args])
    return code, out.getvalue()


def make_run(root: Path, family: str) -> Path:
    names, overrides, channels = FAMILIES[family]
    cfg = config.compose(names, overrides)
    run = root / f"{family}_run"
    run.mkdir()
    (run / "config.json").write_text(config.snapshot(cfg))
    save_checkpoint(str(run), create_train_state(cfg, n_channels=channels, seed=3,
                                                 device="cpu"))
    return run


def units_of(model) -> int:
    return sum(isinstance(m, FusedDilatedResidual) and m.inner.activation == "leaky_relu"
               for m in model.modules())


@pytest.fixture(scope="module")
def programs(tmp_path_factory, op_library):
    """Every family's run exported by `cli export_onnx --device cpu` at
    BATCH x N_SIGNAL, with the live forward's output on a seeded input and
    seed saved beside each program as check.pt; then all of them run by the
    consumer in one process that imports torch alone."""
    root = tmp_path_factory.mktemp("portable")
    out = {}
    for family in FAMILIES:
        run = make_run(root, family)
        code, text = _cli(["export_onnx", "--run", run, "--output", root / family, "--device",
                           "cpu", "--batch", BATCH, "--n_signal", N_SIGNAL])
        assert code == 0, text
        path = Path(text.strip().splitlines()[-1].removeprefix("exported: "))
        cfg, model, channels, _ = load_run(str(run), device="cpu")
        x = 0.3 * torch.randn(BATCH, channels, N_SIGNAL,
                              generator=torch.Generator().manual_seed(SEED))
        seed = torch.tensor(SEED, dtype=torch.int64)
        with torch.no_grad():
            y = PortableForward(model, cfg)(x, seed)
        torch.save({"x": x, "seed": seed, "y": y}, path / "check.pt")
        out[family] = {"run": run, "path": path, "text": text, "units": units_of(model),
                       "y": y, "manifest": json.loads((path / "manifest.json").read_text())}
    proc = subprocess.run(
        [sys.executable, CONSUMER, *(str(p["path"]) for p in out.values()), "--iters", "1",
         "--out", str(root / "consumer.json")],
        capture_output=True, text=True, timeout=600, cwd=root,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    consumer = json.loads((root / "consumer.json").read_text())
    for p, r in zip(out.values(), consumer["programs"]):
        p["consumer"] = r
    return {"families": out, "foreign": consumer["foreign_modules"], "root": root}


@pytest.mark.parametrize("mode", ["centered", "causal"])
@pytest.mark.parametrize("d", [1, 3, 9])
@pytest.mark.parametrize("C", [8, 16])
def test_op_cpu_matches_reference(op_library, C, d, mode):
    """The op's CPU implementation is the plain version, at a ragged length."""
    rng = np.random.default_rng(C * 10 + d)
    x = torch.from_numpy(rng.standard_normal((2, C, 53)).astype(np.float32))
    w1 = torch.from_numpy((rng.standard_normal((C, C, 3)) / np.sqrt(3 * C)).astype(np.float32))
    w2 = torch.from_numpy((rng.standard_normal((C, C)) / np.sqrt(C)).astype(np.float32))
    left, right = get_padding(3, 1, d, mode)
    want = dilated_unit.fused_dilated_unit_reference(x, w1, w2, d, left, right)
    got = unit_op.unit_op(x, w1, w2, d, left, right)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= OP_TOL * float(want.abs().max())
    assert unit_op.launches() == 0  # the CPU launches no kernel
    assert unit_op.op_plan(x, w1, d, left) == []


def test_op_traces_as_one_node(op_library):
    """Under `torch.jit.trace` and `torch.export` a leaky unit is one op node;
    eagerly it goes through `fused_dilated_unit` as before."""
    torch.manual_seed(0)
    from rave_tpu_torch.models.blocks import residual_unit

    unit = residual_unit(8, 3, 3, "centered", True, "leaky_relu", 1)
    x = torch.randn(2, 8, 40)
    with torch.no_grad():
        traced = torch.jit.trace(unit, (x,))
        program = torch.export.export(unit, (x,), strict=False)
        eager = unit(x)
    assert unit_nodes(traced) == 1
    assert sum(str(n.target) == "rave_tpu_torch.dilated_unit.default"
               for n in program.graph.nodes) == 1
    assert torch.equal(traced(x), eager)
    assert torch.equal(program.module()(x), eager)
    assert not dilated_unit.traced()


@pytest.mark.parametrize("family", list(FAMILIES))
def test_export_runs_without_the_port(programs, family):
    """`cli export_onnx` writes `<name>_portable/` for every family, stereo
    included; loaded in a process that imports torch alone, the `.ts` gives
    the live forward's output on the same input and seed, and the `.pt2`
    the `.ts`'s."""
    p = programs["families"][family]
    r, m = p["consumer"], p["manifest"]
    assert not programs["foreign"]
    assert MANIFEST_KEYS <= set(m) and m["format"] == FORMAT
    names, _, channels = FAMILIES[family]
    assert m["input"] == [BATCH, channels, N_SIGNAL]
    assert m["inputs"] == [{"shape": [BATCH, channels, N_SIGNAL], "dtype": "float32"},
                           {"shape": [], "dtype": "int64"}]
    assert m["outputs"][0]["shape"] == [BATCH, channels, N_SIGNAL]
    assert m["device"] == "cpu" and m["units"] == p["units"]
    assert (m["op_library"] is not None) == (p["units"] > 0)
    for name in ("forward.ts", "forward.pt2", "manifest.json"):
        assert (p["path"] / name).is_file()
    if m["op_library"]:
        assert (p["path"] / m["op_library"]).is_file()
    assert r["finite"] and r["shape"] == list(p["y"].shape)
    assert r["max_abs_err_live"] <= PROGRAM_TOL * max(1.0, float(p["y"].abs().max()))
    assert r["max_abs_err_pt2"] <= PROGRAM_TOL * max(1.0, float(p["y"].abs().max()))
    assert r["launches_first_call"] == 0 and r["launches_timed"] == 0  # the CPU: no kernel


def test_unit_nodes_per_unit(programs):
    """v2's `.ts` holds one `rave_tpu_torch::dilated_unit` node per unit,
    v3's (Snake) none; the manifests say so."""
    fams = programs["families"]
    v2, v3 = (torch.jit.load(str(fams[k]["path"] / "forward.ts")) for k in ("v2", "v3"))
    assert unit_nodes(v2) == fams["v2"]["units"] == fams["v2"]["manifest"]["units"] > 0
    assert unit_nodes(v3) == fams["v3"]["units"] == 0
    assert fams["v3"]["manifest"]["op_library"] is None


def test_kept_inputs(programs):
    """A program reads its seed where the family draws (the variational
    noise, the augmentation channels, the noise synth) and not where it
    draws nothing (spherical), as `module_kept_var_idx` says of rave_tpu's."""
    fams = programs["families"]
    for family in ("v1", "v2", "v3", "discrete", "wasserstein", "v2_small", "hybrid",
                   "stereo"):
        assert fams[family]["manifest"]["kept_inputs"] == [0, 1], family
    assert fams["spherical"]["manifest"]["kept_inputs"] == [0]


def test_seed_moves_the_draws(programs, op_library):
    """The same input under another seed draws other noise (v2's
    variational latent): the seed is the program's only source of draws."""
    path = programs["families"]["v2"]["path"]
    ts, _ = load_portable(str(path), "cpu")
    saved = torch.load(path / "check.pt")
    with torch.no_grad():
        a = ts(saved["x"], saved["seed"])
        b = ts(saved["x"], saved["seed"] + 1)
    assert torch.equal(a, saved["y"]) or float((a - saved["y"]).abs().max()) <= PROGRAM_TOL
    assert float((a - b).abs().max()) > 1e-6


def test_skip_stablehlo_writes_no_program(tmp_path, op_library):
    """`--skip_stablehlo` writes the `.onnx` alone; without it a run that has
    no `.onnx` (v1's noise synth) still gets its portable program."""
    v2 = make_run(tmp_path, "v2")
    code, text = _cli(["export_onnx", "--run", v2, "--output", tmp_path / "skip",
                       "--skip_stablehlo", "--device", "cpu"])
    assert code == 0, text
    assert (tmp_path / "skip" / "v2.onnx").is_file()
    assert not (tmp_path / "skip" / "v2_portable").exists()
    v1 = make_run(tmp_path, "v1")
    code, text = _cli(["export_onnx", "--run", v1, "--output", tmp_path / "v1", "--device",
                       "cpu", "--n_signal", 4096])
    assert code == 0, text
    assert "no .onnx for this configuration" in text
    assert not list((tmp_path / "v1").glob("*.onnx"))
    manifest = json.loads((tmp_path / "v1" / "v1_portable" / "manifest.json").read_text())
    assert manifest["input"] == [1, 1, 4096]


def test_other_device_refused(programs, tmp_path, op_library):
    """A program runs only on the device it was exported on: `load_portable`
    and the consumer refuse another, naming it."""
    src = programs["families"]["v3"]["path"]
    path = tmp_path / "card"
    path.mkdir()
    for f in src.iterdir():
        (path / f.name).write_bytes(f.read_bytes())
    m = json.loads((path / "manifest.json").read_text())
    m.update(device="cuda:0", device_name="NVIDIA H100 80GB HBM3")
    (path / "manifest.json").write_text(json.dumps(m))
    with pytest.raises(RuntimeError, match="exported on cuda:0"):
        load_portable(str(path), "cpu")
    if not torch.cuda.is_available():
        proc = subprocess.run([sys.executable, CONSUMER, str(path)], capture_output=True,
                              text=True, timeout=300)
        assert proc.returncode != 0 and "runs only there" in proc.stderr


def test_export_portable_api(tmp_path, op_library):
    """`export_portable` itself: the directory, and a second export into it
    replacing the first."""
    run = make_run(tmp_path, "spherical")
    path = Path(export_portable(str(run), n_signal=4096, batch=1, output=str(tmp_path / "o"),
                                device="cpu"))
    assert path == tmp_path / "o" / "spherical_portable"
    again = Path(export_portable(str(run), n_signal=2048, batch=3, output=str(tmp_path / "o"),
                                 device="cpu"))
    assert again == path
    assert json.loads((path / "manifest.json").read_text())["input"] == [3, 1, 2048]
