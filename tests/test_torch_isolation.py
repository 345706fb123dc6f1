"""rave_tpu_torch runs without jax: the machine with the GPU has none.

A fresh interpreter imports the port, builds the tiny v2 through its own
config and factory, runs a forward and the streaming pair, builds the
tiny critic and runs one generator step of each phase and one critic step
through the port's train state, then one generator and one critic step
with `train.bf16` and `train.bf16_dis`, then `preprocess -> train -> eval`
through the port's command line on a seeded corpus, with nothing kept
from being imported (where tensorboard and tensorflow are installed,
tensorflow imports jax: the metrics logger must not reach them), and then
reports whether jax, flax or any module of the JAX package was ever
imported.
Every module of the port is also read (`ast`): none imports yaml, orbax or
tensorboard at module level (the machine with the GPU has none of them),
nor jax, flax or the JAX package.
"""
import ast
import json
import math
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = """
import json, sys
import torch
import rave_tpu_torch
from rave_tpu_torch.config import compose
from rave_tpu_torch.factory import build_rave
from rave_tpu_torch.nn.streaming import init_stream_state
from rave_tpu_torch.train.analysis import crop_frames, receptive_field
from rave_tpu_torch.train.state import create_train_state
from rave_tpu_torch.train.steps import build_train_steps
cfg = compose(["v2", "causal"], ["capacity=2", "latent_size=4", "ratios=[4,4,2]",
                                 "dilations=[[1,3],[1,3],[1]]"])
model = build_rave(cfg, seed=0, device="cpu")
x = torch.randn(1, 1, 4 * cfg.block_size(), generator=torch.Generator().manual_seed(0))
with torch.inference_mode():
    y = model(x, generator=torch.Generator().manual_seed(1))
    init_stream_state(model, 1)
    z = model.step_encode(x[..., : cfg.block_size()])
    s = model.step_decode(z[:, : cfg.latent_size])
tiny = ["capacity=2", "discriminator.capacity=2", "latent_size=4", "ratios=[4,4,2]",
        "dilations=[[1],[1],[1]]", "distance.scales=[512,256]", "train.phase_1_duration=1"]
tcfg = compose(["v2"], tiny)
state = create_train_state(tcfg, seed=0, device="cpu")
steps = build_train_steps(tcfg, crop_frames(tcfg, (48, 32)))
xt = torch.randn(2, 1, 8192, generator=torch.Generator().manual_seed(2)) * 0.1
noise = torch.Generator().manual_seed(3)
losses = [float(steps["gen"](state, xt, False, generator=noise)["loss_gen"]),
          float(steps["gen"](state, xt, True, generator=noise)["loss_gen"]),
          float(steps["dis"](state, xt, generator=noise)["loss_dis"])]
bcfg = compose(["v2"], tiny + ["train.bf16=true", "train.bf16_dis=true"])
bsteps = build_train_steps(bcfg, crop_frames(bcfg, (48, 32)))
losses += [float(bsteps["gen"](state, xt, True, generator=noise)["loss_gen"]),
           float(bsteps["dis"](state, xt, generator=noise)["loss_dis"])]
import contextlib, io, pathlib, tempfile
import numpy as np
from scipy.io import wavfile
from rave_tpu_torch import cli
root = pathlib.Path(tempfile.mkdtemp())
(root / "corpus").mkdir()
wav = 0.3 * np.sin(2 * np.pi * 220 * np.arange(52 * 8192) / 44100)
wavfile.write(root / "corpus" / "a.wav", 44100, (wav * 32767).astype(np.int16))
codes = [cli.main(["preprocess", "--input_path", str(root / "corpus"), "--output_path",
                   str(root / "db"), "--num_signal", "8192", "--workers", "2"])]
args = ["train", "--device", "cpu", "--name", "iso", "--db_path", str(root / "db"),
        "--out_path", str(root / "runs"), "--batch", "4", "--n_signal", "8192",
        "--max_steps", "2", "--val_every", "2", "--workers", "2", "--no_progress"]
for o in tiny + ["train.valid_signal_crop=false"]:
    args += ["--override", o]
codes.append(cli.main(args))
out = io.StringIO()
with contextlib.redirect_stdout(out):
    codes.append(cli.main(["eval", "--device", "cpu", "--db_path", str(root / "db"),
                           "--run", str(next((root / "runs").iterdir()))]))
evaluation = json.loads(out.getvalue().strip().splitlines()[-1])
print(json.dumps({
    "codes": codes, "eval_step": evaluation["step"],
    "eval_finite": all(np.isfinite(evaluation[k]) for k in ("spectral_distance", "waveform_l1",
                                                            "frechet_mel_distance")),
    "shape": list(y.shape), "finite": bool(torch.isfinite(y).all()),
    "stream_shape": list(s.shape), "train_step": state.step, "losses": losses,
    "rf": list(receptive_field(tcfg, device="cpu")),
    "loaded": sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "rave_tpu")),
}))
"""


def test_port_never_imports_jax():
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH", "")) if p)}
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == [], out["loaded"]
    assert out["shape"] == [1, 1, 2048] and out["finite"]
    assert out["stream_shape"] == [1, 1, 512]
    assert out["train_step"] == 5 and all(math.isfinite(v) for v in out["losses"])
    assert out["rf"][0] > 0
    assert out["codes"] == [0, 0, 0] and out["eval_step"] == 2 and out["eval_finite"]


FOREIGN = {"yaml", "orbax", "tensorboard", "jax", "jaxlib", "flax", "rave_tpu"}


def module_level_imports(tree):
    """Top-level names a module imports outside any function or class."""
    names = []

    def visit(nodes):
        for node in nodes:
            if isinstance(node, ast.Import):
                names.extend(a.name.split(".")[0] for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names.append(node.module.split(".")[0])
            elif isinstance(node, (ast.If, ast.Try, ast.With)):
                for field in ("body", "orelse", "finalbody", "handlers"):
                    visit(getattr(node, field, []))
            elif isinstance(node, ast.ExceptHandler):
                visit(node.body)

    visit(tree.body)
    return names


def test_no_foreign_module_level_imports():
    sources = sorted((ROOT / "rave_tpu_torch").rglob("*.py"))
    assert len(sources) > 30
    for path in sources:
        imported = set(module_level_imports(ast.parse(path.read_text())))
        assert not imported & FOREIGN, (path, imported & FOREIGN)
    # anywhere in a module, not only at its top: never yaml, orbax, jax or the JAX package
    for path in sources:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                roots = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = {node.module.split(".")[0]}
            else:
                continue
            assert not roots & (FOREIGN - {"tensorboard"}), (path, roots)
