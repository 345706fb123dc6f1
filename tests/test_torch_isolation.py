"""rave_tpu_torch runs without jax: the machine with the GPU has none.

A fresh interpreter imports the port, builds the tiny v2 through its own
config and factory, runs a forward and the streaming pair, builds the
tiny critic and runs one generator step of each phase and one critic step
through the port's train state, then one generator and one critic step
with `train.bf16` and `train.bf16_dis`, then `preprocess -> train -> eval ->
export -> generate` (offline and streaming) through the port's command
line on a seeded corpus, `train --config discrete -> export
--streaming -> generate --streaming`, and `train --config v3 -> export
--streaming -> generate` with a streaming call that learns AdaIN's target
statistics, `train --config v2_small -> export --streaming -> generate
--streaming` (the noise synth), and a `hybrid` forward (mel input, the
GRU) with its streaming pair, with nothing kept
from being imported (where tensorboard and tensorflow are installed,
tensorflow imports jax: the metrics logger must not reach them), and then
reports whether jax, flax or any module of the JAX package was ever
imported. A second interpreter does the same for the latent prior:
`preprocess`, a tiny v2 run saved by the port's checkpoint module,
`train_prior --smoke_test`, `export --prior` and `generate
--prior_seconds`; a third for the v1 family (`train --config v1`, `export
--streaming`, `generate --streaming`) and `export_onnx --verify` of an
`onnx` run; a fourth for the reference user's way in: `compose` of a
`.gin` file (the gin reader), a reference-named `.ckpt` written by
tools/torch_reference_ckpt.py from a port model's weights, `import_torch
--config <gin>`, `export` and `generate` of the imported run, and one
critic step of v2 with the spectral critic and one generator step with the
`encodec` and the `instantaneous` distances.
Every module of the port, and tools/torch_reference_ckpt.py, is also read
(`ast`): none imports yaml, orbax or tensorboard at module level (the
machine with the GPU has none of them), nor jax, flax or the JAX package.
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
torch.set_num_threads(2)  # beside the suite's other workers, as the in-process tests run
import rave_tpu_torch
from rave_tpu_torch.config import compose
from rave_tpu_torch.factory import build_rave
from rave_tpu_torch.nn.streaming import init_stream_state
from rave_tpu_torch.train.analysis import crop_frames, receptive_field
from rave_tpu_torch.train.state import create_train_state
from rave_tpu_torch.train.steps import build_train_steps, draw_noise
cfg = compose(["v2", "causal"], ["capacity=2", "latent_size=4", "ratios=[4,4,2]",
                                 "dilations=[[1,3],[1,3],[1]]"])
model = build_rave(cfg, seed=0, device="cpu")
x = torch.randn(1, 1, 4 * cfg.block_size(), generator=torch.Generator().manual_seed(0))
with torch.inference_mode():
    y = model(x, draw_noise(cfg, x, torch.Generator().manual_seed(1)))
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
with contextlib.redirect_stdout(io.StringIO()):
    codes.append(cli.main(["export", "--device", "cpu", "--output", str(root / "art"),
                           "--run", str(next((root / "runs").iterdir()))]))
    for mode in ([], ["--streaming"]):
        codes.append(cli.main(["generate", "--device", "cpu", "--model",
                               str(root / "art" / "v2.rtpu"), "--input",
                               str(root / "corpus" / "a.wav"), "--out_path",
                               str(root / f"gen{len(mode)}"), *mode]))
dargs = ["train", "--device", "cpu", "--config", "discrete", "--name", "iso_discrete",
         "--db_path", str(root / "db"), "--out_path", str(root / "druns"), "--batch", "2",
         "--n_signal", "8192", "--max_steps", "3", "--val_every", "3", "--workers", "2",
         "--no_progress"]
for o in tiny + ["latent.num_quantizers=2", "latent.codebook_size=16",
                 "latent.noise_augmentation=2"]:
    dargs += ["--override", o]
codes.append(cli.main(dargs))
drun = next((root / "druns").iterdir())
with contextlib.redirect_stdout(io.StringIO()):
    codes.append(cli.main(["export", "--device", "cpu", "--output", str(root / "dart"),
                           "--streaming", "--run", str(drun)]))
    codes.append(cli.main(["generate", "--device", "cpu", "--model",
                           str(root / "dart" / "discrete_streaming.rtpu"), "--input",
                           str(root / "corpus" / "a.wav"), "--out_path", str(root / "dgen"),
                           "--streaming"]))
vargs = ["train", "--device", "cpu", "--config", "v3", "--name", "iso_v3", "--db_path",
         str(root / "db"), "--out_path", str(root / "vruns"), "--batch", "2", "--n_signal",
         "8192", "--max_steps", "3", "--val_every", "3", "--workers", "2", "--no_progress"]
for o in tiny + ["train.update_discriminator_every=2", "train.valid_signal_crop=false",
                 "discriminator.descript_periods=[2]", "discriminator.descript_fft_sizes=[256]"]:
    vargs += ["--override", o]
codes.append(cli.main(vargs))
with contextlib.redirect_stdout(io.StringIO()):
    codes.append(cli.main(["export", "--device", "cpu", "--output", str(root / "vart"),
                           "--streaming", "--run", str(next((root / "vruns").iterdir()))]))
    codes.append(cli.main(["generate", "--device", "cpu", "--model",
                           str(root / "vart" / "v3_streaming.rtpu"), "--input",
                           str(root / "corpus" / "a.wav"), "--out_path", str(root / "vgen")]))
sargs = ["train", "--device", "cpu", "--config", "v2_small", "--name", "iso_small", "--db_path",
         str(root / "db"), "--out_path", str(root / "sruns"), "--batch", "2", "--n_signal",
         "8192", "--max_steps", "2", "--val_every", "2", "--workers", "2", "--no_progress"]
for o in tiny + ["ratios=[4,2]", "dilations=[[1],[1]]", "decoder.noise_hidden=4",
                 "train.valid_signal_crop=false"]:
    sargs += ["--override", o]
codes.append(cli.main(sargs))
with contextlib.redirect_stdout(io.StringIO()):
    codes.append(cli.main(["export", "--device", "cpu", "--output", str(root / "sart"),
                           "--streaming", "--run", str(next((root / "sruns").iterdir()))]))
    codes.append(cli.main(["generate", "--device", "cpu", "--model",
                           str(root / "sart" / "v2_small_streaming.rtpu"), "--input",
                           str(root / "corpus" / "a.wav"), "--out_path", str(root / "sgen"),
                           "--streaming"]))
hcfg = compose(["hybrid"], ["capacity=2", "latent_size=4", "n_mels=16", "mel_n_fft=512",
                            "mel_hop=128", "encoder.ratios=[4]", "ratios=[4,4,2]",
                            "dilations=[[1],[1],[1]]"])
hmodel = build_rave(hcfg, seed=0, device="cpu")
xh = torch.randn(1, 1, 4 * hcfg.block_size(), generator=torch.Generator().manual_seed(4))
with torch.inference_mode():
    yh = hmodel(xh, draw_noise(hcfg, xh, torch.Generator().manual_seed(5)))
    init_stream_state(hmodel, 1)
    zh = hmodel.step_encode(xh[..., : hcfg.block_size()])
    sh = hmodel.step_decode(zh[:, : hcfg.latent_size])
from rave_tpu_torch.export.artifact import ExportedRAVE
vart = ExportedRAVE(str(root / "vart" / "v3_streaming.rtpu"), device="cpu")
vart.set_learn_target(True)
vart.forward(xt[:1, :, : vart.block_size], streaming=True)
v3_learned = [float(s) for (n, _, _), s in zip(vart.slots, vart.state)
              if n.endswith("num_update_y")]
dckpt = torch.load(sorted((drun / "checkpoints").iterdir())[-1], weights_only=True)["model"]
inited = [float(v) for k, v in dckpt.items() if k.endswith("inited")]
generated = [wavfile.read(root / f"gen{i}" / "a_reconstructed.wav")[1].shape for i in (0, 1)]
generated.append(wavfile.read(root / "dgen" / "a_reconstructed.wav")[1].shape)
generated.append(wavfile.read(root / "vgen" / "a_reconstructed.wav")[1].shape)
generated.append(wavfile.read(root / "sgen" / "a_reconstructed.wav")[1].shape)
print(json.dumps({
    "codes": codes, "eval_step": evaluation["step"], "generated": generated,
    "eval_finite": all(np.isfinite(evaluation[k]) for k in ("spectral_distance", "waveform_l1",
                                                            "frechet_mel_distance")),
    "shape": list(y.shape), "finite": bool(torch.isfinite(y).all()),
    "stream_shape": list(s.shape), "train_step": state.step, "losses": losses,
    "hybrid": [list(yh.shape), bool(torch.isfinite(yh).all()), list(sh.shape),
               bool(torch.isfinite(sh).all())],
    "discrete_inited": inited, "v3_learned": v3_learned,
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
    assert out["codes"] == [0] * 15 and out["eval_step"] == 2 and out["eval_finite"]
    assert out["generated"] == [[52 * 8192]] * 5
    assert out["hybrid"] == [[1, 1, 2048], True, [1, 1, 512], True]
    assert out["discrete_inited"] == [1.0, 1.0]
    assert out["v3_learned"] == [1.0] * 6  # one target update in each AdaIN layer


PRIOR_SCRIPT = """
import contextlib, io, json, pathlib, sys, tempfile
import numpy as np
import torch
from scipy.io import wavfile
torch.set_num_threads(2)
from rave_tpu_torch import cli, config
from rave_tpu_torch.train.state import create_train_state
from rave_tpu_torch.utils.checkpoint import save_checkpoint
root = pathlib.Path(tempfile.mkdtemp())
(root / "corpus").mkdir()
wav = 0.3 * np.sin(2 * np.pi * 220 * np.arange(20 * 8192) / 44100)
wavfile.write(root / "corpus" / "a.wav", 44100, (wav * 32767).astype(np.int16))
cfg = config.compose(["v2"], ["capacity=2", "latent_size=4", "ratios=[4,4,2]",
                              "dilations=[[1],[1],[1]]", "discriminator.capacity=2"])
state = create_train_state(cfg, device="cpu")
state.model.fidelity.copy_(torch.tensor([0.2, 0.4, 0.97, 1.0]))
(root / "run").mkdir()
(root / "run" / "config.json").write_text(config.snapshot(cfg))
save_checkpoint(str(root / "run"), state)
tiny = ["--resolution", "8", "--res_size", "16", "--skp_size", "8", "--n_layers", "3"]
codes = []
with contextlib.redirect_stdout(io.StringIO()):
    codes.append(cli.main(["preprocess", "--input_path", str(root / "corpus"), "--output_path",
                           str(root / "db"), "--num_signal", "8192", "--workers", "2"]))
    codes.append(cli.main(["train_prior", "--device", "cpu", "--run", str(root / "run"),
                           "--db_path", str(root / "db"), "--name", "iso", "--out_path",
                           str(root / "priors"), "--batch", "2", "--n_signal", "8192",
                           "--smoke_test", *tiny]))
    codes.append(cli.main(["export", "--device", "cpu", "--run", str(root / "run"), "--prior",
                           str(root / "priors" / "iso_prior"), "--output", str(root / "art")]))
    codes.append(cli.main(["generate", "--device", "cpu", "--model", str(root / "art" / "v2.rtpu"),
                           "--prior_seconds", "0.25", "--out_path", str(root / "gen")]))
manifest = json.loads((root / "art" / "v2.rtpu" / "manifest.json").read_text())
print(json.dumps({
    "codes": codes, "prior": manifest["prior"]["latent_size"], "aot": sorted(manifest["aot"]),
    "wav": list(wavfile.read(root / "gen" / "prior_sample_0.wav")[1].shape),
    "loaded": sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "rave_tpu")),
}))
"""


def test_prior_never_imports_jax():
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH", "")) if p)}
    proc = subprocess.run([sys.executable, "-c", PRIOR_SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == [], out["loaded"]
    assert out["codes"] == [0] * 4
    assert out["prior"] == 2  # fidelity 0.95 passes at index 2: 2 dimensions
    assert out["aot"] == ["decode_step", "encode_step", "forward_step", "prior_step"]
    assert out["wav"] == [round(0.25 * 44100 / 512) * 512]


V1_SCRIPT = """
import contextlib, io, json, pathlib, sys, tempfile
import numpy as np
import torch
from scipy.io import wavfile
torch.set_num_threads(2)
from rave_tpu_torch import cli, config
from rave_tpu_torch.train.state import create_train_state
from rave_tpu_torch.utils.checkpoint import save_checkpoint
root = pathlib.Path(tempfile.mkdtemp())
(root / "corpus").mkdir()
wav = 0.3 * np.sin(2 * np.pi * 220 * np.arange(20 * 8192) / 44100)
wavfile.write(root / "corpus" / "a.wav", 44100, (wav * 32767).astype(np.int16))
tiny = ["capacity=4", "latent_size=4", "n_band=4", "ratios=[4,2]"]
cfg = config.compose(["onnx"], tiny)
(root / "onnx_run").mkdir()
(root / "onnx_run" / "config.json").write_text(config.snapshot(cfg))
save_checkpoint(str(root / "onnx_run"), create_train_state(cfg, device="cpu"))
overrides = [a for o in tiny + ["discriminator.capacity=2", "distance.scales=[512,256]",
                                "train.phase_1_duration=1"] for a in ("--override", o)]
codes, out = [], io.StringIO()
with contextlib.redirect_stdout(out):
    codes.append(cli.main(["preprocess", "--input_path", str(root / "corpus"), "--output_path",
                           str(root / "db"), "--num_signal", "8192", "--workers", "2"]))
    codes.append(cli.main(["train", "--device", "cpu", "--config", "v1", "--name", "v1",
                           "--db_path", str(root / "db"), "--out_path", str(root / "runs"),
                           "--batch", "2", "--n_signal", "8192", "--workers", "2",
                           "--max_steps", "2", "--val_every", "100", "--no_progress",
                           *overrides]))
    run = next((root / "runs").iterdir())
    codes.append(cli.main(["export", "--device", "cpu", "--run", str(run), "--streaming",
                           "--output", str(root / "art")]))
    codes.append(cli.main(["generate", "--device", "cpu", "--model",
                           str(root / "art" / "v1_streaming.rtpu"), "--input",
                           str(root / "corpus" / "a.wav"), "--out_path", str(root / "gen"),
                           "--streaming"]))
    codes.append(cli.main(["export_onnx", "--device", "cpu", "--run", str(root / "onnx_run"),
                           "--output", str(root / "onnx"), "--verify"]))
print(json.dumps({
    "codes": codes, "onnx": (root / "onnx" / "onnx.onnx").stat().st_size > 0,
    "verified": "verify: max" in out.getvalue(),
    "wav": list(wavfile.read(root / "gen" / "a_reconstructed.wav")[1].shape),
    "loaded": sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "rave_tpu")),
}))
"""


def test_v1_and_onnx_never_import_jax():
    """`train --config v1 -> export --streaming -> generate --streaming` and
    `export_onnx --verify` of an `onnx` run in a fresh interpreter."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH", "")) if p)}
    proc = subprocess.run([sys.executable, "-c", V1_SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == [], out["loaded"]
    assert out["codes"] == [0] * 5
    assert out["onnx"] and out["verified"]
    assert out["wav"] == [20 * 8192]


IMPORT_SCRIPT = """
import contextlib, io, json, pathlib, sys, tempfile
import numpy as np
import torch
from scipy.io import wavfile
torch.set_num_threads(2)
sys.path.insert(0, "tools")
from torch_reference_ckpt import reference_state_dict, save_reference_ckpt
from rave_tpu_torch import cli
from rave_tpu_torch.config import compose
from rave_tpu_torch.factory import build_rave
from rave_tpu_torch.nn.conv import ConvTranspose1d
from rave_tpu_torch.train.state import create_train_state
from rave_tpu_torch.train.steps import build_train_steps
from rave_tpu_torch.utils.convert import jax_path, to_jax_variables
root = pathlib.Path(tempfile.mkdtemp())
gin = root / "run.gin"
gin.write_text('include "configs/v2.gin"\\nCAPACITY = 2\\nLATENT_SIZE = 4\\nRATIOS = [4, 4, 2]\\n'
               'DILATIONS = [[1], [1], [1]]\\n')
cfg = compose([str(gin)])
model = build_rave(cfg, seed=4, device="cpu")
sd = reference_state_dict(to_jax_variables(model), transposed={
    jax_path(n) for n, m in model.named_modules() if isinstance(m, ConvTranspose1d)})
save_reference_ckpt(root / "run.ckpt", sd)
wav = 0.3 * np.sin(2 * np.pi * 220 * np.arange(4 * 8192) / 44100)
wavfile.write(root / "a.wav", 44100, (wav * 32767).astype(np.int16))
codes = []
with contextlib.redirect_stdout(io.StringIO()) as out:
    codes.append(cli.main(["import_torch", "--device", "cpu", "--ckpt", str(root / "run.ckpt"),
                           "--config", str(gin), "--name", "imp", "--out_path",
                           str(root / "runs")]))
    run = next((root / "runs").iterdir())
    codes.append(cli.main(["export", "--device", "cpu", "--run", str(run), "--output",
                           str(root / "art")]))
    codes.append(cli.main(["generate", "--device", "cpu", "--model", str(root / "art" / "run.rtpu"),
                           "--input", str(root / "a.wav"), "--out_path", str(root / "gen")]))
tiny = ["discriminator.capacity=2", "distance.scales=[512,256]", "train.phase_1_duration=1",
        "discriminator.spectral_scales=[512,256]", "discriminator.encodec_capacity=2"]
x = torch.randn(2, 1, 8192, generator=torch.Generator().manual_seed(2)) * 0.1
losses = []
for names, extra, which in (([str(gin), "spectral_discriminator"], [], "dis"),
                            ([str(gin)], ['distance.kind="encodec"', "distance.scales=[256,128]"],
                             "gen"),
                            ([str(gin)], ['distance.kind="instantaneous"'], "gen")):
    c = compose(names, tiny + extra + ["train.valid_signal_crop=false"])
    state = create_train_state(c, device="cpu")
    state.step = 1
    steps = build_train_steps(c)
    g = torch.Generator().manual_seed(3)
    m = steps["dis"](state, x, generator=g) if which == "dis" else steps["gen"](
        state, x, True, generator=g)
    losses.append(float(m["loss_dis"] if which == "dis" else m["loss_gen"]))
print(json.dumps({
    "codes": codes, "name": cfg.name, "losses": losses,
    "wav": list(wavfile.read(root / "gen" / "a_reconstructed.wav")[1].shape),
    "loaded": sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "rave_tpu")),
}))
"""


def test_import_and_gin_never_import_jax():
    """`compose` of a gin, `import_torch` of a reference-named `.ckpt`,
    `export`, `generate`, and steps with the spectral critic and the other
    distances, in a fresh interpreter."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH", "")) if p)}
    proc = subprocess.run([sys.executable, "-c", IMPORT_SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == [], out["loaded"]
    assert out["codes"] == [0] * 3 and out["name"] == "run"
    assert out["wav"] == [4 * 8192]
    assert len(out["losses"]) == 3 and all(math.isfinite(v) for v in out["losses"])


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
    sources.append(ROOT / "tools" / "torch_reference_ckpt.py")  # the smoke's import phase
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
