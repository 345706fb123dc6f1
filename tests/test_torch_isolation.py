"""rave_tpu_torch runs without jax: the machine with the GPU has none.

A fresh interpreter imports the port, builds the tiny v2 through its own
config and factory, runs a forward and the streaming pair, builds the
tiny critic and runs one generator step of each phase and one critic step
through the port's train state, then one generator and one critic step
with `train.bf16` and `train.bf16_dis`, and then reports whether jax, flax
or any module of the JAX package was ever imported.
"""
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
print(json.dumps({
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
