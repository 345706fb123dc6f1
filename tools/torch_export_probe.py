#!/usr/bin/env python3
"""Phase `export` of chip_smoke.py alone, on an untrained full-width v2 run.

    python3 tools/torch_export_probe.py [--out export_probe.json]

from the root of a checkout, on a machine with a CUDA card and nvcc. It
builds the fused unit's kernel, saves a seeded, untrained `compose(["v2"])`
train state (with an EMA, and a fidelity curve that keeps all 128 latent
dimensions) as the checkpoint of a run in build/loop/runs/probe, and runs
`chip_smoke.phase_export` on it: export twice, generate a 30 s file, the
card against the CPU, `forward_step.pt2` against the eager steps, and the
unit at generate's B=1 shapes. About a minute and a half of command time,
against the smoke's two: a quicker check of the export path on the card.
"""
import argparse
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=None, help="write the phase's numbers here as JSON")
    a = p.parse_args()

    import torch

    import chip_smoke
    from rave_tpu_torch import config
    from rave_tpu_torch.train.state import create_train_state
    from rave_tpu_torch.utils.checkpoint import save_checkpoint

    chip_smoke.phase_device()
    chip_smoke.phase_build()
    cfg = config.compose(["v2"], ["train.ema=0.999"])
    state = create_train_state(cfg, device="cuda")
    with torch.no_grad():
        state.model.fidelity.copy_(torch.linspace(0.5, 1.0, cfg.latent_size))
    run = ROOT / "build" / "loop" / "runs" / "probe"
    run.mkdir(parents=True, exist_ok=True)
    (run / "config.json").write_text(config.snapshot(cfg))
    save_checkpoint(str(run), state)
    del state
    torch.cuda.empty_cache()
    out = chip_smoke.phase_export(run)
    shutil.rmtree(ROOT / "build" / "loop", ignore_errors=True)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(out, indent=1, default=str))


if __name__ == "__main__":
    main()
