#!/usr/bin/env python3
"""Phase `host` of chip_smoke.py alone, on untrained full-width artifacts.

    python3 tools/torch_host_probe.py [--out host_probe.json]

from the root of a checkout, on a machine with a CUDA card. It starts the
artifact host's g++ build (csrc/rtpu_host.cc), saves seeded, untrained
train states of `compose(["v2"])` (with a fidelity curve that keeps all 128
latent dimensions), `compose(["discrete"])` and `compose(["v3"])` as runs
in build/host/probe, bundles a seeded stock prior (latent 16) with the v2
run, exports the four streaming artifacts on the card (`export_model`, the
TorchScript step programs included), times each streaming artifact's Python
forward served (a CUDA graph replay) and eager over `chip_smoke.PROGRAM_BLOCKS`
blocks (`chip_smoke.run_lockstep`, as the smoke's phases time them: blocks on
the card, nothing fetched), and runs `chip_smoke.phase_host` on them: `info`,
`encode` / `decode` / `forward` against the Python eager stream, v3's AdaIN
across three processes, `prior` against `sample_prior`, each command served
by one captured CUDA graph, and `bench`: the host's graph replays and its
eager interpreter on the same blocks, bit-equal, beside the Python p50s. A
few minutes of command time, against the smoke's thirteen: a quicker check
of the host on the card.
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
    from rave_tpu_torch.export.artifact import ExportedRAVE
    from rave_tpu_torch.export.export import export_model
    from rave_tpu_torch.prior.model import build_prior
    from rave_tpu_torch.train.state import create_train_state
    from rave_tpu_torch.utils.checkpoint import save_checkpoint, save_prior_checkpoint

    card = chip_smoke.phase_device()
    build = chip_smoke.HostBuild()
    work = ROOT / "build" / "host" / "probe"
    shutil.rmtree(work, ignore_errors=True)
    artifacts = {}
    for name, names in (("v2", ["v2"]), ("discrete", ["discrete"]), ("v3", ["v3"])):
        cfg = config.compose(names)
        state = create_train_state(cfg, device="cuda")
        if name == "v2":
            with torch.no_grad():
                state.model.fidelity.copy_(torch.linspace(0.5, 1.0, cfg.latent_size))
        run = work / name
        run.mkdir(parents=True)
        (run / "config.json").write_text(config.snapshot(cfg))
        save_checkpoint(str(run), state)
        del state
        torch.cuda.empty_cache()
        artifacts[name] = export_model(run=str(run), streaming=True, output=str(work / "art"),
                                       device="cuda")
    prior = build_prior(chip_smoke.PRIOR_LATENT, seed=0, device="cuda")
    prior_run = work / "prior"
    prior_run.mkdir()
    (prior_run / "prior_config.json").write_text(json.dumps(dict(
        vae_run=str(work / "v2"), latent_size=chip_smoke.PRIOR_LATENT, resolution=32,
        res_size=512, skp_size=256, kernel_size=3, cycle_size=4, n_layers=10, fidelity=0.95)))
    save_prior_checkpoint(str(prior_run), 1, prior, torch.optim.Adam(prior.parameters()))
    artifacts["prior"] = export_model(run=str(work / "v2"), prior=str(prior_run),
                                      output=str(work / "prior_art"), device="cuda")
    kept = {k: chip_smoke.keep_for_host(k, v) for k, v in artifacts.items()}
    shutil.rmtree(work, ignore_errors=True)
    python_p50 = {}
    for name in ("v2", "discrete", "v3"):
        art = ExportedRAVE(str(ROOT / kept[name]), device="cuda")
        n = chip_smoke.PROGRAM_BLOCKS * art.block_size
        gen = torch.Generator(device="cuda").manual_seed(1)
        x = torch.randn(1, 1, n, device="cuda", generator=gen) * 0.1
        python_p50[name] = chip_smoke.run_lockstep(art, x, 0).p50()
        del art
    out = chip_smoke.phase_host(build, kept, python_p50, card)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(out, indent=1, default=str))


if __name__ == "__main__":
    main()
