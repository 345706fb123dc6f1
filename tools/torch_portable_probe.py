#!/usr/bin/env python3
"""Phase `portable` of chip_smoke.py alone, on untrained full-width runs.

    python3 tools/torch_portable_probe.py [--out portable_probe.json]

from the root of a checkout, on a machine with a CUDA card. It builds the
kernel library, runs phase `offline` (the live figure the portable
program's time is printed beside), saves seeded, untrained train states of
`compose(["v2"])`, `compose(["discrete"])` and `compose(["v3"])` as runs in
build/portable_probe, exports their portable programs on the card through
`cli export_onnx` as the smoke's phases `v1`, `discrete` and `v3` do (v2 at
B=16 and at B=1 x 131072, the others at B=1) and runs
`chip_smoke.phase_portable` on them: the registered op against the ctypes
wrapper and the plain version at every v2 unit shape, and each program in a
process that imports torch alone, against the live forward, its `.pt2`, its
op launches and its profiled kernels. A few minutes of command time.
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
    offline = chip_smoke.phase_offline()
    work = ROOT / "build" / "portable_probe"
    shutil.rmtree(work, ignore_errors=True)
    runs = {}
    for name in ("v2", "discrete", "v3"):
        cfg = config.compose([name])
        state = create_train_state(cfg, device="cuda")
        run = work / name
        run.mkdir(parents=True)
        (run / "config.json").write_text(config.snapshot(cfg))
        save_checkpoint(str(run), state)
        del state
        torch.cuda.empty_cache()
        runs[name] = run
    cases = {"v2_b1": chip_smoke.export_portable_case(runs["v2"], "v2_b1"),
             "v2_b16": chip_smoke.export_portable_case(runs["v2"], "v2_b16", chip_smoke.BATCH),
             "discrete": chip_smoke.export_portable_case(runs["discrete"], "discrete"),
             "v3": chip_smoke.export_portable_case(runs["v3"], "v3")}
    shutil.rmtree(work, ignore_errors=True)
    out = chip_smoke.phase_portable(cases, offline)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(out, indent=1, default=str))


if __name__ == "__main__":
    main()
