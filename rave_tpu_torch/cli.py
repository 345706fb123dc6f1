"""The port's command line: `python -m rave_tpu_torch.cli <command> ...`.

The ported commands of rave_tpu/cli.py, with the same flags plus
`--device` (default `cuda`; `cpu` runs the kernels' plain versions):

  preprocess : corpus -> ARS store (data/preprocess.py)
  train      : the training driver (train/loop.py); `--bf16` sets
               train.bf16 and train.bf16_dis, as the JAX CLI's does
  eval       : reconstruction metrics of a run (train/evaluate.py)

The other commands of the JAX CLI exit non-zero and name the ROADMAP item
that ports them.
"""
from __future__ import annotations

import argparse
import sys

NOT_PORTED = {
    "train_prior": "A12 (the prior)",
    "export": "A13 (export and generate)",
    "export_onnx": "A13 (export and generate)",
    "generate": "A13 (export and generate)",
    "import_torch": "A15 (reference checkpoints into the port)",
    "remote_dataset": "A18 (the remote dataset)",
}


def _add_config_flags(p: argparse.ArgumentParser):
    p.add_argument("--config", action="append", default=[],
                   help="config preset (stackable, e.g. --config v2 --config causal)")
    p.add_argument("--override", action="append", default=[],
                   help="dotted config override, e.g. train.beta_target=0.2")
    p.add_argument("--augment", action="append", default=[],
                   help="augmentation: registry name (mute|compress|gain), inline JSON spec "
                   "('{\"type\":\"RandomCompress\",...}'), or a Python file calling "
                   "add_augmentation(...)")


def cmd_preprocess(argv):
    p = argparse.ArgumentParser("rave_tpu_torch preprocess")
    p.add_argument("--input_path", required=True)
    p.add_argument("--output_path", required=True)
    p.add_argument("--num_signal", type=int, default=131072)
    p.add_argument("--sampling_rate", type=int, default=44100)
    p.add_argument("--channels", type=int, default=1)
    p.add_argument("--lazy", action="store_true")
    p.add_argument("--workers", type=int, default=8)
    a = p.parse_args(argv)
    from rave_tpu_torch.data.preprocess import preprocess

    print(preprocess(a.input_path, a.output_path, a.num_signal, a.sampling_rate,
                     a.channels, a.lazy, a.workers))


def cmd_train(argv):
    p = argparse.ArgumentParser("rave_tpu_torch train")
    _add_config_flags(p)
    p.add_argument("--name", required=True)
    p.add_argument("--db_path", required=True)
    p.add_argument("--out_path", default="runs")
    p.add_argument("--channels", type=int, default=0)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--n_signal", type=int, default=131072)
    p.add_argument("--max_steps", type=int, default=6_000_000)
    p.add_argument("--val_every", type=int, default=10000)
    p.add_argument("--save_every", type=int, default=500000)
    p.add_argument("--smoke_test", action="store_true")
    p.add_argument("--ema", type=float, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no_resume", action="store_true")
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--derivative", action="store_true")
    p.add_argument("--normalize", action="store_true")
    p.add_argument("--rand_pitch", type=float, default=None)
    p.add_argument("--no_progress", action="store_true")
    p.add_argument("--trace_steps", type=int, default=0,
                   help="capture a torch.profiler trace of N steps into <run>/trace")
    p.add_argument("--device_data", choices=("auto", "on", "off"), default="auto",
                   help="device-resident dataset: the whole int16 db on the card, batches "
                   "assembled there (auto: when the db fits $RAVE_TPU_DEVICE_DATA_MAX_GB, "
                   "default 4)")
    p.add_argument("--bf16", action="store_true",
                   help="model and critic compute in bfloat16 (master weights stay fp32): "
                   "--override train.bf16=true --override train.bf16_dis=true")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = p.parse_args(argv)

    from rave_tpu_torch import config as config_lib
    from rave_tpu_torch.train.loop import train

    cfg = config_lib.compose(a.config or ["v2"], a.override)
    if a.bf16:
        cfg.train.bf16 = True
        cfg.train.bf16_dis = True
    cfg.data.batch = a.batch
    cfg.data.n_signal = a.n_signal
    cfg.data.workers = a.workers
    cfg.data.derivative = a.derivative
    cfg.data.normalize = a.normalize
    cfg.data.rand_pitch = a.rand_pitch
    if a.augment:
        cfg.data.augmentations = tuple(list(cfg.data.augmentations) + a.augment)
    if a.ema is not None:
        cfg.train.ema = a.ema
    run_dir = train(
        cfg, a.db_path, name=a.name, out_path=a.out_path, n_channels=a.channels or None,
        max_steps=a.max_steps, val_every=a.val_every, save_every=a.save_every,
        smoke_test=a.smoke_test, seed=a.seed, resume=not a.no_resume,
        progress=not a.no_progress, trace_steps=a.trace_steps, device_data=a.device_data,
        device=a.device,
    )
    print(f"run dir: {run_dir}")


def cmd_eval(argv):
    from rave_tpu_torch.train.evaluate import main as eval_main

    eval_main(argv)


COMMANDS = {"preprocess": cmd_preprocess, "train": cmd_train, "eval": cmd_eval}


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m rave_tpu_torch.cli {" + ",".join(COMMANDS) + "} ...")
        return 0
    cmd = argv[0]
    if cmd in NOT_PORTED:
        print(f"{cmd} is not ported to rave_tpu_torch yet: ROADMAP {NOT_PORTED[cmd]}",
              file=sys.stderr)
        return 2
    if cmd not in COMMANDS:
        print(f"unknown command {cmd}; available: {sorted(COMMANDS)}", file=sys.stderr)
        return 1
    COMMANDS[cmd](argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
