"""The port's command line: `python -m rave_tpu_torch.cli <command> ...`.

The ported commands of rave_tpu/cli.py, with the same flags plus
`--device` (default `cuda`; `cpu` runs the kernels' plain versions):

  preprocess : corpus -> ARS store (data/preprocess.py)
  train      : the training driver (train/loop.py); `--bf16` sets
               train.bf16 and train.bf16_dis, as the JAX CLI's does
  train_prior: the latent prior on a variational run (prior/train.py);
               `--config prior_v1.gin` reads a reference prior gin
  import_torch: a reference `.ckpt` (acids-ircam/RAVE) -> a port run
               directory with a step-0 checkpoint that `export`,
               `generate`, `eval` and `train` (resuming) take
               (utils/import_torch.py)
  eval       : reconstruction metrics of a run (train/evaluate.py)
  export     : run -> `.rtpu` artifact with its `torch.export` step
               programs, `--prior` bundling a prior run (export/export.py)
  generate   : files -> reconstructed wavs through an artifact or a run,
               or `--prior_seconds` of the artifact's prior
               (export/generate.py)
  export_onnx: run -> `<name>.onnx`, opset 12, for v1 and v2 without the
               noise synth (export/onnx_export.py); `--verify` runs it in
               the port's interpreter against the live model. Only the
               `.onnx` is written: the JAX command's StableHLO graph is not
               ported (`--skip_stablehlo` is accepted and changes nothing)

  remote_dataset: serve an ARS store over HTTP (/len, /get/<i>) to
               `get_dataset("http://host:port")` (data/server.py)

Every `--config` takes preset names and reference `.gin` files
(config_gin.py). `train` runs data-parallel under `torchrun`
(`python -m torch.distributed.run --nproc_per_node N -m rave_tpu_torch.cli
train ...`): one process per rank, `--batch` per rank (parallel/mesh.py).
"""
from __future__ import annotations

import argparse
import sys


def _add_config_flags(p: argparse.ArgumentParser):
    p.add_argument("--config", action="append", default=[],
                   help="config preset or reference .gin file (stackable, e.g. --config v2 "
                   "--config causal, --config run/config.gin)")
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
    from rave_tpu_torch.parallel import mesh

    if mesh.is_main():
        print(f"run dir: {run_dir}")
    mesh.shutdown()


def cmd_train_prior(argv):
    p = argparse.ArgumentParser("rave_tpu_torch train_prior")
    p.add_argument("--run", required=True, help="pretrained RAVE run dir")
    p.add_argument("--db_path", required=True)
    p.add_argument("--name", required=True)
    p.add_argument("--out_path", default="runs")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--n_signal", type=int, default=131072)
    p.add_argument("--max_steps", type=int, default=1_000_000)
    p.add_argument("--val_every", type=int, default=10000)
    p.add_argument("--fidelity", type=float, default=0.95)
    p.add_argument("--config", default=None,
                   help="reference prior gin file (configs/prior/prior_v1.gin): its "
                   "VariationalPrior bindings become the architecture; flags override them")
    # the prior's architecture: the reference's prior_v1.gin bindings
    # (rave/configs/prior/prior_v1.gin:1-8) unless a flag overrides them
    for flag in ("resolution", "res_size", "skp_size", "kernel_size", "cycle_size", "n_layers"):
        p.add_argument(f"--{flag}", type=int, default=None)
    p.add_argument("--smoke_test", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = p.parse_args(argv)
    from rave_tpu_torch.prior.train import train_prior

    arch = dict(resolution=32, res_size=512, skp_size=256, kernel_size=3, cycle_size=4,
                n_layers=10)
    if a.config:
        from rave_tpu_torch.config_gin import prior_kwargs_from_gin

        arch.update(prior_kwargs_from_gin(a.config))
    arch.update({k: getattr(a, k) for k in arch if getattr(a, k) is not None})
    run_dir = train_prior(run=a.run, db_path=a.db_path, name=a.name, out_path=a.out_path,
                          batch=a.batch, n_signal=a.n_signal, max_steps=a.max_steps,
                          val_every=a.val_every, fidelity=a.fidelity,
                          smoke_test=a.smoke_test, device=a.device, **arch)
    print(f"prior run dir: {run_dir}")


def cmd_import_torch(argv):
    """A reference checkpoint into a port run directory (rave_tpu/cli.py:323-379)."""
    p = argparse.ArgumentParser("rave_tpu_torch import_torch")
    _add_config_flags(p)
    p.add_argument("--ckpt", required=True, help="reference .ckpt file")
    p.add_argument("--name", required=True)
    p.add_argument("--out_path", default="runs")
    p.add_argument("--channels", type=int, default=1)
    p.add_argument("--ema_weights", action="store_true",
                   help="import the EMA shadow (ckpt['callbacks']['EMA']) instead of the live "
                   "weights (reference scripts/export.py:507-511)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = p.parse_args(argv)
    from rave_tpu_torch import config as config_lib
    from rave_tpu_torch.train.loop import make_run_dir
    from rave_tpu_torch.train.state import create_train_state
    from rave_tpu_torch.utils.checkpoint import save_checkpoint
    from rave_tpu_torch.utils.import_torch import load_reference_state, read_reference_checkpoint

    sd = read_reference_checkpoint(a.ckpt, a.ema_weights)
    cfg = config_lib.compose(a.config or ["v2"], a.override)
    cfg.data.n_channels = a.channels
    state = create_train_state(cfg, n_channels=a.channels, device=a.device)
    load_reference_state(state.model, sd)
    if state.ema is not None:  # the EMA starts from the imported weights
        state.ema = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    run_dir = make_run_dir(a.out_path, a.name, cfg)
    save_checkpoint(str(run_dir), state)
    print(f"imported into: {run_dir}")


def cmd_eval(argv):
    from rave_tpu_torch.train.evaluate import main as eval_main

    eval_main(argv)


def cmd_export(argv):
    p = argparse.ArgumentParser("rave_tpu_torch export")
    p.add_argument("--run", required=True)
    p.add_argument("--streaming", action="store_true")
    p.add_argument("--fidelity", type=float, default=0.95)
    p.add_argument("--stereo", action="store_true")
    p.add_argument("--ema_weights", action="store_true")
    p.add_argument("--channels", type=int, default=0)
    p.add_argument("--sr", type=int, default=0, help="target sample rate")
    p.add_argument("--output", default=None)
    p.add_argument("--prior", default=None, help="prior run dir to bundle")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = p.parse_args(argv)
    from rave_tpu_torch.export.export import export_model

    path = export_model(run=a.run, streaming=a.streaming, fidelity=a.fidelity, stereo=a.stereo,
                        use_ema=a.ema_weights, channels=a.channels or None,
                        target_sr=a.sr or None, output=a.output, prior=a.prior,
                        device=a.device)
    print(f"exported: {path}")


def cmd_generate(argv):
    p = argparse.ArgumentParser("rave_tpu_torch generate")
    p.add_argument("--model", required=True, help="run dir or exported artifact")
    p.add_argument("--input", nargs="+", default=[])
    p.add_argument("--out_path", default="generated")
    p.add_argument("--streaming", action="store_true")
    p.add_argument("--chunk_size", type=int, default=0)
    p.add_argument("--prior_seconds", type=float, default=0.0,
                   help="unconditional generation from the artifact's prior")
    p.add_argument("--prior_samples", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = p.parse_args(argv)
    if not a.input and not a.prior_seconds:
        p.error("either --input files or --prior_seconds is required")
    from rave_tpu_torch.export.generate import generate

    generate(model=a.model, inputs=a.input, out_path=a.out_path, streaming=a.streaming,
             chunk_size=a.chunk_size or None, prior_seconds=a.prior_seconds,
             prior_samples=a.prior_samples, seed=a.seed, device=a.device)


def cmd_export_onnx(argv):
    """The `.onnx` where the configuration has one (v1 and v2 without the
    noise synth, mono, variational), and the portable full graph of every
    family (export/portable.py), as rave_tpu/cli.py::cmd_export_onnx."""
    p = argparse.ArgumentParser("rave_tpu_torch export_onnx")
    p.add_argument("--run", required=True)
    p.add_argument("--n_signal", type=int, default=131072,
                   help="samples per channel of the portable program's input")
    p.add_argument("--batch", type=int, default=1, help="the portable program's batch")
    p.add_argument("--output", default=None)
    p.add_argument("--deterministic", action="store_true",
                   help="use the posterior mean instead of RandomNormalLike sampling")
    p.add_argument("--verify", action="store_true",
                   help="evaluate the .onnx with the port's interpreter and compare it with "
                   "the live model on --device")
    p.add_argument("--skip_stablehlo", action="store_true",
                   help="emit only the .onnx: skip the portable TorchScript program (the JAX "
                   "command's name for its portable StableHLO export)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = p.parse_args(argv)
    from pathlib import Path

    from rave_tpu_torch.export.onnx_export import export_onnx_model
    from rave_tpu_torch.utils.checkpoint import load_run

    cfg, model, n_channels, run_dir = load_run(a.run, device=a.device)
    code = 0
    try:
        if n_channels != 1:
            raise NotImplementedError(f"ONNX export is mono; got n_channels={n_channels}")
        data = export_onnx_model(cfg, model, deterministic=a.deterministic)
    except NotImplementedError as e:
        print(f"no .onnx for this configuration ({e})")
    else:
        path = Path(a.output or run_dir) / f"{cfg.name}.onnx"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(data)
        print(f"exported: {path}")
        if a.verify:
            err, n = verify_onnx(cfg, model)
            print(f"verify: max |onnx - live| = {err:.2e} over {n} samples")
            if not err < 1e-4:
                print("ONNX verification failed", file=sys.stderr)
                code = 1
    if not a.skip_stablehlo:
        from rave_tpu_torch.export.portable import write_portable

        path = write_portable(cfg, model, n_channels, Path(a.output or run_dir), a.n_signal,
                              a.batch)
        print(f"exported: {path}")
    return code


def verify_onnx(cfg, model):
    """(max |onnx - live|, samples): the deterministic graph in the port's
    interpreter against the live model's encode, posterior mean and decode
    on its device (TF32 off), over n_band * 256 seeded samples
    (rave_tpu/cli.py::_verify_onnx)."""
    import numpy as np
    import torch

    from rave_tpu_torch.export.onnx_export import export_onnx_model
    from rave_tpu_torch.export.onnx_run import run as onnx_run
    from rave_tpu_torch.train.loop import fp32_exact

    T = cfg.n_band * 256
    x = (np.random.default_rng(0).normal(size=(1, 1, T)) * 0.3).astype(np.float32)
    device = next(model.parameters()).device
    with torch.no_grad(), fp32_exact():
        z = model.encode(torch.from_numpy(x).to(device))
        want = model.decode(z[:, : cfg.latent_size]).cpu().numpy()
    got = onnx_run(export_onnx_model(cfg, model, deterministic=True), {"audio_in": x})
    return float(np.abs(got["audio_out"] - want).max()), T


def cmd_remote_dataset(argv):
    p = argparse.ArgumentParser("rave_tpu_torch remote_dataset")
    p.add_argument("--db_path", required=True)
    p.add_argument("--port", type=int, default=5000)
    a = p.parse_args(argv)
    from rave_tpu_torch.data.server import serve

    serve(a.db_path, a.port)


COMMANDS = {"preprocess": cmd_preprocess, "train": cmd_train, "train_prior": cmd_train_prior,
            "eval": cmd_eval, "export": cmd_export, "generate": cmd_generate,
            "export_onnx": cmd_export_onnx, "import_torch": cmd_import_torch,
            "remote_dataset": cmd_remote_dataset}


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m rave_tpu_torch.cli {" + ",".join(COMMANDS) + "} ...")
        return 0
    cmd = argv[0]
    if cmd not in COMMANDS:
        print(f"unknown command {cmd}; available: {sorted(COMMANDS)}", file=sys.stderr)
        return 1
    return COMMANDS[cmd](argv[1:]) or 0


if __name__ == "__main__":
    sys.exit(main())
