"""Checkpoints of a training run, run discovery and `load_run`.

The port's counterpart of rave_tpu/utils/checkpoint.py, with `torch.save`
in place of orbax. A checkpoint is one file, `<run>/checkpoints/
step_%010d.pt`, holding plain dicts of tensors: the model's and the critic's
`state_dict` (buffers included: `receptive_field`, `latent_pca`,
`latent_mean`, `fidelity`), both Adams' `state_dict`, the global step and
the EMA dict, so `torch.load(weights_only=True)` restores it. It is written
under a temporary name and renamed, so a file that is half written never
matches `step_*.pt` and resume never picks it. `list_checkpoints`,
`latest_checkpoint(step=)`, `search_for_run` and `search_for_config` behave
as the JAX package's (reference rave/core.py:84-122). `load_run` is
rave_tpu/export/export.py::load_run for the port, what `eval` and `export`
need: it builds the generator alone and reads only its entries of the
checkpoint (memory-mapped), not the critic or the Adams.

A prior run (prior/train.py) keeps its checkpoints the same way, each
holding the step, the prior's `state_dict` and its Adam's
(`save_prior_checkpoint`); `read_prior` gives a prior run's
`prior_config.json` and newest weights, what `export --prior` bundles.
"""
from __future__ import annotations

import json
import os
import re
from pathlib import Path
from typing import Optional

import torch

from rave_tpu_torch import config as config_lib
from rave_tpu_torch.factory import build_rave
from rave_tpu_torch.train.state import TrainState

CHECKPOINT = re.compile(r"step_(\d{10})\.pt")


def checkpoint_step(path: Path) -> int:
    return int(CHECKPOINT.fullmatch(path.name).group(1))


def _write_checkpoint(run_dir: str, step: int, payload: dict) -> Path:
    """`payload` as the checkpoint of `step`, written under a temporary name
    and renamed; returns its path."""
    folder = Path(run_dir).absolute() / "checkpoints"
    folder.mkdir(parents=True, exist_ok=True)
    path = folder / f"step_{step:010d}.pt"
    tmp = path.with_name(path.name + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def save_checkpoint(run_dir: str, state: TrainState) -> Path:
    """Write `state` as the checkpoint of its global step; returns its path."""
    return _write_checkpoint(run_dir, state.step, {
        "step": state.step,
        "model": state.model.state_dict(),
        "discriminator": state.discriminator.state_dict(),
        "gen_opt": state.gen_opt.state_dict(),
        "dis_opt": state.dis_opt.state_dict(),
        "ema": state.ema,
    })


def save_prior_checkpoint(run_dir: str, step: int, prior: torch.nn.Module,
                          opt: torch.optim.Optimizer) -> Path:
    """Write a prior run's checkpoint of `step`: the prior's and its Adam's state."""
    return _write_checkpoint(run_dir, step, {"step": step, "prior": prior.state_dict(),
                                             "opt": opt.state_dict()})


def list_checkpoints(run_dir: str):
    d = Path(run_dir).absolute() / "checkpoints"
    if not d.exists():
        return []
    return sorted(p for p in d.iterdir() if CHECKPOINT.fullmatch(p.name))


def latest_checkpoint(run_dir: str, step: Optional[int] = None) -> Optional[Path]:
    """Newest checkpoint, or the one at exactly `step` when given."""
    ckpts = list_checkpoints(run_dir)
    if step is not None:
        hits = [p for p in ckpts if checkpoint_step(p) == step]
        if not hits:
            raise FileNotFoundError(
                f"no checkpoint at step {step} under {run_dir} "
                f"(available: {[checkpoint_step(p) for p in ckpts]})"
            )
        return hits[0]
    return ckpts[-1] if ckpts else None


def load_optimizer(opt: torch.optim.Optimizer, saved: dict) -> None:
    """`saved` (an optimizer's `state_dict`) into `opt`, which keeps its own
    `capturable`: torch takes the flag from the saved groups and places the
    step counts by it, so a checkpoint written on the CPU, or by a port whose
    Adams were not capturable, would otherwise leave a card's Adam reading
    its counts back to the host, and refuse a CUDA graph."""
    groups = [{**g, "capturable": mine.get("capturable", False)}
              for g, mine in zip(saved["param_groups"], opt.param_groups)]
    opt.load_state_dict({**saved, "param_groups": groups})


def restore_checkpoint(run_dir: str, state: TrainState,
                       step: Optional[int] = None) -> Optional[Path]:
    """Load the newest checkpoint (or the one at `step`) into `state` in
    place, on the device its modules are on; returns its path, or None when
    the run has no checkpoint."""
    path = latest_checkpoint(run_dir, step)
    if path is None:
        return None
    device = next(state.model.parameters()).device
    # loaded on the CPU: the Adams move their moments to the parameters'
    # device, and their step counts too where they are capturable (on a card)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(ckpt["model"])
    state.discriminator.load_state_dict(ckpt["discriminator"])
    load_optimizer(state.gen_opt, ckpt["gen_opt"])
    load_optimizer(state.dis_opt, ckpt["dis_opt"])
    state.step = int(ckpt["step"])
    ema = ckpt["ema"]
    state.ema = None if ema is None else {k: v.to(device) for k, v in ema.items()}
    return path


def search_for_run(path: Optional[str]) -> Optional[str]:
    """Find the run directory holding the newest checkpoints under `path`
    (reference rave/core.py:114-122)."""
    if path is None:
        return None
    p = Path(path)
    if (p / "checkpoints").exists():
        return str(p)
    candidates = sorted(p.rglob("checkpoints"), key=lambda d: os.path.getmtime(d))
    if candidates:
        return str(candidates[-1].parent)
    return None


def search_for_config(run_dir: str) -> Optional[str]:
    """config.json discovery (reference rave/core.py:97-110)."""
    p = Path(run_dir)
    if p.is_file():
        p = p.parent
    for cand in [p, p.parent, p.parent.parent]:
        c = cand / "config.json"
        if c.exists():
            return str(c)
    hits = list(p.rglob("config.json"))
    return str(hits[0]) if hits else None


def read_generator(run: str, use_ema: bool = False, step: Optional[int] = None):
    """(cfg, state_dict, n_channels, run_dir) of a port run directory: the
    generator's `state_dict` (CPU tensors) in its newest checkpoint (or the
    one at exactly `step`), with the EMA weights in place of the trained ones
    when `use_ema` and the run kept an EMA."""
    run_dir = search_for_run(run)
    if run_dir is None:
        raise FileNotFoundError(f"no checkpoints under {run}")
    cfg = config_lib.from_dict(json.loads(Path(search_for_config(run_dir)).read_text()))
    path = latest_checkpoint(run_dir, step)
    if path is None:
        raise FileNotFoundError(f"could not restore a checkpoint from {run_dir}")
    ckpt = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    weights = dict(ckpt["model"])
    if use_ema and ckpt["ema"] is not None:
        weights.update(ckpt["ema"])
    return cfg, weights, cfg.data.n_channels, run_dir


def load_run(run: str, use_ema: bool = False, step: Optional[int] = None,
             device: str | torch.device = "cuda"):
    """(cfg, model, n_channels, run_dir) from a port run directory: the model
    of its newest checkpoint (or the one at exactly `step`) on `device`, in
    eval mode, with the EMA weights in place of the trained ones when
    `use_ema` and the run kept an EMA."""
    cfg, weights, n_channels, run_dir = read_generator(run, use_ema, step)
    model = build_rave(cfg, n_channels=n_channels, device=device)
    model.load_state_dict(weights)
    return cfg, model.eval(), n_channels, run_dir


def read_prior(run: str):
    """(prior_config dict, the prior's `state_dict` (CPU tensors), run_dir) of
    the newest checkpoint of the prior run under `run`."""
    run_dir = search_for_run(run)
    if run_dir is None:
        raise FileNotFoundError(f"no checkpoints under {run}")
    pcfg = json.loads((Path(run_dir) / "prior_config.json").read_text())
    ckpt = torch.load(latest_checkpoint(run_dir), map_location="cpu", weights_only=True)
    return pcfg, ckpt["prior"], run_dir
