"""Load a rave_tpu (JAX) model's variables into the port.

`from_jax_variables(model, variables)` takes the JAX `params` and `buffers`
trees (nested dicts of numpy arrays; jax arrays pass through `np.asarray`)
and copies them into a port model built from the same config. The port's
attribute names mirror flax's module paths, so a path maps by rename:

    encoder/encoder/net/layers_9/inner/net/layers_1/v
      -> encoder.encoder.net.layers.9.inner.net.layers.1.v

and each leaf changes layout:

  * Conv1d `v`/`w` [K, I, O] -> [O, I, K];
  * ConvTranspose1d `v`/`w` [K, I, O] -> [I, O, K] (no flip: the JAX
    `_full` is a true transposed convolution, rave_tpu/nn/conv.py:254-267);
  * `g` [1, 1, O] -> [O], one value per output channel, for both kinds;
  * biases and the RAVE buffers are copied as they are.

The load is strict: every JAX leaf lands on exactly one port tensor of the
same shape, and every port parameter and persistent buffer is set. The
`cache` collection (streaming state) is not a weight and is skipped.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from rave_tpu_torch.nn.conv import Conv1d, ConvTranspose1d


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def port_name(jax_path: str) -> str:
    """'a/layers_3/v' -> 'a.layers.3.v'."""
    return ".".join(re.sub(r"^layers_(\d+)$", r"layers.\1", p) for p in jax_path.split("/"))


def _convert(owner: torch.nn.Module, leaf: str, value: np.ndarray) -> np.ndarray:
    if leaf in ("v", "w"):
        if isinstance(owner, Conv1d):
            return value.transpose(2, 1, 0)
        if isinstance(owner, ConvTranspose1d):
            return value.transpose(1, 2, 0)
    if leaf == "g" and isinstance(owner, (Conv1d, ConvTranspose1d)):
        return value.reshape(-1)
    return value


def from_jax_variables(model: torch.nn.Module, variables: Mapping[str, Any]) -> None:
    """Copy JAX `{'params': ..., 'buffers': ...}` into `model`, strictly."""
    unknown = set(variables) - {"params", "buffers", "cache"}
    if unknown:
        raise ValueError(f"unexpected variable collections {sorted(unknown)}")
    targets = dict(model.named_parameters())
    persistent = set(model.state_dict())
    targets.update({n: b for n, b in model.named_buffers() if n in persistent})
    loaded = set()
    for collection in ("params", "buffers"):
        for path, value in _flatten(variables.get(collection, {})).items():
            name = port_name(path)
            if name not in targets:
                raise KeyError(f"{collection}/{path}: the port has no tensor {name}")
            if name in loaded:
                raise KeyError(f"{collection}/{path}: {name} is loaded twice")
            owner_name, _, leaf = name.rpartition(".")
            value = _convert(model.get_submodule(owner_name), leaf, value)
            target = targets[name]
            if tuple(value.shape) != tuple(target.shape):
                raise ValueError(f"{collection}/{path}: shape {value.shape} does not fit "
                                 f"{name} {tuple(target.shape)}")
            with torch.no_grad():
                target.copy_(torch.tensor(value))
            loaded.add(name)
    missing = sorted(set(targets) - loaded)
    if missing:
        raise KeyError(f"port tensors not set by the JAX variables: {missing}")
