"""Load a rave_tpu (JAX) model's or critic's variables into the port.

`from_jax_variables(model, variables)` takes the JAX `params`, `buffers`,
`batch_stats`, `codebook` and `adain` trees (nested dicts of numpy arrays; jax arrays pass
through `np.asarray`)
and copies them into a port model (a RAVE, or a critic of
models/discriminators.py) built from the same config. The port's
attribute names mirror flax's module paths, so a path maps by rename:

    encoder/encoder/net/layers_9/inner/net/layers_1/v
      -> encoder.encoder.net.layers.9.inner.net.layers.1.v
    encoder/rvq/vq_3/codebook/embed -> encoder.rvq.vq.3.codebook.embed
    decoder/synth/branches_1/net/layers_0/w -> decoder.synth.branches.1.net.layers.0.w

and each leaf changes layout:

  * Conv1d `v`/`w` [K, I, O] -> [O, I, K];
  * ConvTranspose1d `v`/`w` [K, I, O] -> [I, O, K] (no flip: the JAX
    `_full` is a true transposed convolution, rave_tpu/nn/conv.py:254-267);
  * the critics' `WNConv` `v`/`w` [K, I, O] -> [O, I, K], their 2D
    kernels [KH, KW, I, O] -> [O, I, KH, KW], and the period critics'
    (K, 1) kernels [K, 1, I, O] -> [O, I, K] (the port keeps those as 1D
    kernels, models/discriminators.py and models/descript.py);
  * `g` [1, 1, O] (or [1, 1, 1, O]) -> [O], one value per output channel;
  * AdaIN's statistics `mean_*` / `std_*` [N, 1, C] -> [N, C, 1];
  * the GRU's `rnn_<i>/cell/<gate>/kernel` [in, out] and `bias` keep
    flax's layout (nn/gru.py assembles torch's weights from them); its
    gate `in` is the port's `in_`;
  * biases, Snake's `alpha`, BatchNorm's `bn/scale` and `bn/bias`
    (params) and its running `bn/mean` and `bn/var` (`batch_stats`, the
    port's buffers), the RAVE buffers, AdaIN's counters and flags
    and the discrete codebooks' state (`embed`, `embed_avg`,
    `cluster_size`, `inited`) are copied as they are.

`from_jax_prior(prior, params)` does the same for a flax `Prior`'s params
(`pre_net/layers_0`, `res_<i>/dconv|rconv|sconv`, `post_net/layers_<j>`;
its grouped convs' kernels [K, I/groups, O] -> [O, I/groups, K]).

`convert_tree(model, tree)` gives the converted arrays by port name without
loading them (the tests compare gradients with it). Optimizer state is not
converted: a port train state starts its Adam moments from zero.

The load is strict: every JAX leaf lands on exactly one port tensor of the
same shape, and every port parameter and persistent buffer is set. The
`cache` collection (streaming state) is not a weight and is skipped.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from rave_tpu_torch.models.blocks import AdaIN
from rave_tpu_torch.models.discriminators import WNConv
from rave_tpu_torch.nn.conv import Conv1d, ConvTranspose1d
from rave_tpu_torch.nn.gru import GATE_NAMES


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
    """'a/layers_3/v' -> 'a.layers.3.v'; 'rvq/vq_3' -> 'rvq.vq.3';
    'synth/branches_0' -> 'synth.branches.0'; a GRU cell's 'in' -> 'in_'."""
    parts = [re.sub(r"^(layers|vq|branches)_(\d+)$", r"\1.\2", p) for p in jax_path.split("/")]
    return ".".join(GATE_NAMES.get(p, p) if i and parts[i - 1] == "cell" else p
                    for i, p in enumerate(parts))


def _convert(owner: torch.nn.Module, leaf: str, value: np.ndarray) -> np.ndarray:
    if leaf in ("v", "w"):
        if isinstance(owner, WNConv):
            if value.ndim == 4 and getattr(owner, leaf).ndim == 3:  # a (K, 1) kernel
                if value.shape[1] != 1:
                    raise ValueError(f"2D kernel {value.shape} where the port has a (K, 1) one")
                value = value[:, 0]
            return value.transpose(3, 2, 0, 1) if value.ndim == 4 else value.transpose(2, 1, 0)
        if isinstance(owner, Conv1d):
            return value.transpose(2, 1, 0)
        if isinstance(owner, ConvTranspose1d):
            return value.transpose(1, 2, 0)
    if leaf == "g" and isinstance(owner, (Conv1d, ConvTranspose1d, WNConv)):
        return value.reshape(-1)
    if isinstance(owner, AdaIN) and leaf.startswith(("mean_", "std_")):
        return value.transpose(0, 2, 1)
    return value


def convert_tree(model: torch.nn.Module, tree: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """A JAX tree of `model`'s leaves (params, or gradients of them) as
    arrays in the port's layouts, keyed by the port's names."""
    out = {}
    for path, value in _flatten(tree).items():
        name = port_name(path)
        owner_name, _, leaf = name.rpartition(".")
        try:
            owner = model.get_submodule(owner_name)
        except AttributeError:
            raise KeyError(f"{path}: the port has no tensor {name}") from None
        out[name] = _convert(owner, leaf, value)
    return out


def from_jax_variables(model: torch.nn.Module, variables: Mapping[str, Any]) -> None:
    """Copy JAX `{'params': ..., 'buffers': ..., 'batch_stats': ...,
    'codebook': ..., 'adain': ...}` into `model`, strictly."""
    unknown = set(variables) - {"params", "buffers", "batch_stats", "codebook", "adain",
                                "cache"}
    if unknown:
        raise ValueError(f"unexpected variable collections {sorted(unknown)}")
    targets = dict(model.named_parameters())
    persistent = set(model.state_dict())
    targets.update({n: b for n, b in model.named_buffers() if n in persistent})
    loaded = set()
    for collection in ("params", "buffers", "batch_stats", "codebook", "adain"):
        for name, value in convert_tree(model, variables.get(collection, {})).items():
            if name not in targets:
                raise KeyError(f"{collection}: the port has no tensor {name}")
            if name in loaded:
                raise KeyError(f"{collection}: {name} is loaded twice")
            target = targets[name]
            if tuple(value.shape) != tuple(target.shape):
                raise ValueError(f"{collection}: shape {value.shape} does not fit "
                                 f"{name} {tuple(target.shape)}")
            with torch.no_grad():
                target.copy_(torch.tensor(value))
            loaded.add(name)
    missing = sorted(set(targets) - loaded)
    if missing:
        raise KeyError(f"port tensors not set by the JAX variables: {missing}")


def from_jax_prior(prior: torch.nn.Module, params: Mapping[str, Any]) -> None:
    """Copy a flax `Prior`'s `params` into the port's `Prior` (prior/model.py),
    strictly: the names map by rename, the kernels by the Conv1d transpose."""
    from_jax_variables(prior, {"params": params})
