"""Reference-named state dicts and `.ckpt` files of a RAVE, made from its weights.

The repo holds no checkpoint of the reference implementation
(acids-ircam/RAVE), and none may be fetched, yet `import_torch` reads
exactly such files. So the tests of the importer and `chip_smoke.py`'s
`import` phase make one: `reference_state_dict(variables)` writes a model's
weights, given as the flax-layout tree (rave_tpu's variables, or the port's
`rave_tpu_torch.utils.convert.to_jax_variables(model)`), under the
reference's module names and torch layouts, and `save_reference_ckpt`
wraps them as a Lightning checkpoint. It is the inverse of the importers'
mapping (`_translate_path`, the weight layouts), so importing its output
gives back the same effective weights; tests/test_torch_import.py holds
it to rave_tpu's importer first.

What it writes, by flax leaf:

  * a weight-normed conv's `v`, `g` -> `weight_v`, `weight_g` with torch's
    norm axes: [out, in, k] and g [out, 1, 1] for a conv, [in, out, k] and
    g [in, 1, 1] for a transposed conv (named in `transposed`); `weight_v`
    is the effective kernel scaled by a seeded positive factor per g entry,
    so that the importer's re-decomposition is exercised; a plain conv's `w`
    -> `weight`, `b` -> `bias`;
  * the v2 generator's `waveform` conv -> the next index of its `net`; a
    noise synth's `synth/branches_0` and `synth/branches_1` ->
    `waveform_module` and `noise_module` (`generator="v2"`; v1's synth
    keeps `synth.branches.N`);
  * a GRU's cells (`rnn_<i>/cell/<gate>`) -> `<path>.gru.{weight,bias}_{ih,hh}_l<i>`
    (gates r|z|n, the r and z biases on the input side);
  * BatchNorm's `bn/scale`, `bn/bias` and running `bn/mean`, `bn/var`
    (`batch_stats`) -> `weight`, `bias`, `running_mean`, `running_var`,
    `num_batches_tracked`; Snake's `alpha` [dim] -> [dim, 1]; AdaIN's
    statistics (`adain`) by name; the RVQ's `codebook` collection ->
    `encoder.rvq.layers.<i>._codebook.<leaf>`; the RAVE buffers by name;
  * everything under the Lightning `model.` prefix.

numpy and torch only: it runs where neither jax nor the JAX package is.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Iterable, Mapping, Tuple

import numpy as np
import torch


def reference_path(path: Tuple[str, ...]) -> str:
    """A flax module path -> the reference's module path, the inverse of
    rave_tpu/utils/import_torch.py::_translate_path:
    ('net', 'layers_2', 'aligned', 'branches_0', 'layers_0', 'net', 'inner',
    'layers_1') -> 'net.2.net.branches.0.net.0.net.aligned.branches.0.1'."""
    s = ".".join(re.sub(r"^(layers|branches)_(\d+)$",
                        lambda m: m.group(2) if m.group(1) == "layers" else f"branches.{m.group(2)}",
                        p) for p in path)
    s = re.sub(r"(branches\.\d+)\.(\d+)(?=\.net\.)", r"\1.net.\2", s)  # a ResidualBlock's net
    s = re.sub(r"(^|\.)aligned\.branches\.", r"\1net.branches.", s)  # a ResidualStack's net
    return re.sub(r"(^|\.)inner(?=\.|$)", r"\1aligned.branches.0", s)  # Residual


def _walk(tree: Mapping[str, Any], path: Tuple[str, ...] = ()):
    """(flax path, node) of every module holding leaves, a `bn` or a GRU."""
    leaves = {k: v for k, v in tree.items() if not isinstance(v, Mapping)}
    if leaves or "bn" in tree or "rnn_0" in tree:
        yield path, tree
    for k, v in tree.items():
        if isinstance(v, Mapping) and k != "bn" and not k.startswith("rnn_"):
            yield from _walk(v, path + (k,))


def _leaf(tree: Mapping[str, Any], path: Iterable[str]):
    for p in path:
        tree = tree[p]
    return tree


def _conv(node: Mapping[str, Any], transposed: bool, rng) -> Dict[str, np.ndarray]:
    out = {}
    if "v" in node:
        v = np.asarray(node["v"], np.float64)
        g = np.asarray(node["g"], np.float64).reshape(1, 1, -1)
        w = v * g / np.sqrt((v ** 2).sum(axis=(0, 1), keepdims=True))  # [k, in, out]
        w = w.transpose(1, 2, 0) if transposed else w.transpose(2, 1, 0)
        norm = np.sqrt((w ** 2).sum(axis=(1, 2), keepdims=True))
        scale = rng.uniform(0.5, 2.0, size=norm.shape)
        out["weight_v"], out["weight_g"] = w * scale, norm
    elif "w" in node:
        w = np.asarray(node["w"])
        out["weight"] = w.transpose(1, 2, 0) if transposed else w.transpose(2, 1, 0)
    if "b" in node:
        out["bias"] = np.asarray(node["b"])
    return out


def _gru(node: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    out, layer = {}, 0
    while f"rnn_{layer}" in node:
        cell = node[f"rnn_{layer}"]["cell"]
        kernel = {g: np.asarray(cell[g]["kernel"]) for g in ("ir", "iz", "in", "hr", "hz", "hn")}
        zeros = np.zeros_like(np.asarray(cell["hn"]["bias"]))
        out[f"gru.weight_ih_l{layer}"] = np.concatenate([kernel[g].T for g in ("ir", "iz", "in")])
        out[f"gru.weight_hh_l{layer}"] = np.concatenate([kernel[g].T for g in ("hr", "hz", "hn")])
        out[f"gru.bias_ih_l{layer}"] = np.concatenate(
            [np.asarray(cell[g]["bias"]) for g in ("ir", "iz", "in")])
        out[f"gru.bias_hh_l{layer}"] = np.concatenate([zeros, zeros,
                                                      np.asarray(cell["hn"]["bias"])])
        layer += 1
    return out


def _module_state(params: Mapping[str, Any], batch_stats: Mapping[str, Any],
                  adain: Mapping[str, Any], transposed: Iterable[str], prefix: str,
                  generator: str, rng) -> Dict[str, np.ndarray]:
    """One half's (`encoder.encoder` or `decoder`) reference entries."""
    top = [int(p[1].split("_")[1]) for p, _ in _walk(params)
           if len(p) > 1 and p[0] == "net" and p[1].startswith("layers_")]
    out = {}
    for path, node in _walk(params):
        if path == ("waveform",):
            name = f"net.{max(top) + 1}"
        elif generator == "v2" and path[:2] == ("synth", "branches_0"):
            name = "waveform_module"
        elif generator == "v2" and path[:2] == ("synth", "branches_1"):
            name = ".".join(filter(None, ["noise_module", reference_path(path[2:])]))
        else:
            name = reference_path(path)
        entries = {}
        if "rnn_0" in node:
            entries.update(_gru(node))
        if "bn" in node:
            stats = _leaf(batch_stats, path + ("bn",))
            entries.update(weight=np.asarray(node["bn"]["scale"]),
                           bias=np.asarray(node["bn"]["bias"]),
                           running_mean=np.asarray(stats["mean"]),
                           running_var=np.asarray(stats["var"]),
                           num_batches_tracked=np.zeros((), np.int64))
        if "alpha" in node:
            entries["alpha"] = np.asarray(node["alpha"]).reshape(-1, 1)
        entries.update(_conv(node, "/".join((prefix,) + path) in transposed, rng))
        out.update({f"{name}.{k}": v for k, v in entries.items()})
    for path, node in _walk(adain):
        out.update({f"{reference_path(path)}.{k}": np.asarray(v) for k, v in node.items()})
    return out


def reference_state_dict(variables: Mapping[str, Mapping[str, Any]], generator: str = "v2",
                         transposed: Iterable[str] = (), prefix: str = "model.",
                         seed: int = 0) -> Dict[str, torch.Tensor]:
    """The reference RAVE's `state_dict` holding `variables` (flax layout:
    `params`, `buffers`, `batch_stats`, `codebook`, `adain`), float32 torch
    tensors under `prefix`. `generator`: the decoder's family ("v1" keeps
    its synth's branch names); `transposed`: the flax paths of the
    transposed convs ("decoder/net/layers_2"); `seed` draws the scale of
    each weight-normed conv's `weight_v`."""
    rng = np.random.default_rng(seed)
    params = variables["params"]
    stats, adain = variables.get("batch_stats", {}), variables.get("adain", {})
    transposed = set(transposed)
    sd: Dict[str, np.ndarray] = {}
    for half, key in (("encoder.encoder", ("encoder", "encoder")), ("decoder", ("decoder",))):
        sub = lambda tree: _leaf(tree, key) if _has(tree, key) else {}  # noqa: E731
        state = _module_state(_leaf(params, key), sub(stats), sub(adain), transposed,
                              "/".join(key), generator, rng)
        sd.update({f"{half}.{k}": v for k, v in state.items()})
    if _has(variables.get("codebook", {}), ("encoder", "rvq")):
        for vq, node in variables["codebook"]["encoder"]["rvq"].items():
            i = vq.split("_")[1]
            for leaf, v in node["codebook"].items():
                v = np.asarray(v)
                sd[f"encoder.rvq.layers.{i}._codebook.{leaf}"] = v.reshape(1) if v.ndim == 0 else v
    sd.update({k: np.asarray(v) for k, v in variables.get("buffers", {}).items()})
    return {prefix + k: torch.from_numpy(np.ascontiguousarray(
        v if v.dtype == np.int64 else v.astype(np.float32))) for k, v in sd.items()}


def _has(tree: Mapping[str, Any], key: Tuple[str, ...]) -> bool:
    for p in key:
        if not isinstance(tree, Mapping) or p not in tree:
            return False
        tree = tree[p]
    return True


def save_reference_ckpt(path, state_dict: Mapping[str, torch.Tensor],
                        ema: Mapping[str, torch.Tensor] = None) -> None:
    """A Lightning-style `.ckpt` holding `state_dict`, and the EMA callback's
    shadow weights under `callbacks/EMA` when `ema` is given."""
    torch.save({"epoch": 0, "global_step": 0, "state_dict": dict(state_dict),
                "callbacks": {"EMA": dict(ema)} if ema is not None else {}}, path)
