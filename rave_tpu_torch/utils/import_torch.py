"""Import trained PyTorch reference checkpoints (acids-ircam/RAVE `.ckpt`)
into the port.

The port's copy of rave_tpu/utils/import_torch.py (its numpy code, the
same, so that both packages place every tensor alike), plus the entry
that loads the result into a port model: `load_reference_state(model,
state_dict)` takes the port model's tensors as the JAX package's flax
tree (utils/convert.py::to_jax_variables) as the template that
`import_reference_checkpoint` places the reference tensors on, and loads
the filled tree back with `from_jax_variables`, strictly.
`read_reference_checkpoint(path, ema_weights)` reads a `.ckpt` into the
state dict of numpy arrays the importer takes.

The reference's modules (rave/blocks.py EncoderV2:514-596,
GeneratorV2:599-714, the v1 family at :48-164) and the flax tree are
structurally parallel (`net.N` <-> `net/layers_N`, the Residual wrapper
`aligned.branches.0` <-> `inner`), so a trained `.ckpt`'s state_dict maps
path by path:

  * conv `weight_v [out, in, k]` -> `v [k, in, out]`; transposed conv
    `weight_v [in, out, k]` -> `v [k, in, out]`. Weight-norm conventions
    differ (torch normalizes transposed convs per *input* channel), so the
    torch-side effective weight `w = g * v / ||v||` is computed first and
    re-decomposed into the flax (v, g), which keeps the product;
  * the generator's final waveform conv lives inside `net` in the
    reference and is the `waveform` submodule here; a noise synth's
    `waveform_module` / `noise_module` are `synth/branches_0` / `_1`;
  * a `gru` module's torch GRU becomes the GRU cells' dense layers, the
    BatchNorms' `running_mean` / `running_var` the `batch_stats`, Snake's
    `alpha` [dim, 1] its [dim], the RVQ's codebooks the `codebook`
    collection; AdaIN's runtime statistics are not weights and start fresh;
  * `latent_pca` / `latent_mean` / `fidelity` transfer verbatim; PQMF
    filters, the critic and the distances' windows are not imported.

Stock reference configs build bias-free convs (v1.gin:33-34, included by
every stock config), as the port's v2 family.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np


def _effective_weight(v: np.ndarray, g: np.ndarray) -> np.ndarray:
    """Undo torch weight_norm: w = g * v / ||v||, with the norm taken over
    every axis where g broadcasts (size 1)."""
    axes = tuple(i for i, s in enumerate(g.shape) if s == 1)
    norm = np.sqrt((v.astype(np.float64) ** 2).sum(axis=axes, keepdims=True))
    return (g * v / norm).astype(np.float32)


def _decompose(w_kio: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Split an effective [k, in, out] kernel into this framework's (v, g)
    so that g * v / ||v|| == w exactly (g = per-out-channel L2 norm)."""
    norm = np.sqrt(
        (w_kio.astype(np.float64) ** 2).sum(axis=(0, 1), keepdims=True) + 1e-12
    )
    return w_kio.astype(np.float32), norm.astype(np.float32)


# AdaIN runtime statistics (reference rave/blocks.py:863-926): inference-
# time state learned by the artifact's attributes, not trained weights —
# a migrated model starts them fresh (zeros/ones) like a new export.
_ADAIN_STATE = (
    "mean_x", "std_x", "learn_x", "num_update_x",
    "mean_y", "std_y", "learn_y", "num_update_y",
)


def _group_convs(sd: Mapping[str, np.ndarray]) -> Dict[str, dict]:
    """Group state_dict entries by module path; each group holds the
    weight(_v/_g)/bias tensors of one conv (or a Snake alpha)."""
    groups: Dict[str, dict] = {}
    for key, val in sd.items():
        path, _, leaf = key.rpartition(".")
        if leaf in ("weight_v", "weight_g", "weight", "bias", "alpha"):
            groups.setdefault(path, {})[leaf] = np.asarray(val)
        elif leaf.startswith(("weight_ih_l", "weight_hh_l", "bias_ih_l",
                              "bias_hh_l")):
            groups.setdefault(path, {})[leaf] = np.asarray(val)
        elif leaf in ("running_mean", "running_var"):
            groups.setdefault(path, {})[leaf] = np.asarray(val)
        elif leaf in _ADAIN_STATE or leaf in (
            "target_size", "gru_state", "num_batches_tracked",
            "warmed_up", "enabled",
        ):
            continue  # runtime stats / derived constants
        else:
            raise NotImplementedError(
                f"unsupported reference parameter '{key}'"
            )
    return groups


def _import_gru(grp: dict, our_path: Tuple[str, ...], out: dict):
    """torch nn.GRU (packed [3H, *] r|z|n gates, separate i/h biases) ->
    flax GRUCell dense layers. Identical recurrences; torch's additive
    b_ir + b_hr folds into the single flax input bias (rave/blocks.py GRU
    at 295-319)."""
    n_layers = 1 + max(
        int(k.rsplit("l", 1)[1]) for k in grp if k.startswith("weight_ih_l")
    )
    for layer in range(n_layers):
        w_ih = np.asarray(grp[f"weight_ih_l{layer}"], np.float32)
        w_hh = np.asarray(grp[f"weight_hh_l{layer}"], np.float32)
        hidden = w_hh.shape[1]
        b_ih = np.asarray(
            grp.get(f"bias_ih_l{layer}", np.zeros(3 * hidden)), np.float32
        )
        b_hh = np.asarray(
            grp.get(f"bias_hh_l{layer}", np.zeros(3 * hidden)), np.float32
        )
        r, z, n = slice(0, hidden), slice(hidden, 2 * hidden), slice(
            2 * hidden, 3 * hidden
        )
        base = our_path + (f"rnn_{layer}", "cell")
        _set_leaf(out, base + ("ir", "kernel"), w_ih[r].T.copy())
        _set_leaf(out, base + ("ir", "bias"), b_ih[r] + b_hh[r])
        _set_leaf(out, base + ("iz", "kernel"), w_ih[z].T.copy())
        _set_leaf(out, base + ("iz", "bias"), b_ih[z] + b_hh[z])
        _set_leaf(out, base + ("in", "kernel"), w_ih[n].T.copy())
        _set_leaf(out, base + ("in", "bias"), b_ih[n].copy())
        _set_leaf(out, base + ("hr", "kernel"), w_hh[r].T.copy())
        _set_leaf(out, base + ("hz", "kernel"), w_hh[z].T.copy())
        _set_leaf(out, base + ("hn", "kernel"), w_hh[n].T.copy())
        _set_leaf(out, base + ("hn", "bias"), b_hh[n].copy())


def _translate_path(torch_path: str) -> Tuple[str, ...]:
    """Reference module path -> flax param path, e.g.
    'net.3.aligned.branches.0.net.1' -> ('net','layers_3','inner','net',
    'layers_1'). Three structural rules cover the v1 family's deeper
    nesting (ResidualStack -> ResidualBlock -> ResidualLayer -> Residual,
    reference blocks.py:48-164):
      * the Residual wrapper's 'aligned.branches.0' is 'inner' here;
      * a ResidualStack's AlignBranches is named 'net' there, 'aligned'
        here;
      * a ResidualBlock's sequential is flattened here (its 'net.{j}'
        drops the container — the lookahead keeps NoiseGenerator's
        leaf-level 'net.{j}' convs intact)."""
    import re

    s = torch_path.replace("aligned.branches.0", "inner")
    s = re.sub(r"(^|\.)net\.branches\.", r"\1aligned.branches.", s)
    s = re.sub(r"(branches\.\d+)\.net\.(\d+)(?=\.net\.)", r"\1.\2", s)
    parts = s.split(".")
    out = []
    i = 0
    while i < len(parts):
        p = parts[i]
        if i + 1 < len(parts) and parts[i + 1].isdigit():
            if p == "branches":
                out.append(f"branches_{parts[i + 1]}")
            else:
                out.append(p)
                out.append(f"layers_{parts[i + 1]}")
            i += 2
        elif p.isdigit():
            out.append(f"layers_{p}")
            i += 1
        else:
            out.append(p)
            i += 1
    return tuple(out)


def _leaf(tree: Mapping, path: Tuple[str, ...]):
    node = tree
    for p in path:
        if not isinstance(node, Mapping) or p not in node:
            return None
        node = node[p]
    return node


def _set_leaf(tree: dict, path: Tuple[str, ...], value):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def import_module_state(
    sd: Mapping[str, np.ndarray], template: Mapping,
    batch_stats: dict = None,
) -> dict:
    """Map one reference module's state_dict (e.g. an EncoderV2's) onto a
    same-architecture flax param subtree `template`. Returns a new tree
    with every leaf replaced by the imported weights; raises on any
    unmatched parameter (no silent partial imports). BatchNorm running
    stats (v1 family) are written into `batch_stats` when given."""
    out: dict = {}
    max_net_idx = -1
    for path in _group_convs(sd):
        if path.startswith("net.") and path.split(".")[1].isdigit():
            max_net_idx = max(max_net_idx, int(path.split(".")[1]))

    for path, grp in _group_convs(sd).items():
        # noise-equipped generators split waveform/noise off `net`
        # (reference blocks.py:684-691); here they are the AlignBranches
        # pair `synth/branches_0` (waveform) and `synth/branches_1` (noise)
        if path == "waveform_module":
            our_path = ("synth", "branches_0")
        elif path.startswith("noise_module."):
            our_path = ("synth", "branches_1") + _translate_path(
                path[len("noise_module.") :]
            )
        else:
            our_path = _translate_path(path)
        # the reference appends the generator's waveform conv to `net`;
        # here it is the separate `waveform` submodule
        if (
            _leaf(template, our_path) is None
            and path == f"net.{max_net_idx}"
            and "waveform" in template
        ):
            our_path = ("waveform",)
        if any(k.startswith("weight_ih_l") for k in grp):
            # the reference wraps nn.GRU in a module named `gru`; here the
            # rnn layers sit directly on the recurrent block
            if our_path and our_path[-1] == "gru" and (
                _leaf(template, our_path) is None
            ):
                our_path = our_path[:-1]
            _import_gru(grp, our_path, out)
            continue

        target = _leaf(template, our_path)
        if target is None:
            raise KeyError(
                f"reference module '{path}' has no counterpart at "
                f"{'/'.join(our_path)} in the target architecture — "
                f"config mismatch?"
            )

        if "running_mean" in grp:  # v1 BatchNorm -> bn/{scale,bias} + stats
            bn_path = our_path + ("bn",)
            tgt = _leaf(template, bn_path)
            if tgt is None:
                raise KeyError(
                    f"BatchNorm '{path}' has no counterpart at "
                    f"{'/'.join(bn_path)}"
                )
            _set_leaf(out, bn_path + ("scale",),
                      np.asarray(grp["weight"], np.float32))
            _set_leaf(out, bn_path + ("bias",),
                      np.asarray(grp["bias"], np.float32))
            if batch_stats is not None:
                _set_leaf(batch_stats, bn_path + ("mean",),
                          np.asarray(grp["running_mean"], np.float32))
                _set_leaf(batch_stats, bn_path + ("var",),
                          np.asarray(grp["running_var"], np.float32))
            continue
        if set(grp) == {"alpha"}:  # Snake activation [dim, 1] -> [dim]
            a = np.asarray(grp["alpha"], np.float32).reshape(
                np.shape(target["alpha"])
            )
            _set_leaf(out, our_path + ("alpha",), a)
            continue
        if "weight_v" in grp:
            w = _effective_weight(grp["weight_v"], grp["weight_g"])
        else:
            w = np.asarray(grp["weight"], np.float32)
        # torch conv [out, in, k] vs transposed conv [in, out, k]; ours is
        # [k, in, out] either way. Decide by matching the template shape
        # (transposed convs never have in == out in this architecture).
        tshape = tuple(
            target["v"].shape if "v" in target else target["w"].shape
        )
        conv_w = np.transpose(w, (2, 1, 0))
        tconv_w = np.transpose(w, (2, 0, 1))
        if conv_w.shape == tshape:
            w_kio = conv_w
        elif tconv_w.shape == tshape:
            w_kio = tconv_w
        else:
            raise ValueError(
                f"'{path}': weight {w.shape} fits neither conv nor "
                f"transposed-conv layout of target {tshape}"
            )

        leafs: dict = {}
        if "v" in target:
            v, g = _decompose(w_kio)
            leafs["v"], leafs["g"] = v, g
        else:
            leafs["w"] = w_kio
        if "bias" in grp:
            if "b" not in target:
                raise ValueError(
                    f"'{path}' carries a bias but the target conv is "
                    f"bias-free (stock reference configs bind "
                    f"cc.Conv1d.bias=False via v1.gin)"
                )
            leafs["b"] = np.asarray(grp["bias"], np.float32)
        elif "b" in target:
            leafs["b"] = np.zeros(target["b"].shape, np.float32)
        for name, val in leafs.items():
            if name in target and tuple(target[name].shape) != val.shape:
                raise ValueError(
                    f"'{path}.{name}': shape {val.shape} != target "
                    f"{tuple(target[name].shape)}"
                )
            _set_leaf(out, our_path + (name,), val)
    return out


def import_rvq_state(
    sd: Mapping[str, np.ndarray], codebook_template: Mapping
) -> dict:
    """Map a reference ResidualVectorQuantization state_dict (keys
    `layers.{i}._codebook.{inited,cluster_size,embed,embed_avg}`,
    rave/quantization.py:59-181) onto this framework's `codebook`
    collection (`vq_{i}/codebook/...`, same [K, D] orientation)."""
    out: dict = {}
    for key, val in sd.items():
        parts = key.split(".")
        if (
            len(parts) == 4
            and parts[0] == "layers"
            and parts[2] == "_codebook"
        ):
            i, leaf = parts[1], parts[3]
            path = (f"vq_{i}", "codebook", leaf)
            tgt = _leaf(codebook_template, path)
            if tgt is None:
                raise KeyError(
                    f"rvq '{key}' has no counterpart at {'/'.join(path)}"
                )
            _set_leaf(
                out, path,
                np.asarray(val, np.float32).reshape(np.shape(tgt)),
            )
        else:
            raise NotImplementedError(
                f"unsupported rvq parameter '{key}' (projected codebooks "
                f"are not used by the reference's stock configs)"
            )
    return out


def import_reference_checkpoint(
    state_dict: Mapping[str, np.ndarray], params_template: Mapping,
    buffers_template: Mapping, codebook_template: Mapping = None,
) -> Tuple[dict, dict, dict, dict]:
    """Full-checkpoint entry: split a reference RAVE state_dict (the
    `.ckpt`'s `state_dict` with the `model.` Lightning prefix stripped if
    present) into encoder/decoder subtrees, the latent buffers, the RVQ
    codebooks (discrete models), and BatchNorm running stats (v1 models).

    Returns (params, buffers, codebook-or-None, batch_stats-or-None)
    matching this framework's {'encoder': {'encoder': ...}, 'decoder': ...}
    layout. PQMF / discriminator / audio-distance entries are skipped
    (derived or training-only)."""
    enc_sd, dec_sd, rvq_sd = {}, {}, {}
    buffers = dict(buffers_template)
    for key, val in state_dict.items():
        k = key[len("model.") :] if key.startswith("model.") else key
        if k.startswith("encoder.encoder."):
            enc_sd[k[len("encoder.encoder.") :]] = val
        elif k.startswith("encoder.rvq."):
            rvq_sd[k[len("encoder.rvq.") :]] = val
        elif k.startswith("decoder."):
            dec_sd[k[len("decoder.") :]] = val
        elif k in ("latent_pca", "latent_mean", "fidelity"):
            buffers[k] = np.asarray(val, np.float32)
        # pqmf.* (derived filters), discriminator.*, audio_distance.*
        # (STFT windows), encoder.warmed_up/enabled (static flags here),
        # receptive_field: not imported

    enc_bs, dec_bs = {}, {}
    params = {
        "encoder": {
            "encoder": import_module_state(
                enc_sd, params_template["encoder"]["encoder"],
                batch_stats=enc_bs,
            )
        },
        "decoder": import_module_state(
            dec_sd, params_template["decoder"], batch_stats=dec_bs
        ),
    }
    batch_stats = None
    if enc_bs or dec_bs:
        batch_stats = {}
        if enc_bs:
            batch_stats["encoder"] = {"encoder": enc_bs}
        if dec_bs:
            batch_stats["decoder"] = dec_bs
    codebook = None
    if rvq_sd:
        if codebook_template is None:
            raise ValueError(
                "checkpoint carries RVQ codebooks but no codebook template "
                "was given — is the config a discrete preset?"
            )
        codebook = {
            "encoder": {
                "rvq": import_rvq_state(
                    rvq_sd, codebook_template["encoder"]["rvq"]
                )
            }
        }
    return params, buffers, codebook, batch_stats


def load_reference_state(model, state_dict: Mapping[str, np.ndarray]) -> None:
    """Load a reference RAVE state dict (`model.`-prefixed or not) into the
    port `model`, strictly: every reference tensor lands on the template
    `to_jax_variables(model)` gives (or raises), and every port parameter
    and persistent buffer is set (AdaIN's runtime state and the buffers the
    checkpoint lacks keep the model's)."""
    from rave_tpu_torch.utils.convert import from_jax_variables, to_jax_variables

    template = to_jax_variables(model)
    params, buffers, codebook, batch_stats = import_reference_checkpoint(
        state_dict, template["params"], template.get("buffers", {}), template.get("codebook"))
    variables = {"params": params, "buffers": buffers, "adain": template.get("adain", {})}
    if codebook is not None:
        variables["codebook"] = codebook
    if batch_stats is not None:
        variables["batch_stats"] = batch_stats
    from_jax_variables(model, variables)


def read_reference_checkpoint(path: str, ema_weights: bool = False) -> Dict[str, np.ndarray]:
    """A reference `.ckpt`'s `state_dict` as numpy arrays, with the EMA
    callback's shadow weights (`ckpt["callbacks"]["EMA"]`, reference
    scripts/export.py:507-511) in place of the live ones when
    `ema_weights`; raises SystemExit when it has none."""
    import torch

    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    if ema_weights:
        ema = ckpt.get("callbacks", {}).get("EMA")
        if not ema:
            raise SystemExit("checkpoint has no EMA callback state")
        sd = {**sd, **ema}
    return {k: v.numpy() for k, v in sd.items() if hasattr(v, "numpy")}
