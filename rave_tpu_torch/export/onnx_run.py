"""Minimal ONNX evaluator for the op subset export/onnx_export.py emits.

The port's copy of rave_tpu/export/onnx_run.py (numpy, with torch for the
convolutions on the CPU): it runs an exported `.onnx` where no onnxruntime
is installed, so `cli export_onnx --verify` can compare the file with the
live model, and tests/test_torch_onnx.py holds it equal to the original.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from rave_tpu_torch.export import onnx_proto as P


def run(
    model_bytes: bytes,
    feeds: Dict[str, np.ndarray],
    seed: int = 0,
    noise: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """Evaluate the graph; returns {output_name: array}.

    RandomNormalLike draws from numpy's Generator(seed) unless an explicit
    `noise` array is given (used by the equivalence tests to share noise
    with another package's draws).
    """
    import torch

    m = P.decode_model(model_bytes)
    g = m.graph
    env: Dict[str, np.ndarray] = {}
    for name, t in g.initializers.items():
        env[name] = t.array
    for name, _ in g.inputs:
        if name not in feeds:
            raise ValueError(f"missing input {name}")
        env[name] = np.asarray(feeds[name])
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x))

    for nd in g.nodes:
        i = [env[k] if k else None for k in nd.inputs]
        a = nd.attrs
        op = nd.op_type
        if op == "Conv":
            pads = a.get("pads", [0, 0])
            y = torch.nn.functional.conv1d(
                torch.nn.functional.pad(t(i[0]), (pads[0], pads[1])),
                t(i[1]),
                t(i[2]) if len(i) > 2 else None,
                stride=a.get("strides", [1])[0],
                dilation=a.get("dilations", [1])[0],
                groups=a.get("group", 1),
            ).numpy()
        elif op == "ConvTranspose":
            pads = a.get("pads", [0, 0])
            full = torch.nn.functional.conv_transpose1d(
                t(i[0]), t(i[1]),
                t(i[2]) if len(i) > 2 else None,
                stride=a.get("strides", [1])[0],
            ).numpy()
            end = full.shape[-1] - pads[1]
            y = full[..., pads[0]:end]
        elif op == "BatchNormalization":
            x, sc, bi, me, va = i
            eps = a.get("epsilon", 1e-5)
            y = (x - me[None, :, None]) / np.sqrt(va[None, :, None] + eps)
            y = y * sc[None, :, None] + bi[None, :, None]
        elif op == "LeakyRelu":
            al = a.get("alpha", 0.01)
            y = np.where(i[0] > 0, i[0], al * i[0])
        elif op == "Relu":
            y = np.maximum(i[0], 0)
        elif op == "Tanh":
            y = np.tanh(i[0])
        elif op == "Sin":
            y = np.sin(i[0])
        elif op == "Sigmoid":
            y = 1.0 / (1.0 + np.exp(-i[0]))
        elif op == "Softplus":
            y = np.logaddexp(0.0, i[0])
        elif op == "Pow":
            y = np.power(i[0], i[1])
        elif op == "Mul":
            y = i[0] * i[1]
        elif op == "Add":
            y = i[0] + i[1]
        elif op == "Sub":
            y = i[0] - i[1]
        elif op == "Div":
            y = i[0] / i[1]
        elif op == "Identity":
            y = i[0]
        elif op == "Reshape":
            y = i[0].reshape([int(v) for v in i[1]])
        elif op == "Transpose":
            y = np.transpose(i[0], a["perm"])
        elif op == "Slice":
            starts, ends = i[1], i[2]
            axes = i[3] if len(i) > 3 else list(range(len(starts)))
            sl = [slice(None)] * i[0].ndim
            for s, e, ax in zip(starts, ends, axes):
                sl[int(ax)] = slice(int(s), int(e))
            y = i[0][tuple(sl)]
        elif op == "Shape":
            y = np.asarray(i[0].shape, np.int64)
        elif op == "Gather":
            y = np.take(i[0], i[1], axis=a.get("axis", 0))
        elif op == "Range":
            y = np.arange(int(i[0]), int(i[1]), int(i[2]), dtype=np.int64)
        elif op == "Mod":
            y = np.mod(i[0], i[1])
        elif op == "Cast":
            to = a.get("to", P.FLOAT)
            y = i[0].astype(np.float32 if to == P.FLOAT else np.int64)
        elif op == "Unsqueeze":
            y = i[0]
            for ax in sorted(a["axes"]):
                y = np.expand_dims(y, ax)
        elif op == "Concat":
            y = np.concatenate(i, axis=a.get("axis", 0))
        elif op == "RandomNormalLike":
            if noise is not None:
                y = np.asarray(noise, np.float32).reshape(i[0].shape)
            else:
                y = rng.standard_normal(i[0].shape).astype(np.float32)
        # ---- ops below appear in torch-serialized graphs (the
        # cross-vendor fixture, tests/test_onnx_crossvendor.py) ----------
        elif op == "Constant":
            v = a.get("value")
            y = v.array if hasattr(v, "array") else np.asarray(v)
        elif op == "Split":
            axis = a.get("axis", 0)
            if len(i) > 1 and i[1] is not None:  # opset >= 13: sizes input
                sizes = [int(v) for v in i[1]]
            elif "split" in a:
                sizes = [int(v) for v in a["split"]]
            else:
                sizes = [i[0].shape[axis] // len(nd.outputs)] * len(nd.outputs)
            y = tuple(np.split(i[0], np.cumsum(sizes)[:-1], axis=axis))
        elif op == "Pad":
            mode = a.get("mode", "constant")
            if len(i) > 1 and i[1] is not None:  # opset >= 11: pads input
                pads = [int(v) for v in i[1]]
                cval = float(i[2]) if len(i) > 2 and i[2] is not None else 0.0
            else:
                pads = [int(v) for v in a.get("pads", [])]
                cval = a.get("value", 0.0)
            n = i[0].ndim
            width = [(pads[k], pads[k + n]) for k in range(n)]
            y = np.pad(
                i[0], width,
                mode={"constant": "constant", "reflect": "reflect",
                      "edge": "edge"}[mode],
                **({"constant_values": cval} if mode == "constant" else {}),
            )
        elif op == "Sqrt":
            y = np.sqrt(i[0])
        elif op == "Exp":
            y = np.exp(i[0])
        elif op == "Log":
            y = np.log(i[0])
        elif op == "Neg":
            y = -i[0]
        elif op == "Abs":
            y = np.abs(i[0])
        elif op == "Squeeze":
            axes = a.get("axes")
            if axes is None and len(i) > 1 and i[1] is not None:
                axes = [int(v) for v in i[1]]
            y = np.squeeze(i[0], axis=tuple(axes) if axes else None)
        elif op == "Clip":
            lo = i[1] if len(i) > 1 and i[1] is not None else a.get("min")
            hi = i[2] if len(i) > 2 and i[2] is not None else a.get("max")
            y = np.clip(i[0], lo, hi)
        elif op == "ReduceMean":
            axes = tuple(a.get("axes", range(i[0].ndim)))
            y = np.mean(i[0], axis=axes, keepdims=bool(a.get("keepdims", 1)))
        elif op == "ReduceSum":
            axes = a.get("axes")
            if axes is None and len(i) > 1 and i[1] is not None:
                axes = [int(v) for v in i[1]]
            axes = tuple(axes) if axes else tuple(range(i[0].ndim))
            y = np.sum(i[0], axis=axes, keepdims=bool(a.get("keepdims", 1)))
        elif op == "Expand":
            y = i[0] * np.ones([int(v) for v in i[1]], dtype=i[0].dtype)
        elif op == "ConstantOfShape":
            v = a.get("value")
            fill = v.array.reshape(-1)[0] if hasattr(v, "array") else 0.0
            y = np.full([int(s) for s in i[0]], fill)
        elif op == "Where":
            y = np.where(i[0], i[1], i[2])
        else:
            raise NotImplementedError(f"op {op} not implemented in onnx_run")
        if isinstance(y, tuple):
            for name, val in zip(nd.outputs, y):
                env[name] = np.asarray(val)
        else:
            env[nd.outputs[0]] = np.asarray(y)

    return {name: env[name] for name, _ in g.outputs}
