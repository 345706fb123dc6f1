"""Small ONNX graph-building API on top of the wire codec (onnx_proto).

The port's copy of rave_tpu/export/onnx_graph.py. A `Builder` tracks
nodes, initializers and tensor names: Conv/ConvTranspose carry explicit
asymmetric `pads`, weights are NCW initializers built from kernels in the
JAX package's [K, I/groups, O] layout (export/onnx_export.py turns the
port's kernels into it), activations are single nodes.

All tensors are NCW ([batch, channels, time]) like the reference's ONNX
export (scripts/export_onnx.py emits [1, n_channels, audio_length]).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from rave_tpu_torch.export import onnx_proto as P


class Builder:
    def __init__(self, name: str):
        self.name = name
        self.nodes: List[bytes] = []
        self.initializers: List[bytes] = []
        self.inputs: List[bytes] = []
        self.outputs: List[bytes] = []
        self._n = 0

    # ---- naming ----------------------------------------------------------
    def fresh(self, hint: str) -> str:
        self._n += 1
        return f"{hint}_{self._n}"

    # ---- graph I/O -------------------------------------------------------
    def add_input(self, name: str, shape: Sequence) -> str:
        self.inputs.append(P.value_info(name, P.FLOAT, tuple(shape)))
        return name

    def add_output(self, name: str, shape: Sequence) -> None:
        self.outputs.append(P.value_info(name, P.FLOAT, tuple(shape)))

    def init_tensor(self, hint: str, arr: np.ndarray) -> str:
        name = self.fresh(hint)
        self.initializers.append(P.tensor_proto(name, np.asarray(arr)))
        return name

    def const(self, hint: str, arr: np.ndarray) -> str:
        """Constant via initializer (opset 12 treats initializers as consts)."""
        return self.init_tensor(hint, arr)

    # ---- generic node ----------------------------------------------------
    def op(self, op_type: str, inputs: Sequence[str], n_out: int = 1, **attrs):
        outs = [self.fresh(op_type.lower()) for _ in range(n_out)]
        self.nodes.append(P.node(op_type, list(inputs), outs, **attrs))
        return outs[0] if n_out == 1 else outs

    # ---- common ops ------------------------------------------------------
    def conv1d(
        self,
        x: str,
        w_kio: np.ndarray,
        b: Optional[np.ndarray],
        *,
        stride: int = 1,
        dilation: int = 1,
        pads: Tuple[int, int] = (0, 0),
        groups: int = 1,
        hint: str = "conv",
    ) -> str:
        """NCW Conv from a rave_tpu [K, I/groups, O] kernel."""
        w = np.ascontiguousarray(np.transpose(w_kio, (2, 1, 0)), np.float32)
        ins = [x, self.init_tensor(f"{hint}_w", w)]
        if b is not None:
            ins.append(self.init_tensor(f"{hint}_b", np.asarray(b, np.float32)))
        return self.op(
            "Conv",
            ins,
            kernel_shape=[w.shape[-1]],
            strides=[stride],
            dilations=[dilation],
            pads=list(pads),
            group=groups,
        )

    def conv_transpose1d(
        self,
        x: str,
        w_kio: np.ndarray,
        b: Optional[np.ndarray],
        *,
        ratio: int,
        crop: int,
        hint: str = "tconv",
    ) -> str:
        """NCW ConvTranspose matching rave_tpu ConvTranspose1d offline
        semantics: full transpose then slice [crop : crop + T*ratio]
        == ONNX pads [crop, k - ratio - crop] (nn/conv.py:269-274)."""
        k = w_kio.shape[0]
        w = np.ascontiguousarray(np.transpose(w_kio, (1, 2, 0)), np.float32)
        ins = [x, self.init_tensor(f"{hint}_w", w)]
        if b is not None:
            ins.append(self.init_tensor(f"{hint}_b", np.asarray(b, np.float32)))
        return self.op(
            "ConvTranspose",
            ins,
            kernel_shape=[k],
            strides=[ratio],
            dilations=[1],
            pads=[crop, k - ratio - crop],
            group=1,
        )

    def batch_norm(
        self, x: str, scale, bias, mean, var, eps: float = 1e-5
    ) -> str:
        ins = [
            x,
            self.init_tensor("bn_scale", np.asarray(scale, np.float32)),
            self.init_tensor("bn_bias", np.asarray(bias, np.float32)),
            self.init_tensor("bn_mean", np.asarray(mean, np.float32)),
            self.init_tensor("bn_var", np.asarray(var, np.float32)),
        ]
        return self.op("BatchNormalization", ins, epsilon=eps)

    def leaky_relu(self, x: str, alpha: float = 0.2) -> str:
        return self.op("LeakyRelu", [x], alpha=alpha)

    def add(self, a: str, b: str) -> str:
        return self.op("Add", [a, b])

    def mul(self, a: str, b: str) -> str:
        return self.op("Mul", [a, b])

    def add_const(self, x: str, c) -> str:
        return self.add(x, self.const("c", np.asarray(c, np.float32)))

    def mul_const(self, x: str, c) -> str:
        return self.mul(x, self.const("c", np.asarray(c, np.float32)))

    def reshape(self, x: str, shape: Sequence[int]) -> str:
        s = self.const("shape", np.asarray(shape, np.int64))
        return self.op("Reshape", [x, s])

    def transpose(self, x: str, perm: Sequence[int]) -> str:
        return self.op("Transpose", [x], perm=list(perm))

    def slice_channels(self, x: str, start: int, end: int) -> str:
        return self.op(
            "Slice",
            [
                x,
                self.const("starts", np.asarray([start], np.int64)),
                self.const("ends", np.asarray([end], np.int64)),
                self.const("axes", np.asarray([1], np.int64)),
            ],
        )

    # ---- serialize -------------------------------------------------------
    def build(self, doc: str = "") -> bytes:
        g = P.graph(
            self.nodes, self.name, self.inputs, self.outputs,
            self.initializers, doc=doc,
        )
        return P.model(g, doc=doc)
