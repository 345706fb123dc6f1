"""Multi-layer GRU over [B, C, T] with an offline pass and a streaming step.

PyTorch port of rave_tpu/nn/gru.py (reference rave/blocks.py:295-319: the
optional recurrent layer of the encoder and the generator; causal in both
modes, so its delay is 0). The hidden size equals the input size.

The parameters are flax's `GRUCell`'s, under its names, so that
utils/convert.py maps them by rename: `rnn_<i>.cell.{ir,iz,in_}.{kernel,
bias}`, `rnn_<i>.cell.{hr,hz}.kernel` and `rnn_<i>.cell.hn.{kernel,bias}`,
kernels in flax's [in, out] layout (flax's gate `in` is `in_` here: a
Python keyword cannot name a module in an exported program). The cell is

    r = sigmoid(ir(x) + hr(h)),  z = sigmoid(iz(x) + hz(h)),
    n = tanh(in(x) + r * hn(h)),  h' = (1 - z) * n + z * h,

which is torch's GRU with `bias_hh` = [0, 0, b_hn]. The offline pass runs
all layers in one `torch._VF.gru` call (cuDNN on the card) on weights
assembled from these parameters (the zeros stay zeros: they are not
parameters). The streaming step writes the cell out frame by frame, which
`torch.export` traces into plain ops. Its hidden state, [num_layers, B,
H] in torch's layout, is kept as a stream buffer [B, H, num_layers], so
that `init_stream_state` and the artifact's state (`stream_slots`) carry
it like any other.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from rave_tpu_torch.nn.conv import _TRUNC_STD
from rave_tpu_torch.nn.streaming import StreamingModule, as_dtype


GATE_NAMES = {"in": "in_"}  # flax's gate names the port renames


class _Dense(nn.Module):
    """flax's Dense: `kernel` [in, out], optional `bias` [out]."""

    def __init__(self, features: int, use_bias: bool):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(features, features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None


class _Cell(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        for name, use_bias in (("ir", True), ("iz", True), ("in", True), ("hr", False),
                               ("hz", False), ("hn", True)):
            self.add_module(GATE_NAMES.get(name, name), _Dense(features, use_bias))

    def gate(self, name: str) -> _Dense:
        """The gate flax calls `name`."""
        return getattr(self, GATE_NAMES.get(name, name))

    def torch_weights(self, dtype: torch.dtype) -> Tuple[torch.Tensor, ...]:
        """(w_ih [3H, H], w_hh [3H, H], b_ih [3H], b_hh [3H]) in torch's gate
        order (r, z, n) and `dtype`."""
        g = self.gate
        w_ih = torch.cat([g(n).kernel.t() for n in ("ir", "iz", "in")])
        w_hh = torch.cat([g(n).kernel.t() for n in ("hr", "hz", "hn")])
        b_ih = torch.cat([g(n).bias for n in ("ir", "iz", "in")])
        b_hh = torch.cat([torch.zeros_like(g("hn").bias), torch.zeros_like(g("hn").bias),
                          g("hn").bias])
        return tuple(as_dtype(t, dtype) for t in (w_ih, w_hh, b_ih, b_hh))


class _RNN(nn.Module):
    """flax's `nn.RNN` around its cell (the parameter path's `rnn_<i>/cell`)."""

    def __init__(self, features: int):
        super().__init__()
        self.cell = _Cell(features)


class GRU(StreamingModule):
    """`num_layers` GRU layers over x [B, latent_size, T] (delay 0)."""

    delay = 0

    def __init__(self, latent_size: int, num_layers: int = 1, stream_batch: int = 1):
        super().__init__()
        self.latent_size, self.num_layers = latent_size, num_layers
        for i in range(num_layers):
            self.add_module(f"rnn_{i}", _RNN(latent_size))
        self.add_stream_state("h", latent_size, num_layers, stream_batch)
        self.reset_parameters()

    def cells(self) -> List[_Cell]:
        return [getattr(self, f"rnn_{i}").cell for i in range(self.num_layers)]

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """flax's GRUCell initializers: lecun-normal input kernels, orthogonal
        hidden kernels, zero biases."""
        std = self.latent_size ** -0.5 / _TRUNC_STD
        with torch.no_grad():
            for cell in self.cells():
                for name in ("ir", "iz", "in", "hr", "hz", "hn"):
                    dense = cell.gate(name)
                    if name[0] == "i":
                        nn.init.trunc_normal_(dense.kernel, 0.0, std, -2 * std, 2 * std,
                                              generator=generator)
                    else:
                        nn.init.orthogonal_(dense.kernel, generator=generator)
                    if dense.bias is not None:
                        dense.bias.zero_()

    def _weights(self, dtype: torch.dtype) -> List[torch.Tensor]:
        return [w for cell in self.cells() for w in cell.torch_weights(dtype)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Offline, from a zero state: [B, H, T] -> [B, H, T]."""
        h0 = x.new_zeros(self.num_layers, x.shape[0], self.latent_size)
        y, _ = torch._VF.gru(x.transpose(1, 2), h0, self._weights(x.dtype), True,
                             self.num_layers, 0.0, self.training, False, True)
        return y.transpose(1, 2)

    def step(self, x: torch.Tensor) -> torch.Tensor:
        """Streaming: the cell frame by frame from the carried state."""
        h = as_dtype(self.h, x.dtype).permute(2, 0, 1)  # [L, B, H]
        out, last = x.transpose(1, 2), []
        for layer, cell in enumerate(self.cells()):
            w_ih, w_hh, b_ih, b_hh = cell.torch_weights(x.dtype)
            gi = torch.nn.functional.linear(out, w_ih, b_ih)  # [B, T, 3H], every frame at once
            hl, ys = h[layer], []
            for t in range(out.shape[1]):
                gh = torch.nn.functional.linear(hl, w_hh, b_hh)
                ir, iz, in_ = gi[:, t].chunk(3, dim=-1)
                hr, hz, hn = gh.chunk(3, dim=-1)
                r, z = torch.sigmoid(ir + hr), torch.sigmoid(iz + hz)
                n = torch.tanh(in_ + r * hn)
                hl = (1 - z) * n + z * hl
                ys.append(hl)
            out = torch.stack(ys, dim=1)
            last.append(hl)
        self.h = as_dtype(torch.stack(last, dim=-1), self.h.dtype)
        return out.transpose(1, 2)
