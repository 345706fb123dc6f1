"""The portable full graph against the JAX package's, on the CPU.

rave_tpu/export/portable.py writes the offline forward as a StableHLO
module (`jax.export`); rave_tpu_torch/export/portable.py writes it as a
TorchScript program whose residual units are the registered op
`rave_tpu_torch::dilated_unit`. Here the op's CPU implementation is held to
the JAX unit's plain formulation (`_reference_impl`, what the JAX package
runs on the CPU with RAVE_TPU_PALLAS unset and what its kernel's backward
differentiates; layouts transposed), and for a tiny draw-free
`["v2", "wasserstein"]` (no augmentation channels) on the JAX weights
carried across by `utils/convert.py::from_jax_variables`, the port's
`forward.ts` against `jax.export.deserialize` of the JAX package's own
`export_portable` output on the same seeded input: both forwards draw
nothing, so their seeds need not agree.
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rave_tpu import config as jax_config
from rave_tpu.export.portable import export_portable as jax_export_portable
from rave_tpu.factory import build_discriminator as jax_build_discriminator
from rave_tpu.factory import build_rave as jax_build_rave
from rave_tpu.ops.kernels import dilated_unit as jax_unit
from rave_tpu.train.state import create_train_state as jax_create_train_state
from rave_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from rave_tpu_torch import config
from rave_tpu_torch.export.portable import export_portable, load_portable
from rave_tpu_torch.nn.conv import get_padding
from rave_tpu_torch.ops.kernels import unit_op
from rave_tpu_torch.train.state import create_train_state
from rave_tpu_torch.utils.checkpoint import save_checkpoint
from rave_tpu_torch.utils.convert import from_jax_variables

UNIT_TOL, PROGRAM_TOL = 1e-5, 1e-4
TINY = ["capacity=4", "latent_size=4", "n_band=4", "ratios=[4,2]", "dilations=[[1,3],[1]]",
        "discriminator.capacity=2", "latent.noise_augmentation=0"]
N_SIGNAL, BATCH = 8192, 2


def rel_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def op_library():
    return unit_op.load_unit_op()


@pytest.mark.parametrize("mode", ["centered", "causal"])
@pytest.mark.parametrize("d", [1, 3, 9])
@pytest.mark.parametrize("C", [8, 16])
def test_op_matches_jax_unit(op_library, C, d, mode):
    rng = np.random.default_rng(C * 100 + d)
    K, T = 3, 53  # T not a multiple of any tile
    x = rng.standard_normal((BATCH, T, C)).astype(np.float32)
    w1 = (rng.standard_normal((K, C, C)) / np.sqrt(K * C)).astype(np.float32)  # [K, I, O]
    w2 = (rng.standard_normal((C, C)) / np.sqrt(C)).astype(np.float32)        # [I, O]
    left, right = get_padding(K, 1, d, mode)
    want = np.asarray(jax_unit._reference_impl(
        jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w2), d, left, right))
    got = unit_op.unit_op(
        torch.from_numpy(x.transpose(0, 2, 1).copy()),
        torch.from_numpy(w1.transpose(2, 1, 0).copy()),  # [O, I, K]
        torch.from_numpy(w2.T.copy()),                   # [O, I]
        d, left, right,
    ).numpy().transpose(0, 2, 1)
    assert rel_err(got, want) < UNIT_TOL


@pytest.fixture(scope="module")
def programs(tmp_path_factory, op_library):
    """One tiny wasserstein generator in both packages, each exported by its
    own `export_portable` at BATCH x N_SIGNAL."""
    root = tmp_path_factory.mktemp("portable_jax")
    names = ["v2", "wasserstein"]
    jcfg = jax_config.compose(names, TINY)
    state = jax_create_train_state(jcfg, jax_build_rave(jcfg, train=True),
                                   jax_build_discriminator(jcfg), jax.random.key(0),
                                   n_signal=N_SIGNAL)
    jax_run = root / "jax_run"
    jax_run.mkdir()
    (jax_run / "config.json").write_text(jax_config.snapshot(jcfg))
    jax_save_checkpoint(str(jax_run), 1, jax.device_get(state))
    jax_dir = Path(jax_export_portable(str(jax_run), n_signal=N_SIGNAL, batch=BATCH,
                                       output=str(root / "jax")))

    cfg = config.compose(names, TINY)
    pstate = create_train_state(cfg, device="cpu")
    from_jax_variables(pstate.model, {"params": state.gen_params,
                                      "buffers": state.model_state["buffers"]})
    port_run = root / "port_run"
    port_run.mkdir()
    (port_run / "config.json").write_text(config.snapshot(cfg))
    save_checkpoint(str(port_run), pstate)
    port_dir = Path(export_portable(str(port_run), n_signal=N_SIGNAL, batch=BATCH,
                                    output=str(root / "port"), device="cpu"))
    return {"jax": jax_dir, "port": port_dir}


def test_forward_matches_jax_program(programs):
    """The port's `forward.ts` and the JAX package's `forward.stablehlo`, on
    the same weights and the same seeded input (the port's layout is
    channels before time), within 1e-4; neither reads its seed."""
    exp = jax.export.deserialize(bytearray((programs["jax"] / "forward.stablehlo")
                                           .read_bytes()))
    jax_manifest = json.loads((programs["jax"] / "manifest.json").read_text())
    ts, manifest = load_portable(str(programs["port"]), "cpu")
    x = (0.3 * np.random.default_rng(5).standard_normal((BATCH, N_SIGNAL, 1))).astype(
        np.float32)
    want = np.asarray(exp.call(jnp.asarray(x), jnp.uint32(11)))
    with torch.no_grad():
        got = ts(torch.from_numpy(x.transpose(0, 2, 1).copy()),
                 torch.tensor(99, dtype=torch.int64)).numpy().transpose(0, 2, 1)
    assert got.shape == want.shape == (BATCH, N_SIGNAL, 1)
    assert rel_err(got, want) < PROGRAM_TOL
    assert manifest["kept_inputs"] == jax_manifest["kept_inputs"] == [0]
    assert manifest["input"] == [BATCH, 1, N_SIGNAL]
    assert jax_manifest["input"] == [BATCH, N_SIGNAL, 1]
    assert manifest["sampling_rate"] == jax_manifest["sampling_rate"]
    assert manifest["units"] == 6  # dilations [[1, 3], [1]]: 3 units each side
