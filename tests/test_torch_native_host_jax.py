"""The port's native artifact host against rave_tpu's artifact, where a step draws nothing.

A discrete artifact's `encode` (its latents are the RVQ code indices,
rave_tpu_torch/export/artifact.py::post_process_latent) and a wasserstein
one's draw nothing, so the host streaming them is held to rave_tpu's
artifact streaming the same blocks on the same weights, within the serving
path's 1e-4 (tests/test_torch_stream_graph.py), and to the port's Python
artifact bit for bit. The two packages' artifacts come from one JAX train
state, the port's weights bridged by `from_jax_variables`. The host is
built and run as in tests/test_torch_native_host.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rave_tpu import config as jax_config
from rave_tpu.export.artifact import ExportedRAVE as JaxExportedRAVE
from rave_tpu.export.export import export_model as jax_export_model
from rave_tpu.factory import build_discriminator as jax_build_discriminator
from rave_tpu.factory import build_rave as jax_build_rave
from rave_tpu.train.state import create_train_state as jax_create_train_state
from rave_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from rave_tpu_torch import config
from rave_tpu_torch.export.artifact import ExportedRAVE
from rave_tpu_torch.export.export import export_model
from rave_tpu_torch.train.state import create_train_state
from rave_tpu_torch.utils.checkpoint import save_checkpoint
from rave_tpu_torch.utils.convert import from_jax_variables
from tests.test_torch_native_host import (  # noqa: F401 (fixtures)
    MODEL_TOL, N_SIGNAL, host, python_stream, rel_err, run_host, signal, two_torch_threads,
    wav_blocks, write_wav,
)

TINY_FAMILY = ["capacity=2", "discriminator.capacity=2", "latent_size=4", "ratios=[4,4,2]",
               "dilations=[[1],[1],[1]]", "latent.num_quantizers=3", "latent.codebook_size=16",
               "latent.noise_augmentation=2"]
FAMILIES = {"discrete": ["discrete"], "wasserstein": ["v2", "wasserstein"]}


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    """Both packages' discrete and wasserstein streaming artifacts from one
    JAX train state (the port's weights bridged by `from_jax_variables`)."""
    root = tmp_path_factory.mktemp("host_families")
    out = {}
    for family, names in FAMILIES.items():
        jcfg = jax_config.compose(names, TINY_FAMILY)
        jcfg.data.n_signal = N_SIGNAL
        state = jax_create_train_state(jcfg, jax_build_rave(jcfg, train=True),
                                       jax_build_discriminator(jcfg), jax.random.key(1),
                                       n_signal=N_SIGNAL)
        jax_run = root / f"jax_{family}"
        jax_run.mkdir()
        (jax_run / "config.json").write_text(jax_config.snapshot(jcfg))
        jax_save_checkpoint(str(jax_run), 1, jax.device_get(state))
        cfg = config.compose(names, TINY_FAMILY)
        cfg.data.n_signal = N_SIGNAL
        pstate = create_train_state(cfg, device="cpu")
        from_jax_variables(pstate.model, jax.tree_util.tree_map(np.asarray, {
            "params": state.gen_params,
            **{k: v for k, v in state.model_state.items() if k != "cache"}}))
        run = root / f"port_{family}"
        run.mkdir()
        (run / "config.json").write_text(config.snapshot(cfg))
        save_checkpoint(str(run), pstate)
        out[family] = (jax_export_model(run=str(jax_run), streaming=True,
                                        output=str(root / f"jax_art_{family}")),
                       export_model(run=str(run), streaming=True,
                                    output=str(root / f"port_art_{family}"), device="cpu"))
    return out


@pytest.mark.parametrize("family", list(FAMILIES))
def test_encode_matches_jax(host, families, family, tmp_path):
    """A step that draws nothing: the host's streaming encode within 1e-4 of
    rave_tpu's artifact streaming the same blocks, and bit-equal to the
    port's Python artifact."""
    jpath, ppath = families[family]
    theirs, mine = JaxExportedRAVE(jpath), ExportedRAVE(ppath, device="cpu")
    B, L = mine.block_size, mine.latent_size
    x = signal(4 * B, 2)
    run_host(host, ppath, "encode", write_wav(tmp_path / "in.wav", x), tmp_path / "z.f32", 3)
    z = np.fromfile(tmp_path / "z.f32", np.float32).reshape(-1, L)
    want = np.concatenate([np.asarray(theirs.encode(jnp.asarray(x[i * B:(i + 1) * B, None]
                                                                [None]), streaming=True))[0]
                           for i in range(4)])
    assert z.shape == want.shape and rel_err(z, want) <= MODEL_TOL
    if family == "discrete":  # the code indices, as floats
        assert np.all(z == np.round(z)) and z.max() < 16
    mine_z = torch.cat(python_stream(mine, "encode", wav_blocks(x, B, 4), 3), -1)[0].T.numpy()
    np.testing.assert_array_equal(z, mine_z)
