"""`export_onnx`: rave_tpu_torch against rave_tpu on the CPU.

The port keeps its own copies of the JAX package's numpy-only ONNX writer,
builder and interpreter (rave_tpu_torch/export/onnx_proto.py, onnx_graph.py,
onnx_run.py): the same graph written by both gives equal bytes, and both
interpreters give equal outputs on one model. `export_onnx_model` of the
port, from the port's modules, against the JAX exporter on the same weights
(`from_jax_variables`), for `onnx` (v1 without the noise synth, BatchNorm
with scrambled running statistics) and for v2 without it, centered and
causal: the same node list (op, inputs, outputs, attributes), every
initializer within 1e-6 of JAX's (INIT_TOL), the interpreter's output
within 1e-5 (RUN_TOL) deterministically and with the JAX test's sampling
noise, at two lengths; the port's own graph against the live port model
within 1e-4 (VERIFY_TOL, the command's `--verify` bound) when centered (the
graph's PQMF is the centered one in both packages, so a causal model's
`.onnx` is not its live forward: ROADMAP C17). Refusals: both
exporters raise NotImplementedError for the same configurations. Then
`cli export_onnx --verify --device cpu` on tiny port runs.
"""
import io
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rave_tpu import config as jax_config
from rave_tpu.export import onnx_graph as jax_graph
from rave_tpu.export import onnx_proto as jax_proto
from rave_tpu.export import onnx_run as jax_run
from rave_tpu.export.onnx_export import export_onnx_model as jax_export_onnx
from rave_tpu.factory import build_rave as jax_build_rave
from rave_tpu_torch import cli, config
from rave_tpu_torch.export import onnx_graph, onnx_proto, onnx_run
from rave_tpu_torch.export.onnx_export import export_onnx_model
from rave_tpu_torch.factory import build_rave
from rave_tpu_torch.train.state import create_train_state
from rave_tpu_torch.utils.checkpoint import save_checkpoint
from rave_tpu_torch.utils.convert import from_jax_variables
from tests.test_torch_v1 import scramble_stats
from tests.test_torch_variants import rel_err

INIT_TOL, RUN_TOL, VERIFY_TOL = 1e-6, 1e-5, 1e-4
TINY = ["capacity=4", "latent_size=4", "n_band=4", "ratios=[4,2]"]
V2_TINY = TINY + ["dilations=[[1,3],[1]]", "discriminator.capacity=2"]
CASES = {"onnx": (["onnx"], TINY), "onnx-causal": (["onnx", "causal"], TINY),
         "v2": (["v2"], V2_TINY), "v2-snake": (["v2", "snake"], V2_TINY)}


def _graph(mod_graph, mod_proto):
    """A graph that touches every builder op, from a module pair."""
    rng = np.random.default_rng(0)
    b = mod_graph.Builder("probe")
    x = b.add_input("audio_in", (1, 4, "n"))
    y = b.conv1d(x, rng.standard_normal((3, 4, 6)).astype(np.float32), np.ones(6, np.float32),
                 stride=2, dilation=1, pads=(1, 1), hint="c")
    y = b.batch_norm(y, np.ones(6), np.zeros(6), rng.standard_normal(6), np.ones(6) * 2)
    y = b.leaky_relu(b.conv_transpose1d(y, rng.standard_normal((4, 6, 4)).astype(np.float32),
                                        None, ratio=2, crop=1))
    y = b.slice_channels(b.mul_const(b.add_const(y, 0.5), 2.0), 0, 3)
    y = b.reshape(b.transpose(y, (0, 2, 1)), (1, -1, 3))
    b.nodes.append(mod_proto.node("Identity", [y], ["audio_out"]))
    b.add_output("audio_out", (1, "m", 3))
    return b.build(doc="probe")


def test_writers_give_equal_bytes():
    assert _graph(onnx_graph, onnx_proto) == _graph(jax_graph, jax_proto)
    tensor = np.arange(12, dtype=np.float32).reshape(3, 4)
    assert onnx_proto.tensor_proto("t", tensor) == jax_proto.tensor_proto("t", tensor)


class Pair:
    """A case's model in both packages, the JAX weights (and running
    statistics) in the port, both in eval mode."""

    def __init__(self, case):
        names, overrides = CASES[case]
        self.cfg, self.jcfg = config.compose(names, overrides), jax_config.compose(names,
                                                                                   overrides)
        self.jax_model = jax_build_rave(self.jcfg, train=False)
        x0 = jnp.zeros((1, self.cfg.block_size() * 2, 1), jnp.float32)
        variables = jax.jit(self.jax_model.init)(
            {"params": jax.random.key(0), "noise": jax.random.key(1)}, x0)
        self.variables = {k: v for k, v in variables.items() if k != "cache"}
        if "batch_stats" in variables:
            self.variables["batch_stats"] = scramble_stats(variables["batch_stats"])
        self.model = build_rave(self.cfg, seed=3, device="cpu")
        from_jax_variables(self.model, self.variables)
        self.model.eval()


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    return Pair(request.param)


def _signal(n, seed=0):
    return (np.random.default_rng(seed).standard_normal((1, 1, n)) * 0.3).astype(np.float32)


def test_interpreters_give_equal_outputs(pair):
    data = jax_export_onnx(pair.jcfg, pair.variables, deterministic=False)
    x = _signal(pair.cfg.n_band * 256)
    a = onnx_run.run(data, {"audio_in": x}, seed=4)["audio_out"]
    b = jax_run.run(data, {"audio_in": x}, seed=4)["audio_out"]
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("deterministic", [True, False], ids=["mean", "sampling"])
def test_graph_matches_jax(pair, deterministic):
    mine = onnx_proto.decode_model(export_onnx_model(pair.cfg, pair.model,
                                                     deterministic=deterministic)).graph
    theirs = jax_proto.decode_model(jax_export_onnx(pair.jcfg, pair.variables,
                                                    deterministic=deterministic)).graph
    assert [(n.op_type, n.inputs, n.outputs, n.attrs) for n in mine.nodes] == \
        [(n.op_type, n.inputs, n.outputs, n.attrs) for n in theirs.nodes]
    assert mine.inputs == theirs.inputs and mine.outputs == theirs.outputs
    assert set(mine.initializers) == set(theirs.initializers)
    for name, t in theirs.initializers.items():
        got = mine.initializers[name]
        assert got.dims == t.dims and got.data_type == t.data_type, name
        assert rel_err(got.array, t.array) <= INIT_TOL, name
    assert ("RandomNormalLike" in {n.op_type for n in mine.nodes}) != deterministic
    if pair.cfg.encoder.kind == "v1":
        assert sum(n.op_type == "BatchNormalization" for n in mine.nodes) == len(pair.cfg.ratios)


@pytest.mark.parametrize("n_frames", [256, 320], ids=["256", "320"])
def test_outputs_match_jax_and_the_live_model(pair, n_frames):
    """The same `.onnx` at two lengths (its audio length is dynamic): the
    port's graph against JAX's in the interpreter, deterministic and on the
    same sampling noise, and against the live port model (the `--verify`
    check)."""
    cfg, model = pair.cfg, pair.model
    x = _signal(cfg.n_band * n_frames, seed=n_frames)
    mine = export_onnx_model(cfg, model, deterministic=True)
    theirs = jax_export_onnx(pair.jcfg, pair.variables, deterministic=True)
    got = onnx_run.run(mine, {"audio_in": x})["audio_out"]
    want = onnx_run.run(theirs, {"audio_in": x})["audio_out"]
    assert got.shape == x.shape and rel_err(got, want) <= RUN_TOL
    with torch.no_grad():
        z = model.encode(torch.from_numpy(x))
        live = model.decode(z[:, : cfg.latent_size]).numpy()
    # the graph's PQMF is the centered one whatever the mode, as the JAX
    # exporter writes it: a causal model's `.onnx` is not its live forward (C17)
    err = np.abs(got - live).max()
    assert err < VERIFY_TOL if cfg.mode == "centered" else err > VERIFY_TOL

    noise = np.random.default_rng(1).standard_normal(
        (1, cfg.latent_size, x.shape[-1] // cfg.decimation())).astype(np.float32)
    sampled = [onnx_run.run(export(c, m, deterministic=False), {"audio_in": x},
                            noise=noise)["audio_out"]
               for export, c, m in ((export_onnx_model, cfg, model),
                                    (jax_export_onnx, pair.jcfg, pair.variables))]
    assert rel_err(sampled[0], sampled[1]) <= RUN_TOL
    assert rel_err(sampled[0], got) > 1e-3  # the sampling acts


@pytest.mark.parametrize("names,overrides", [
    (["v1"], TINY),  # the noise synth
    (["v2", "noise"], V2_TINY + ["decoder.noise_ratios=[4,2]"]),
    (["v2", "wasserstein"], V2_TINY),  # a non-variational family
    (["v2_nopqmf"], ["capacity=4", "encoder.ratios=[4,2]", "decoder.ratios=[16,8]",
                     "dilations=[[1],[1]]"]),  # raw output
    (["onnx"], TINY + ["encoder.recurrent_layers=1"]),  # a GRU
    (["v2"], V2_TINY + ["decoder.recurrent_layers=1"]),
    (["v2", "adain"], V2_TINY),
    (["onnx"], TINY + ["decoder.loud_stride=2"]),
    (["onnx"], TINY + ["encoder.repeat_layers=2"]),
], ids=["v1-noise", "v2-noise", "wasserstein", "raw-output", "encoder-gru", "decoder-gru",
        "adain", "loud-stride", "repeat-layers"])
def test_refusals_match_jax(names, overrides):
    cfg, jcfg = config.compose(names, overrides), jax_config.compose(names, overrides)
    model = build_rave(cfg, device="cpu").eval()
    with pytest.raises(NotImplementedError) as mine:
        export_onnx_model(cfg, model)
    with pytest.raises(NotImplementedError) as theirs:
        jax_export_onnx(jcfg, {"params": {}})
    def reason(e):
        return str(e.value).split("scope): ")[1].split(". Use")[0]

    assert reason(mine) == reason(theirs)


def _cli(args):
    out = io.StringIO()
    with redirect_stdout(out):
        code = cli.main([str(a) for a in args])
    return code, out.getvalue()


@pytest.mark.parametrize("case", ["onnx", "v2"])
def test_cli_export_onnx_verify(tmp_path, case):
    """`cli export_onnx --verify --device cpu` on a port run: the `.onnx` is
    written and holds the run's weights, and the verify passes; without the
    scope (the noise synth) it writes nothing and says why."""
    names, overrides = CASES[case]
    cfg = config.compose(names, overrides)
    st = create_train_state(cfg, seed=1, device="cpu")
    run = tmp_path / "run"
    run.mkdir()
    (run / "config.json").write_text(config.snapshot(cfg))
    save_checkpoint(str(run), st)
    code, out = _cli(["export_onnx", "--run", run, "--output", tmp_path / "onnx", "--verify",
                      "--skip_stablehlo", "--device", "cpu"])
    assert code == 0, out
    path = tmp_path / "onnx" / f"{cfg.name}.onnx"
    assert f"exported: {path}" in out and "verify: max |onnx - live|" in out
    assert float(out.split("verify: max |onnx - live| = ")[1].split()[0]) < VERIFY_TOL
    graph = onnx_proto.decode_model(path.read_bytes()).graph
    want = export_onnx_model(cfg, st.model.eval())
    assert graph.initializers.keys() == onnx_proto.decode_model(want).graph.initializers.keys()

    noisy = tmp_path / "noisy"
    noisy.mkdir()
    ncfg = config.compose(["v1"], TINY)
    (noisy / "config.json").write_text(config.snapshot(ncfg))
    save_checkpoint(str(noisy), create_train_state(ncfg, device="cpu"))
    code, out = _cli(["export_onnx", "--run", noisy, "--output", tmp_path / "none",
                      "--skip_stablehlo", "--device", "cpu"])
    assert code == 0 and "no .onnx for this configuration" in out
    assert not (tmp_path / "none").exists()
