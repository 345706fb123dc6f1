"""The latent prior: rave_tpu_torch.prior against rave_tpu.prior on the CPU.

Tiny widths (latent_size 2-4, resolution 8, res_size 16, skp_size 8, 3-4
layers); inputs from numpy seeds; the JAX prior's params cross into the
port through `from_jax_prior`, the RAVE's through `from_jax_variables`,
both strict. Layouts: the JAX package's [B, T, C], the port's [B, C, T].

Tolerances, relative to the reference's max, fp32:
  * the grouped `Conv1d` against flax's `feature_group_count` conv, offline
    and streamed in chunks: 1e-5 (CONV_TOL);
  * `QuantizedNormal`: the bins equal, the decode with the same dither 1e-6;
    `DiagonalShift` and its inverse equal;
  * `Prior`'s logits 1e-5; its `step` chained over T against its own
    offline logits 1e-5; causality exactly;
  * `prior_loss` with and without `n_real` 1e-5, every gradient leaf 1e-4;
  * one Adam step: the params after it within 1e-5 of optax's;
  * `sample_prediction` on JAX's Gumbel draws picks JAX's indices;
    `generate` over 16 steps gives JAX's one-hots, by argmax and on JAX's
    draws;
  * `encode_latents` on a tiny v2 with the same reparametrization noise:
    1e-4 (the serving path's tolerance).
Then `cli train_prior --smoke_test --device cpu` on a tiny preprocessed
store and a port run: the prior run, its `prior_config.json` (the JAX
`train_prior`'s keys, rave_tpu/prior/train.py:84-94), the latent size the
fidelity curve gives, a checkpoint that restores the prior and its Adam,
and `--config` (a gin file) refused, naming ROADMAP A19.
"""
import inspect
import io
import json
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy.io import wavfile

from rave_tpu import config as jax_config
from rave_tpu.factory import build_rave as jax_build_rave
from rave_tpu.nn.conv import Conv1d as JaxConv1d
from rave_tpu.prior.core import DiagonalShift as JaxShift
from rave_tpu.prior.core import QuantizedNormal as JaxQN
from rave_tpu.prior.model import Prior as JaxPrior
from rave_tpu.prior.model import generate as jax_generate
from rave_tpu.prior.model import prior_loss as jax_prior_loss
from rave_tpu.prior.model import sample_prediction as jax_sample_prediction
from rave_tpu_torch import cli, config
from rave_tpu_torch.factory import build_rave
from rave_tpu_torch.nn.conv import Conv1d
from rave_tpu_torch.nn.streaming import init_stream_state, stream_chunks
from rave_tpu_torch.ops.kernels import dilated_unit
from rave_tpu_torch.prior.core import DiagonalShift, QuantizedNormal
from rave_tpu_torch.prior.model import (
    Prior, build_prior, generate, prior_loss, sample_prediction, split_classes,
)
from rave_tpu_torch.prior.train import encode_latents
from rave_tpu_torch.train.state import create_train_state
from rave_tpu_torch.utils.checkpoint import latest_checkpoint, save_checkpoint
from rave_tpu_torch.utils.convert import convert_tree, from_jax_prior, from_jax_variables

CONV_TOL, QN_TOL, LOGIT_TOL, LOSS_TOL, GRAD_TOL = 1e-5, 1e-6, 1e-5, 1e-5, 1e-4
ADAM_TOL, MODEL_TOL = 1e-5, 1e-4
ARCH = dict(latent_size=4, resolution=8, res_size=16, skp_size=8, n_layers=4)
# the JAX train_prior's prior_config.json (rave_tpu/prior/train.py:84-94)
PRIOR_CONFIG_KEYS = {"vae_run", "latent_size", "resolution", "res_size", "skp_size",
                     "kernel_size", "cycle_size", "n_layers", "fidelity"}
TINY_V2 = ["capacity=2", "latent_size=4", "ratios=[4,4,2]", "dilations=[[1],[1],[1]]",
           "discriminator.capacity=2", "distance.scales=[512,256]"]
FIDELITY = [0.2, 0.4, 0.97, 1.0]  # fidelity 0.95 -> index 2 -> a 2-dimensional prior


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() or 1e-3))


def to_port(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 2, 1)))


def from_port(y):
    return y.detach().numpy().transpose(0, 2, 1)


def one_hots(seed, B, T, D, R):
    """[B, T, D*R] stacked one-hots of seeded bins (the JAX layout)."""
    idx = np.random.default_rng(seed).integers(0, R, (B, T, D))
    return np.asarray(jax.nn.one_hot(idx, R).reshape(B, T, D * R), np.float32)


@pytest.fixture(scope="module")
def priors():
    """The JAX prior at ARCH and the port's with its params."""
    jp = JaxPrior(**ARCH)
    x = one_hots(0, 2, 24, ARCH["latent_size"], ARCH["resolution"])
    params = jp.init({"params": jax.random.key(0)}, jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    port = Prior(**ARCH)
    from_jax_prior(port, params)
    return jp, params, port


# --------------------------------------------------------------------------
# the grouped convolution
# --------------------------------------------------------------------------


@pytest.mark.parametrize("groups,mode,kernel,dilation", [
    (4, "causal", 3, 1), (4, "causal", 3, 2), (2, "centered", 3, 1), (4, "causal", 1, 1)],
    ids=["g4-causal", "g4-causal-d2", "g2-centered", "g4-1x1"])
def test_grouped_conv_matches_flax(groups, mode, kernel, dilation):
    """`Conv1d(groups=)` against flax's `feature_group_count` conv, offline and
    streamed in chunks of 4 frames (the causal stream equals the offline output;
    a centered stream lags it by the conv's delay)."""
    cin, cout, B, T = 8, 12, 2, 20
    jc = JaxConv1d(in_features=cin, features=cout, kernel_size=kernel, dilation=dilation,
                   mode=mode, groups=groups, stream_batch=B)
    x = np.random.default_rng(groups + kernel).standard_normal((B, T, cin)).astype(np.float32)
    variables = jc.init({"params": jax.random.key(1)}, jnp.asarray(x[:, :4]), method="step")
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    assert params["w"].shape == (kernel, cin // groups, cout)
    y_off = np.asarray(jc.apply({"params": params}, jnp.asarray(x)))
    cache = jax.tree_util.tree_map(jnp.zeros_like, variables.get("cache", {}))  # a fresh stream
    ys = []
    for i in range(0, T, 4):
        y, upd = jc.apply({"params": params, "cache": cache}, jnp.asarray(x[:, i:i + 4]),
                          method="step", mutable=["cache"])
        cache = upd.get("cache", {})
        ys.append(np.asarray(y))
    y_st = np.concatenate(ys, axis=1)

    conv = Conv1d(cin, cout, kernel, dilation=dilation, mode=mode, groups=groups,
                  stream_batch=B)
    assert tuple(conv.w.shape) == (cout, cin // groups, kernel)
    from_jax_variables(conv, {"params": params})
    xt = to_port(x)
    with torch.no_grad():
        assert rel_err(from_port(conv(xt)), y_off) <= CONV_TOL
        init_stream_state(conv, B)
        assert rel_err(from_port(stream_chunks(conv, xt, 4)), y_st) <= CONV_TOL


def test_grouped_conv_init_fan_in():
    """lecun-normal per group: the kernel's std is 1 / sqrt(in / groups * K)."""
    conv = Conv1d(512, 512, 3, groups=16)
    conv.reset_parameters(torch.Generator().manual_seed(0))
    assert abs(float(conv.w.std()) * np.sqrt(512 // 16 * 3) - 1.0) < 0.02
    with pytest.raises(ValueError, match="groups"):
        Conv1d(10, 12, 3, groups=4)


# --------------------------------------------------------------------------
# quantizer, shift, model
# --------------------------------------------------------------------------


@pytest.mark.parametrize("resolution", [8, 32])
def test_quantized_normal_matches_jax(resolution):
    rng = np.random.default_rng(resolution)
    x = (rng.standard_normal((2, 16, 3)) * 1.5).astype(np.float32)
    dither = rng.random((2, 16, 3)).astype(np.float32)
    jq, q = JaxQN(resolution), QuantizedNormal(resolution)
    classes = q.encode_classes(to_port(x))
    assert classes.dtype == torch.int64
    np.testing.assert_array_equal(from_port(classes), np.asarray(jq.encode_classes(x)))
    oh = q.encode(to_port(x))
    np.testing.assert_array_equal(from_port(oh), np.asarray(jq.encode(x)))
    # the dither: JAX draws it from its rng inside decode; the port takes it in
    key = jax.random.key(3)
    want = np.asarray(jq.decode(jnp.asarray(from_port(oh)), rng=key))
    jdither = np.asarray(jax.random.uniform(key, (2, 16, 3)))
    assert rel_err(from_port(q.decode(oh, to_port(jdither))), want) <= QN_TOL
    assert rel_err(from_port(q.decode(oh)), np.asarray(jq.decode(jnp.asarray(from_port(oh))))
                   ) <= QN_TOL
    assert rel_err(from_port(q.decode(oh, to_port(dither))),
                   np.asarray(jq.to_normal((np.asarray(jq.encode_classes(x)) + dither)
                                           / resolution))) <= QN_TOL


def test_diagonal_shift_matches_jax():
    x = np.random.default_rng(1).standard_normal((2, 32, 4)).astype(np.float32)
    js, s = JaxShift(), DiagonalShift()
    y = s(to_port(x))
    np.testing.assert_array_equal(from_port(y), np.asarray(js(jnp.asarray(x))))
    np.testing.assert_array_equal(from_port(s.inverse(y)),
                                  np.asarray(js.inverse(js(jnp.asarray(x)))))
    np.testing.assert_array_equal(from_port(s.inverse(y)), x[:, 3:29])


def test_prior_logits_match_jax(priors):
    jp, params, port = priors
    x = one_hots(2, 2, 24, ARCH["latent_size"], ARCH["resolution"])
    want = np.asarray(jp.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = port(to_port(x))
    assert rel_err(from_port(got), want) <= LOGIT_TOL
    assert port.receptive_field == jp.receptive_field == 2 * (1 + 2 + 4 + 8) + 1


def test_prior_stock_width_receptive_field():
    """prior_v1.gin's width: 10 layers, cycle 4 -> 67 frames; D*R = 512 inputs."""
    prior = Prior(16)
    assert prior.receptive_field == 67
    assert tuple(prior.pre_net.layers[0].w.shape) == (512, 32, 3)
    assert tuple(prior.post_net.layers[2].w.shape) == (512, 16, 1)


def test_prior_step_chain_matches_offline_and_is_causal(priors):
    _, _, port = priors
    x = to_port(one_hots(3, 2, 20, ARCH["latent_size"], ARCH["resolution"]))
    with torch.no_grad():
        offline = port(x)
        init_stream_state(port, 2)
        chained = torch.cat([port.step(x[..., t:t + 1]) for t in range(x.shape[-1])], -1)
        assert rel_err(chained.numpy(), offline.numpy()) <= LOGIT_TOL
        x2 = x.clone()
        x2[..., -1] = 0
        assert torch.equal(port(x2)[..., :-1], offline[..., :-1])
        assert not torch.equal(port(x2)[..., -1], offline[..., -1])


@pytest.mark.parametrize("n_real", [None, 2], ids=["all-rows", "n_real"])
def test_prior_loss_and_gradients_match_jax(priors, n_real):
    jp, params, _ = priors
    B = 3 if n_real else 2
    x = one_hots(4, B, 24, ARCH["latent_size"], ARCH["resolution"])
    loss, grads = jax.value_and_grad(
        lambda p: jax_prior_loss(jp, p, jnp.asarray(x), ARCH["latent_size"], n_real=n_real)
    )(jax.tree_util.tree_map(jnp.asarray, params))
    port = Prior(**ARCH)
    from_jax_prior(port, params)
    got = prior_loss(port, to_port(x), ARCH["latent_size"], n_real=n_real)
    got.backward()
    assert abs(got.item() - float(loss)) <= LOSS_TOL * abs(float(loss))
    want = convert_tree(port, jax.tree_util.tree_map(np.asarray, grads))
    assert set(want) == {n for n, _ in port.named_parameters()}
    last = f"res_{ARCH['n_layers'] - 1}.rconv."  # its output feeds nothing: no gradient
    for name, p in port.named_parameters():
        if name.startswith(last):
            assert p.grad is None and not want[name].any(), name
            continue
        assert rel_err(p.grad.numpy(), want[name]) <= GRAD_TOL, name


def test_adam_step_matches_optax(priors):
    """torch.optim.Adam's defaults are optax.adam's (b1, b2, eps; no eps_root),
    and one step of each from the same params and loss agrees."""
    adam = inspect.signature(optax.adam).parameters
    assert (adam["b1"].default, adam["b2"].default, adam["eps"].default,
            adam["eps_root"].default) == (0.9, 0.999, 1e-8, 0.0)
    torch_adam = inspect.signature(torch.optim.Adam).parameters
    assert (torch_adam["betas"].default, torch_adam["eps"].default,
            torch_adam["amsgrad"].default) == ((0.9, 0.999), 1e-8, False)
    jp, params, _ = priors
    x = one_hots(5, 2, 24, ARCH["latent_size"], ARCH["resolution"])
    p0 = jax.tree_util.tree_map(jnp.asarray, params)
    grads = jax.grad(lambda p: jax_prior_loss(jp, p, jnp.asarray(x), ARCH["latent_size"]))(p0)
    tx = optax.adam(1e-4)
    updates, _ = tx.update(grads, tx.init(p0), p0)
    p1 = convert_tree(Prior(**ARCH), jax.tree_util.tree_map(
        np.asarray, optax.apply_updates(p0, updates)))
    port = Prior(**ARCH)
    from_jax_prior(port, params)
    opt = torch.optim.Adam(port.parameters(), lr=1e-4)
    prior_loss(port, to_port(x), ARCH["latent_size"]).backward()
    opt.step()
    for name, p in port.named_parameters():
        assert rel_err(p.detach().numpy(), p1[name]) <= ADAM_TOL, name


def test_sample_prediction_matches_jax_categorical():
    """jax.random.categorical is argmax(logits + gumbel): on JAX's own Gumbel
    draws the port picks JAX's indices."""
    D, R, B, T = 3, 8, 2, 5
    logits = np.random.default_rng(6).standard_normal((B, T, D * R)).astype(np.float32)
    key = jax.random.key(7)
    want = np.asarray(jax_sample_prediction(jnp.asarray(logits), D, R, key))
    gumbel = np.asarray(jax.random.gumbel(key, (B, T, D, R)))  # [B, T, D, R]
    got = sample_prediction(to_port(logits), D, R, torch.from_numpy(
        np.ascontiguousarray(gumbel.transpose(0, 2, 3, 1))))
    np.testing.assert_array_equal(from_port(got), want)
    got_max = sample_prediction(to_port(logits), D, R, argmax=True)
    np.testing.assert_array_equal(
        from_port(got_max), np.asarray(jax_sample_prediction(jnp.asarray(logits), D, R, key,
                                                              argmax=True)))
    assert split_classes(got, D).sum(2).eq(1).all()


@pytest.mark.parametrize("argmax", [True, False], ids=["argmax", "sampled"])
def test_generate_matches_jax(priors, argmax):
    """16 steps from a zero cache: by argmax, and on the Gumbel draws of JAX's
    per-step keys (`jax.random.split(rng, n_steps)`)."""
    jp, params, port = priors
    D, R, n = ARCH["latent_size"], ARCH["resolution"], 16
    x0 = np.zeros((1, 1, D * R), np.float32)
    variables = jp.init({"params": jax.random.key(0)}, jnp.asarray(x0), method="step")
    cache = jax.tree_util.tree_map(jnp.zeros_like, variables["cache"])
    rng = jax.random.key(8)
    want = np.asarray(jax_generate(jp, jax.tree_util.tree_map(jnp.asarray, params), cache,
                                   jnp.asarray(x0), n, rng, argmax=argmax))
    gumbel = None
    if not argmax:
        g = np.stack([np.asarray(jax.random.gumbel(k, (1, 1, D, R)))
                      for k in jax.random.split(rng, n)])  # [n, B, 1, D, R]
        gumbel = torch.from_numpy(np.ascontiguousarray(g.transpose(0, 1, 3, 4, 2)))
    got = generate(port, to_port(x0), n, gumbel=gumbel, argmax=argmax)
    assert got.shape == (1, D * R, n)
    np.testing.assert_array_equal(from_port(got), want)


# --------------------------------------------------------------------------
# the frozen RAVE's latents
# --------------------------------------------------------------------------


def tiny_v2_state():
    """The JAX tiny v2's variables with a random PCA, mean and the FIDELITY curve."""
    jcfg = jax_config.compose(["v2"], TINY_V2)
    jmodel = jax_build_rave(jcfg, n_channels=1, train=False)
    x = jnp.zeros((1, 4096, 1))
    variables = jax.tree_util.tree_map(np.asarray, dict(jmodel.init(
        {"params": jax.random.key(0), "noise": jax.random.key(1)}, x)))
    D = jcfg.latent_size
    r = np.random.default_rng(0)
    variables["buffers"] = {**variables["buffers"],
                            "fidelity": np.asarray(FIDELITY, np.float32),
                            "latent_pca": np.linalg.qr(r.standard_normal((D, D)))[0]
                            .astype(np.float32),
                            "latent_mean": (r.standard_normal(D) * 0.1).astype(np.float32)}
    return jcfg, jmodel, {k: v for k, v in variables.items() if k in ("params", "buffers")}


def test_encode_latents_matches_jax():
    """rave_tpu/prior/train.py:104-118's projection (encoder, reparametrize
    with a given normal draw, centre, PCA, truncate) against the port's on
    the same weights and draw."""
    jcfg, jmodel, variables = tiny_v2_state()
    n = 2
    x = (np.random.default_rng(9).standard_normal((2, 8192, 1)) * 0.1).astype(np.float32)
    rng = jax.random.key(10)

    def run(mdl):  # rave_tpu/prior/train.py:107-116
        z = mdl.encoder(mdl.transform_input(jnp.asarray(x)))
        mean, scale = jnp.split(z, 2, axis=-1)
        std = jax.nn.softplus(scale) + 1e-4
        zs = mean + std * jax.random.normal(rng, mean.shape, mean.dtype)
        bufs = variables["buffers"]
        zs = zs - bufs["latent_mean"]
        zs = zs @ jnp.asarray(bufs["latent_pca"]).T
        return zs[..., :n]

    want = np.asarray(jmodel.apply(variables, rngs={"noise": rng}, method=run))
    eps = np.asarray(jax.random.normal(rng, want.shape[:2] + (jcfg.latent_size,)))
    cfg = config.compose(["v2"], TINY_V2)
    vae = build_rave(cfg, device="cpu").eval()
    from_jax_variables(vae, variables)
    before = dilated_unit.launches
    got = encode_latents(cfg, vae, to_port(x), n, eps=to_port(eps))
    assert dilated_unit.launches == before and not got.requires_grad
    assert got.shape == (2, n, 8192 // cfg.decimation())
    assert rel_err(from_port(got), want) <= MODEL_TOL


# --------------------------------------------------------------------------
# the command
# --------------------------------------------------------------------------


def run_cli(args):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        code = cli.main([str(a) for a in args])
    return code, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def prior_run(tmp_path_factory):
    """A tiny preprocessed store, a port v2 run with a fidelity curve, and
    `cli train_prior --smoke_test` on them."""
    root = tmp_path_factory.mktemp("torch_prior")
    (root / "corpus").mkdir()
    rng = np.random.default_rng(0)
    t = np.arange(20 * 8192) / 44100
    x = 0.3 * np.sin(2 * np.pi * 330 * t) + 0.05 * rng.standard_normal(t.size)
    wavfile.write(root / "corpus" / "a.wav", 44100, (x * 32767).astype(np.int16))
    assert run_cli(["preprocess", "--input_path", root / "corpus", "--output_path", root / "db",
                    "--num_signal", 8192, "--workers", 2])[0] == 0
    _, _, variables = tiny_v2_state()
    cfg = config.compose(["v2"], TINY_V2)
    state = create_train_state(cfg, device="cpu")
    from_jax_variables(state.model, variables)
    vae_run = root / "v2_run"
    vae_run.mkdir()
    (vae_run / "config.json").write_text(config.snapshot(cfg))
    save_checkpoint(str(vae_run), state)
    args = ["train_prior", "--device", "cpu", "--run", vae_run, "--db_path", root / "db",
            "--name", "tiny", "--out_path", root / "priors", "--batch", 2, "--n_signal", 8192,
            "--smoke_test",
            "--resolution", 8, "--res_size", 16, "--skp_size", 8, "--n_layers", 3]
    code, out, err = run_cli(args)
    assert code == 0, err
    return {"root": root, "vae_run": vae_run, "out": out, "args": args,
            "dir": Path(out.strip().splitlines()[-1].removeprefix("prior run dir: "))}


def test_train_prior_smoke(prior_run):
    run_dir = prior_run["dir"]
    assert run_dir == prior_run["root"] / "priors" / "tiny_prior"
    pcfg = json.loads((run_dir / "prior_config.json").read_text())
    assert set(pcfg) == PRIOR_CONFIG_KEYS
    # fidelity 0.95 passes at index 2 of FIDELITY: 2 dimensions (a power of 2)
    assert pcfg == {"vae_run": str(prior_run["vae_run"]), "latent_size": 2, "resolution": 8,
                    "res_size": 16, "skp_size": 8, "kernel_size": 3, "cycle_size": 4,
                    "n_layers": 3, "fidelity": 0.95}
    assert "prior step 1 ce=" in prior_run["out"] and "prior step 2 ce=" in prior_run["out"]
    rows = [json.loads(r) for r in (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2]
    assert all(np.isfinite(r["latent_prediction"]) for r in rows)
    ckpts = sorted(p.name for p in (run_dir / "checkpoints").iterdir())
    assert ckpts == ["step_0000000001.pt", "step_0000000002.pt"]


def test_train_prior_checkpoint_restores(prior_run):
    """The newest checkpoint holds the prior and its Adam after 2 steps, and
    loads into a fresh prior and Adam."""
    ckpt = torch.load(latest_checkpoint(str(prior_run["dir"])), weights_only=True)
    assert ckpt["step"] == 2
    prior = build_prior(2, 8, 16, 8, n_layers=3, seed=5, device="cpu")
    opt = torch.optim.Adam(prior.parameters(), lr=1e-4)
    prior.load_state_dict(ckpt["prior"])
    opt.load_state_dict(ckpt["opt"])
    assert all(torch.equal(v, ckpt["prior"][k]) for k, v in prior.state_dict().items())
    # every parameter with a gradient took both steps (the last block's
    # residual projection feeds nothing, so Adam holds no state for it)
    steps = [float(s["step"]) for s in opt.state_dict()["state"].values()]
    assert steps == [2.0] * (len(ckpt["prior"]) - 2)
    # the trained prior moved from its initial draw (seed 0, as train_prior draws it)
    fresh = build_prior(2, 8, 16, 8, n_layers=3, seed=0, device="cpu").state_dict()
    assert all(torch.equal(v, fresh[k]) == k.startswith("res_2.rconv.")
               for k, v in ckpt["prior"].items() if k.endswith(".w"))


def test_train_prior_gin_config_refused(prior_run, tmp_path):
    """`train_prior --config prior.gin`, refused until the gin reader was
    ported (A19), runs: the file's VariationalPrior bindings (the grammar
    of the reference's configs/prior/prior_v1.gin, read as the JAX
    package's reader reads it) become the architecture, and a flag
    overrides the file."""
    from rave_tpu.config_gin import prior_kwargs_from_gin as jax_prior_kwargs
    from rave_tpu_torch.config_gin import prior_kwargs_from_gin

    gin = tmp_path / "prior_tiny.gin"
    gin.write_text("from __gin__ import dynamic_registration\n"
                   "VariationalPrior.resolution = 8\nVariationalPrior.res_size = 16\n"
                   "VariationalPrior.skp_size = 8\nVariationalPrior.kernel_size = 3\n"
                   "VariationalPrior.cycle_size = 4\nVariationalPrior.n_layers = 4\n"
                   "VariationalPrior.sr = @get_model_sr()\n")
    assert prior_kwargs_from_gin(str(gin)) == jax_prior_kwargs(str(gin))
    base = prior_run["args"][:prior_run["args"].index("--resolution")]
    base[base.index("--name") + 1] = "gin"
    code, out, err = run_cli(base + ["--config", gin, "--n_layers", 3])
    assert code == 0, err
    run_dir = Path(out.strip().splitlines()[-1].removeprefix("prior run dir: "))
    arch = json.loads((run_dir / "prior_config.json").read_text())
    assert {k: arch[k] for k in ("resolution", "res_size", "skp_size", "kernel_size",
                                 "cycle_size", "n_layers")} == {
        "resolution": 8, "res_size": 16, "skp_size": 8, "kernel_size": 3, "cycle_size": 4,
        "n_layers": 3}
    assert len(list((run_dir / "checkpoints").iterdir())) == 2
