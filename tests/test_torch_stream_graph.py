"""The served streaming steps (`nn/graphs.py::StepGraphs`) on the CPU, against rave_tpu.

On the card each streaming call of `ExportedRAVE` (and the prior's step,
and `graphed_stream(model)`) replays a CUDA graph over static state
tensors; on the CPU the same step runs eagerly on the same tensors with the
same in-place copy back. These tests hold that discipline here:

  * a tiny v2 generator (the JAX train state's, bridged by
    `from_jax_variables`) exported by both packages, mono at the model's
    rate and stereo at twice it (resampled at both ends, two rows): 8
    streaming blocks of `encode`, `decode` and `forward` with a
    `reset_stream` after the fourth, the JAX artifact's draws injected;
    each block's output and the whole stream state (the model's caches and
    the resampler's) within the serving path's 1e-4 of the JAX artifact's;
  * a tiny v3 artifact likewise, its AdaIN attributes toggled between
    blocks (`set_learn_target`, `set_learn_source`, `reset_target`): the
    outputs, the caches and the AdaIN statistics against the JAX artifact's;
  * `sample_prior(argmax=True)` against the JAX prior's argmax chain;
  * every state tensor keeps its address across steps, `reset_stream`, the
    AdaIN setters, an assignment to `state` and the resampler's reset; the
    prior's across samples; the model's buffers under `graphed_stream` and
    `init_stream_state`, bit-equal to the model's own step calls;
  * the graphs' key: the same shapes and flags are one key; a new block
    length, an injected draw, a changed cuDNN or TF32 flag, a constant or
    other state tensors are another.
"""
import json

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
from rave_tpu.prior.model import Prior as JaxPrior
from rave_tpu.prior.model import generate as jax_prior_generate
from rave_tpu.train.state import create_train_state as jax_create_train_state
from rave_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from rave_tpu_torch import config
from rave_tpu_torch.export import artifact
from rave_tpu_torch.export.artifact import ExportedRAVE, graphed_stream
from rave_tpu_torch.export.export import export_model
from rave_tpu_torch.factory import build_rave
from rave_tpu_torch.nn import graphs
from rave_tpu_torch.nn.streaming import init_stream_state
from rave_tpu_torch.prior.core import DiagonalShift, QuantizedNormal
from rave_tpu_torch.prior.model import Prior
from rave_tpu_torch.train.state import create_train_state
from rave_tpu_torch.utils.checkpoint import save_checkpoint, save_prior_checkpoint
from rave_tpu_torch.utils.convert import (
    _flatten, convert_tree, from_jax_prior, from_jax_variables, port_name,
)
from rave_tpu_torch.utils.rng import normal_from_seed, uniform_from_seed

TINY = ["capacity=2", "discriminator.capacity=2", "latent_size=8", "ratios=[4,4,2]",
        "dilations=[[1],[1],[1]]"]
FIDELITY = [0.3, 0.6, 0.8, 0.9, 0.96, 0.98, 0.99, 1.0]  # 0.95 -> 4 dims of 8
TINY_V3 = ["capacity=4", "latent_size=4", "ratios=[4,4,2]", "dilations=[[1,3],[1],[1]]",
           "distance.scales=[512,256]", "discriminator.descript_periods=[2]",
           "discriminator.descript_fft_sizes=[256]"]
PRIOR = dict(latent_size=2, resolution=8, res_size=16, skp_size=8, kernel_size=3,
             cycle_size=4, n_layers=3)
MODEL_TOL = 1e-4  # the serving path's bound (tests/test_torch_export.py)
N_SIGNAL, N_BLOCKS, RESET_AFTER = 8192, 8, 4


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def to_port(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 2, 1)))


def from_port(y):
    return y.detach().cpu().numpy().transpose(0, 2, 1)


def as_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _runs(root, names, overrides, fidelity, critic_seed=0):
    """A JAX run and a port run of one generator (the JAX train state's)."""
    jcfg = jax_config.compose(names, overrides)
    jcfg.data.n_signal = N_SIGNAL
    state = jax_create_train_state(jcfg, jax_build_rave(jcfg, train=True),
                                   jax_build_discriminator(jcfg), jax.random.key(critic_seed),
                                   n_signal=N_SIGNAL)
    D = jcfg.latent_size
    r = np.random.default_rng(0)
    buffers = dict(state.model_state["buffers"])
    buffers["fidelity"] = jnp.asarray(fidelity, jnp.float32)
    buffers["latent_pca"] = jnp.asarray(np.linalg.qr(r.standard_normal((D, D)))[0], jnp.float32)
    buffers["latent_mean"] = jnp.asarray(r.standard_normal(D) * 0.1, jnp.float32)
    state = state.replace(model_state={**state.model_state, "buffers": buffers})
    jax_run = root / "jax_run"
    jax_run.mkdir()
    (jax_run / "config.json").write_text(jax_config.snapshot(jcfg))
    jax_save_checkpoint(str(jax_run), 1, jax.device_get(state))
    cfg = config.compose(names, overrides)
    cfg.data.n_signal = N_SIGNAL
    pstate = create_train_state(cfg, device="cpu")
    from_jax_variables(pstate.model, as_np({"params": state.gen_params, **{
        k: v for k, v in state.model_state.items() if k != "cache"}}))
    port_run = root / "port_run"
    port_run.mkdir()
    (port_run / "config.json").write_text(config.snapshot(cfg))
    save_checkpoint(str(port_run), pstate)
    return jax_run, port_run


@pytest.fixture(scope="module")
def v2_artifacts(tmp_path_factory):
    """Both packages' v2 artifacts, mono at the model's rate and stereo at twice it."""
    root = tmp_path_factory.mktemp("stream_graph_v2")
    jax_run, port_run = _runs(root, ["v2"], TINY, FIDELITY)
    out = {}
    for kind, kw in (("mono", {}), ("stereo", dict(stereo=True, target_sr=88200))):
        jpath = jax_export_model(run=str(jax_run), output=str(root / f"jax_{kind}"),
                                 streaming=True, **kw)
        ppath = export_model(run=str(port_run), output=str(root / f"port_{kind}"),
                             streaming=True, device="cpu", **kw)
        out[kind] = (jpath, ppath)
    return out


@pytest.fixture(scope="module")
def v3_artifacts(tmp_path_factory):
    root = tmp_path_factory.mktemp("stream_graph_v3")
    jax_run, port_run = _runs(root, ["v3"], TINY_V3, [0.2, 0.4, 0.6, 1.0])
    return (jax_export_model(run=str(jax_run), output=str(root / "jax_art"), streaming=True),
            export_model(run=str(port_run), output=str(root / "port_art"), streaming=True,
                         device="cpu"))


def _peek_draws(art, n_calls):
    """The keys that the JAX artifact's next `n_calls` `_apply` calls draw
    their latent noise from: each takes two splits and draws from the second."""
    k, keys = art._rng, []
    for _ in range(n_calls):
        k, _ = jax.random.split(k)
        k, r2 = jax.random.split(k)
        keys.append(r2)
    return keys


# the JAX package's names of the stream buffers that the port names otherwise:
# a conv's, a delay line's, the resampler's two
JAX_LEAVES = {"pad": "cache", "delay": "buf", "down": "down_cache", "up": "up_cache"}


def _cache_leaves(tree):
    """A JAX `cache` tree by the port's names in the port's layout
    (`JAX_LEAVES`; every leaf is [B, T, C] there, [B, C, T] here)."""
    out = {}
    for path, value in _flatten(tree).items():
        owner, _, leaf = port_name(path).rpartition(".")
        leaf = JAX_LEAVES.get(leaf, leaf)
        out[f"{owner}.{leaf}" if owner else leaf] = np.asarray(value).transpose(0, 2, 1)
    return out


def check_state(theirs, mine):
    """The port's whole stream state against the JAX artifact's: every cache
    and delay line of the model and of the resampler, and the AdaIN buffers."""
    want = _cache_leaves(as_np(theirs.cache))
    if "adain" in theirs.variables:
        want.update(convert_tree(mine.model, as_np(theirs.variables["adain"])))
    names = [name for name, _, _ in mine.slots]
    if mine.resampler is not None:
        want.update(_cache_leaves(as_np(theirs._res_cache)))
        names += [name for name, _, _ in artifact.stream_slots(mine.resampler)]
    assert sorted(want) == sorted(names)
    for name, got in zip(names, mine.stream_state):
        assert got.shape == want[name].shape, name
        assert rel_err(got.numpy(), want[name]) <= MODEL_TOL, name


@pytest.mark.parametrize("method", ["encode", "decode", "forward"])
@pytest.mark.parametrize("kind", ["mono", "stereo"])
def test_stream_matches_jax(v2_artifacts, kind, method):
    """N_BLOCKS streaming blocks of `method` through the served step, a
    `reset_stream` after RESET_AFTER: every output and the stream state
    after every block against the JAX artifact's (its draws injected)."""
    jpath, ppath = v2_artifacts[kind]
    theirs, mine = JaxExportedRAVE(jpath), ExportedRAVE(ppath, device="cpu")
    rows, D, L = mine.stream_batch, mine.full_latent_size, mine.latent_size
    ratio = mine.resampler.ratio if mine.resampler is not None else 1
    block, frames = mine.block_size, mine.block_size // ratio // mine.cfg.decimation()
    rng = np.random.default_rng(5)
    for i in range(N_BLOCKS):
        if i == RESET_AFTER:
            theirs.reset_stream()
            mine.reset_stream()
        if method == "decode":
            z = rng.standard_normal((rows, frames, L)).astype(np.float32)
            (k,) = _peek_draws(theirs, 1)
            noise = to_port(jax.random.normal(k, (rows, frames, D - L)))
            want = np.asarray(theirs.decode(jnp.asarray(z), streaming=True))
            got = mine.decode(to_port(z), streaming=True, noise=noise)
        else:
            x = (rng.standard_normal((rows, block, 1)) * 0.3).astype(np.float32)
            keys = _peek_draws(theirs, 1 if method == "encode" else 2)
            eps = to_port(jax.random.normal(keys[0], (rows, frames, D)))
            if method == "encode":
                want = np.asarray(theirs.encode(jnp.asarray(x), streaming=True))
                got = mine.encode(to_port(x), streaming=True, eps=eps)
            else:
                noise = to_port(jax.random.normal(keys[1], (rows, frames, D - L)))
                want = np.asarray(theirs.forward(jnp.asarray(x), streaming=True))
                got = mine.forward(to_port(x), streaming=True, eps=eps, noise=noise)
        assert got.shape == (want.shape[0], want.shape[2], want.shape[1])
        assert rel_err(from_port(got), want) <= MODEL_TOL, i
        check_state(theirs, mine)


def test_v3_stream_matches_jax_across_attributes(v3_artifacts):
    """A v3 stream whose AdaIN attributes change between blocks (learn the
    target, learn the source, reset the stream, transfer, reset the target):
    every output, the caches and the AdaIN state against the JAX artifact's."""
    theirs, mine = JaxExportedRAVE(v3_artifacts[0]), ExportedRAVE(v3_artifacts[1], device="cpu")
    block, frames = mine.block_size, mine.block_size // mine.cfg.decimation()
    rng = np.random.default_rng(8)
    plan = [("set_learn_target", True), None, None, ("set_learn_target", False),
            ("set_learn_source", True), None, ("set_learn_source", False), "reset_stream",
            None, None, "reset_target", None]
    for i, change in enumerate(plan):
        for art in (theirs, mine):
            if isinstance(change, tuple):
                getattr(art, change[0])(change[1])
            elif change is not None:
                getattr(art, change)()
        x = (rng.standard_normal((1, block, 1)) * (0.05 if i < 3 else 0.5)).astype(np.float32)
        k1, _ = _peek_draws(theirs, 2)
        eps = to_port(jax.random.normal(k1, (1, frames, 4)))
        want = np.asarray(theirs.forward(jnp.asarray(x), streaming=True))
        got = mine.forward(to_port(x), streaming=True, eps=eps)
        assert rel_err(from_port(got), want) <= MODEL_TOL, (i, change)
        check_state(theirs, mine)
    n_y = [float(s) for (name, _, _), s in zip(mine.slots, mine.state)
           if name.endswith("num_update_y")]
    assert n_y and all(n == 0.0 for n in n_y)  # reset_target, after 3 learned blocks


@pytest.fixture(scope="module")
def prior_artifact(tmp_path_factory):
    """A tiny v2 run exported with a prior (the JAX prior's initial params)."""
    root = tmp_path_factory.mktemp("stream_graph_prior")
    jcfg = jax_config.compose(["v2"], TINY)
    variables = as_np(dict(jax_build_rave(jcfg, train=False).init(
        {"params": jax.random.key(0), "noise": jax.random.key(1)}, np.zeros((1, 4096, 1)))))
    r = np.random.default_rng(0)
    variables = {"params": variables["params"], "buffers": {
        **variables["buffers"], "fidelity": np.asarray(FIDELITY, np.float32),
        "latent_pca": np.linalg.qr(r.standard_normal((8, 8)))[0].astype(np.float32),
        "latent_mean": (r.standard_normal(8) * 0.1).astype(np.float32)}}
    cfg = config.compose(["v2"], TINY)
    state = create_train_state(cfg, device="cpu")
    from_jax_variables(state.model, variables)
    vae_run = root / "v2_run"
    vae_run.mkdir()
    (vae_run / "config.json").write_text(config.snapshot(cfg))
    save_checkpoint(str(vae_run), state)
    jprior = JaxPrior(**PRIOR)
    x0 = np.zeros((1, 8, PRIOR["latent_size"] * PRIOR["resolution"]), np.float32)
    jvars = as_np(dict(jprior.init({"params": jax.random.key(2)}, x0)))
    prior = Prior(**PRIOR)
    from_jax_prior(prior, jvars["params"])
    prior_run = root / "tiny_prior"
    prior_run.mkdir()
    (prior_run / "prior_config.json").write_text(
        json.dumps(dict(vae_run=str(vae_run), **PRIOR, fidelity=0.95)))
    save_prior_checkpoint(str(prior_run), 2, prior, torch.optim.Adam(prior.parameters()))
    path = export_model(run=str(vae_run), prior=str(prior_run), fidelity=0.99,
                        output=str(root / "art"), device="cpu")
    return {"path": path, "jprior": jprior, "jvars": jvars}


def test_sample_prior_matches_jax(prior_artifact):
    """`sample_prior(argmax=True)`, one served step at a time, decodes the
    JAX prior's own argmax chain (`rave_tpu.prior.model.generate`) with the
    artifact's dither and padding; a second sample starts from a zero state
    again, and its served state tensors keep their addresses."""
    art = ExportedRAVE(prior_artifact["path"], device="cpu")
    jprior, jvars = prior_artifact["jprior"], prior_artifact["jvars"]
    D, R, n = PRIOR["latent_size"], PRIOR["resolution"], 12
    cache = jax.tree_util.tree_map(jnp.zeros_like, jvars["cache"])
    ys = jax_prior_generate(jprior, jvars["params"], cache, jnp.zeros((1, 1, D * R)),
                            n + D - 1, jax.random.key(0), argmax=True)
    seed = torch.tensor(11, dtype=torch.int64)
    dither = uniform_from_seed(seed, (1, D, n + D - 1), artifact.PRIOR_DITHER_SALT)
    want = DiagonalShift().inverse(QuantizedNormal(R).decode(to_port(ys), dither))
    pad = normal_from_seed(seed, (1, art.latent_size - D, n), artifact.PRIOR_PAD_SALT)
    ptrs = [t.data_ptr() for t in art.graphs["prior"].state]
    for _ in range(2):
        z = art.sample_prior(n, seed=11, argmax=True)
        assert torch.equal(z, torch.cat([want, pad], dim=1))
    assert [t.data_ptr() for t in art.graphs["prior"].state] == ptrs


def _ptrs(art):
    return [t.data_ptr() for t in art.stream_state]


@pytest.mark.parametrize("kind", ["mono", "stereo", "v3"])
def test_state_keeps_its_addresses(v2_artifacts, v3_artifacts, kind):
    """The tensors the served steps read and write stay where they are:
    across every method's steps, `reset_stream` (which zeroes the stream
    part, the resampler's included, and keeps AdaIN's), the AdaIN setters
    and an assignment to `state`; a list of another dtype takes their places."""
    path = v3_artifacts[1] if kind == "v3" else v2_artifacts[kind][1]
    art = ExportedRAVE(path, device="cpu")
    ptrs, rng = _ptrs(art), np.random.default_rng(3)
    rows, frames = art.stream_batch, art.manifest["block_size"] // art.cfg.decimation()
    x = torch.from_numpy(rng.standard_normal((rows, 1, art.block_size)).astype(np.float32))
    z = torch.from_numpy(rng.standard_normal((rows, art.latent_size, frames)).astype(np.float32))
    if kind == "v3":
        art.set_learn_target(True)
    for _ in range(2):
        art.encode(x, streaming=True)
        art.decode(z, streaming=True)
        art.forward(x, streaming=True)
    assert _ptrs(art) == ptrs
    assert all(bool(t.abs().sum() > 0) for t in art.stream_state[len(art.slots):])
    adain = [art.stream_state[i].clone() for i in art.adain_indices]
    art.reset_stream()
    assert _ptrs(art) == ptrs
    for i, t in enumerate(art.stream_state):
        if i in art.adain_indices:
            assert torch.equal(t, adain[art.adain_indices.index(i)])
        else:
            assert not bool(t.any()), i
    for setter in ("set_learn_target", "set_learn_source"):
        getattr(art, setter)(True)
    art.reset_target()
    art.reset_source()
    assert _ptrs(art) == ptrs
    values = [torch.full_like(t, 0.5) for t in art.state]
    art.state = values
    assert _ptrs(art) == ptrs and all(torch.equal(a, b) for a, b in zip(art.state, values))
    art.state = [t.double() for t in values]  # another dtype: new tensors in their places
    assert all(t.dtype == torch.float64 for t in art.state)
    assert _ptrs(art)[len(art.slots):] == ptrs[len(art.slots):]


def test_graphed_stream_is_the_model_step(v2_artifacts):
    """`graphed_stream(model)` on the CPU: the model's step pair on the
    model's own buffers, bit-equal to `step_encode` / `step_decode` called
    on a copy, across `init_stream_state` (which zeroes in place: the
    buffers keep their addresses, so a graph on the card replays)."""
    cfg = config.compose(["v2", "causal"], TINY)
    model, twin = (build_rave(cfg, seed=4, device="cpu").eval() for _ in range(2))
    twin.load_state_dict(model.state_dict())
    served = graphed_stream(model, cfg.latent_size)
    ptrs = [t.data_ptr() for t in served.state]
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (1, 1, 6 * cfg.block_size())).astype(np.float32) * 0.3)
    with torch.no_grad():
        for i in range(6):
            if i == 3:
                init_stream_state(model, 1)
                init_stream_state(twin, 1)
            xb = x[..., i * cfg.block_size():(i + 1) * cfg.block_size()]
            z, y = served(xb)
            z_t = twin.step_encode(xb)
            y_t = twin.step_decode(z_t[:, :cfg.latent_size])
            assert torch.equal(z, z_t) and torch.equal(y, y_t), i
            assert [t.data_ptr() for t in served.state] == ptrs, i
    key = served.key_of((xb,), {})
    init_stream_state(model, 2)  # another batch: new buffers, which the key tells apart
    assert [t.data_ptr() for t in served.state] != ptrs
    assert served.key_of((torch.cat([xb, xb]),), {}) != key


def test_graph_key():
    """One key per (input shapes and dtypes, present draws, constants, state
    tensors, backend flags, the caller's key); an int seed's value is not in it."""
    state = [torch.zeros(1, 2, 3)]
    extra = {"on": False}
    served = graphs.StepGraphs(lambda s, x, seed, eps=None: (x, s), state,
                               key=lambda: (extra["on"],))
    x, eps = torch.zeros(1, 1, 64), torch.zeros(1, 4, 2)
    key = served.key_of((x, 7, None), {})
    assert served.key_of((torch.ones(1, 1, 64), 8, None), {}) == key
    others = [served.key_of((torch.zeros(1, 1, 128), 7, None), {}),  # the block
              served.key_of((torch.zeros(2, 1, 64), 7, None), {}),  # the batch
              served.key_of((x.double(), 7, None), {}),
              served.key_of((x, 7, eps), {}),  # an injected draw
              served.key_of((x, 7, None), {"argmax": True}),
              served.key_of((x, 7, None), {}, state=[torch.zeros(1, 2, 3)])]
    assert len({key, *others}) == 1 + len(others)
    for flag in ("enabled", "deterministic", "benchmark", "allow_tf32"):
        saved = getattr(torch.backends.cudnn, flag)
        setattr(torch.backends.cudnn, flag, not saved)
        try:
            assert served.key_of((x, 7, None), {}) != key, flag
        finally:
            setattr(torch.backends.cudnn, flag, saved)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = not saved
    try:
        assert served.key_of((x, 7, None), {}) != key
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    extra["on"] = True
    assert served.key_of((x, 7, None), {}) != key
    extra["on"] = False
    assert served.key_of((x, 7, None), {}) == key
    # on the CPU the step runs eagerly, its new state copied into `state`
    counts = (graphs.captures, graphs.replays)
    y = served(torch.ones(1, 1, 64), 3)
    assert torch.equal(y, torch.ones(1, 1, 64)) and served.graphs == {}
    assert (graphs.captures, graphs.replays) == counts
