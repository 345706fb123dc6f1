"""v3 (Snake, AdaIN, the descript critic) and discrete_v3: rave_tpu_torch against rave_tpu.

At a tiny width (capacity 4, latent 4, ratios 4.4.2, n_signal 8192; the
critic one MPD (period 2) and one MRD (FFT size 256):
tests/test_torch_descript.py holds the stock critic), each package builds
v3 from its own config; the JAX variables (the Snake `alpha`s drawn away
from their ones, the `adain` collection) go into the port through
`from_jax_variables`. The same numpy inputs and draws go through both:

  * Snake at 1e-6 in fp32 and within bf16's rounding in bf16;
  * the AdaIN state machine after each call (identity in training, learn
    the target, learn the source, transfer, reset) at 1e-6, that an
    offline call never changes a buffer, and its 8 batch slots;
  * the v3 encoder and decoder in eval mode with learned AdaIN statistics
    (the transfer acts), offline and over 8 streaming blocks, at 1e-4;
  * a Snake unit never calls the fused unit (the JAX package gates its
    kernel to leaky ReLU);
  * one step of each v3 program from one JAX state (losses 1e-4, every
    gradient by tests/test_torch_train.py's rule; a critic step's against
    the JAX critic step on the port's fake signal, itself within 1e-5 of
    JAX's: `assert_step_matches`), and the adversarial generator and critic
    steps with `train.bf16` + `bf16_dis` by
    tests/test_torch_bf16.py's (the port no further from the JAX fp32 step
    than twice the JAX bf16 step; floors 1e-3 for the gradients and 1e-2
    for the losses, see BF16_LOSS_FLOOR);
  * validation and `evaluate` against JAX's `train=False` model with
    learned AdaIN statistics (the JAX draws injected), and the same pass in
    training mode differs;
  * the v3 artifact: the manifest's `attributes` / `attribute_ops` equal
    to JAX's; learn target, learn source, transfer and reset over a stream
    against the JAX `ExportedRAVE` at 1e-4; the `.pt2` programs bit-equal to
    the eager steps, AdaIN state included;
  * one step of each discrete_v3 program, chained as a run goes, against
    JAX by the same rules, and its codebooks at 1e-5;
  * `cli train --config v3` resumed bit-equal (AdaIN buffers included),
    `eval`, `export --streaming` and `generate`, on the CPU.
"""
import io
import json
from contextlib import redirect_stdout
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy.io import wavfile

from rave_tpu import config as jax_config
from rave_tpu.export.artifact import ExportedRAVE as JaxExportedRAVE
from rave_tpu.export.export import export_model as jax_export_model
from rave_tpu.factory import build_audio_distance as jax_build_audio_distance
from rave_tpu.factory import build_discriminator as jax_build_discriminator
from rave_tpu.factory import build_rave as jax_build_rave
from rave_tpu.models import blocks as jax_blocks
from rave_tpu.train import state as jax_state
from rave_tpu.train import steps as jax_steps
from rave_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from rave_tpu_torch import cli, config
from rave_tpu_torch.export.artifact import ExportedRAVE, stream_slots
from rave_tpu_torch.export.export import export_model
from rave_tpu_torch.factory import build_rave
from rave_tpu_torch.models import blocks
from rave_tpu_torch.models.blocks import AdaIN, LatentDraws, Snake
from rave_tpu_torch.nn.streaming import init_stream_state
from rave_tpu_torch.train import evaluate as port_evaluate
from rave_tpu_torch.train import loop
from rave_tpu_torch.train import steps as port_steps
from rave_tpu_torch.train.state import create_train_state
from rave_tpu_torch.train.steps import build_train_steps
from rave_tpu_torch.utils.checkpoint import list_checkpoints, save_checkpoint
from rave_tpu_torch.utils.convert import convert_tree, from_jax_variables
from rave_tpu_torch.utils.logging import MetricsLogger

TINY = ["capacity=4", "latent_size=4", "ratios=[4,4,2]", "dilations=[[1,3],[1],[1]]",
        "distance.scales=[512,256]", "train.phase_1_duration=4",
        "train.update_discriminator_every=2", "train.beta_warmup_len=8", "train.ema=0.99",
        "discriminator.descript_periods=[2]", "discriminator.descript_fft_sizes=[256]"]
DISCRETE = ["latent.num_quantizers=3", "latent.codebook_size=16", "latent.noise_augmentation=2"]
BF16 = ["train.bf16=true", "train.bf16_dis=true"]
CROP, N_SIGNAL, B = (3, 2), 8192, 2
# (phase, global step, warmed, rng seed): pre-warmup gen, adversarial gen, critic
PHASES = [("gen", 1, False, 11), ("gen", 5, True, 12), ("dis", 6, True, 13)]
PHASE_IDS = ["gen-prewarmup", "gen-adversarial", "dis"]
LOSS_TOL, MODEL_TOL, STATE_TOL, CODEBOOK_TOL = 1e-4, 1e-4, 1e-6, 1e-5
FAKE_TOL = 1e-5  # the critic step's fake signal, port vs JAX (1.7e-6 in discrete_v3's)
GRAD_TOL = {False: 5e-3, True: 1e-3}  # by `warmed` (tests/test_torch_train.py)
# floors of the bf16 rule: the gradients' as tests/test_torch_bf16.py's; the
# losses' 1e-2 (rave_tpu's own bf16 test holds them at 5%, tests/test_train.py:140):
# the adversarial terms are means of critic scores of both signs (0.05 here,
# from scores of ~0.5), which bf16's rounding of the generator's output moves
# by a few 1e-3 relative in either package: the port 3.4e-3 (adversarial
# generator step) and 6.1e-3 (critic step), JAX 1.3e-4 and 2.0e-3. The critic
# itself is held map by map in tests/test_torch_descript.py.
BF16_FLOOR, BF16_LOSS_FLOOR = 1e-3, 1e-2
FIDELITY = [0.2, 0.4, 0.6, 1.0]  # the artifact keeps all 4 latent dimensions


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def to_port(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 2, 1)))


def from_port(y):
    return y.detach().float().cpu().numpy().transpose(0, 2, 1)


def as_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def grad_stash():
    """An optax transform that updates nothing and keeps the gradient as its state."""
    def init(params):
        return jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        return jax.tree_util.tree_map(jnp.zeros_like, grads), grads

    return optax.GradientTransformation(init, update)


def drawn_alphas(params, seed=0):
    """`params` with every Snake `alpha` drawn from U(0.5, 1.5) (init: ones)."""
    rng = np.random.default_rng(seed)

    def draw(path, v):
        if path[-1].key == "alpha":
            return jnp.asarray(rng.uniform(0.5, 1.5, v.shape), v.dtype)
        return v

    return jax.tree_util.tree_map_with_path(draw, params)


def learned_adain(adain, seed=1):
    """An `adain` collection whose statistics were learned (3 updates each)
    and whose learning is off: the transfer acts in eval mode."""
    rng = np.random.default_rng(seed)

    def fill(path, v):
        name = path[-1].key
        if name.startswith("mean"):
            return jnp.asarray(rng.standard_normal(v.shape) * 0.1, v.dtype)
        if name.startswith("std"):
            return jnp.asarray(rng.uniform(0.5, 1.5, v.shape), v.dtype)
        return jnp.full(v.shape, 3.0 if name.startswith("num_update") else 0.0, v.dtype)

    return jax.tree_util.tree_map_with_path(fill, adain)


# ---------------------------------------------------------------------------
# Snake and AdaIN
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_snake_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 16, 8)) * 2).astype(np.float32)
    alpha = rng.uniform(0.2, 2.0, 8).astype(np.float32)
    want = jax_blocks.Snake(dim=8).apply({"params": {"alpha": jnp.asarray(alpha)}},
                                         jnp.asarray(x, dtype))
    snake = Snake(8)
    with torch.no_grad():
        snake.alpha.copy_(torch.from_numpy(alpha))
        got = snake(to_port(x).to(getattr(torch, dtype)))
        step = snake.step(to_port(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype) and torch.equal(got, step)
    # bf16: each op rounds to 8 bits, in another order in each package
    assert rel_err(from_port(got), np.asarray(want, np.float32)) <= (
        1e-6 if dtype == "float32" else 2 ** -7)


def test_adain_state_machine_matches_jax():
    """The artifact's AdaIN calls (JAX: `adain` mutable) after each step,
    from a batch of 2 of the 8 slots; an offline eval call changes nothing."""
    rng = np.random.default_rng(1)
    x_src = (rng.standard_normal((2, 64, 4)) * 2 + 1).astype(np.float32)
    x_tgt = (rng.standard_normal((2, 64, 4)) * 0.5 - 3).astype(np.float32)
    jax_m = jax_blocks.AdaIN(dim=4, train=False)
    st = dict(jax_m.init({"params": jax.random.key(0)}, jnp.asarray(x_src))["adain"])
    port = AdaIN(4).eval()

    def check(y_port, y_jax):
        assert rel_err(from_port(y_port), y_jax) <= STATE_TOL
        want = convert_tree(port, st)
        for name, value in want.items():
            assert np.allclose(port.get_buffer(name).numpy(), value, rtol=STATE_TOL, atol=1e-7)

    def both(x, flags=None):
        nonlocal st
        for k, v in (flags or {}).items():
            st[k] = jnp.full((1,), v)
            setattr(port, k, torch.full((1,), v))
        y, upd = jax_m.apply({"adain": st}, jnp.asarray(x), mutable=["adain"])
        st = dict(upd["adain"])
        port.learning = True
        with torch.no_grad():
            y_p = port.step(to_port(x))
        port.learning = False
        check(y_p, np.asarray(y))
        return y_p

    # training mode: the identity, whatever the buffers
    train = AdaIN(4).train()
    assert torch.equal(train(to_port(x_src)), to_port(x_src))
    np.testing.assert_array_equal(np.asarray(jax_blocks.AdaIN(dim=4, train=True).apply(
        {"adain": st}, jnp.asarray(x_src))), x_src)

    y = both(x_tgt, {"learn_y": 1.0})  # learn the target
    assert float(port.num_update_y) == 1 and torch.equal(y, to_port(x_tgt))
    both(x_tgt[::-1].copy())  # a second target batch: the moving average
    y = both(x_src, {"learn_y": 0.0, "learn_x": 1.0})  # learn the source, then transfer
    assert float(port.num_update_x) == 1 and float(port.num_update_y) == 2
    y = both(x_src, {"learn_x": 0.0})  # transfer only
    assert abs(float(y.mean()) - x_tgt.mean()) < abs(x_src.mean() - x_tgt.mean())

    before = {n: b.clone() for n, b in port.named_buffers()}
    with torch.no_grad():  # offline eval: reads, never writes
        y_off = port(to_port(x_src))
    assert torch.equal(y_off, y) and all(torch.equal(b, before[n])
                                         for n, b in port.named_buffers())

    for flags in ({"mean_y": 0.0, "std_y": 1.0, "num_update_y": 0.0},  # reset the target
                  {"mean_x": 0.0, "std_x": 1.0, "num_update_x": 0.0}):
        for k, v in flags.items():
            st[k] = jnp.full_like(st[k], v)
            setattr(port, k, torch.full_like(port.get_buffer(k), v))
        y = both(x_src)
    assert torch.equal(y, to_port(x_src))  # reset: the identity again
    # 8 batch slots, as JAX's `adain_max_batch`: a larger batch runs in training mode only
    with pytest.raises(ValueError, match="8 batch slots"):
        port(torch.zeros(9, 4, 16))
    assert train(torch.ones(9, 4, 16)).shape == (9, 4, 16)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_v3():
    """The JAX v3 train state (drawn alphas), its `train=False` model with
    learned AdaIN statistics, and the port model built from both."""
    cfg = jax_config.compose(["v3"], TINY)
    model = jax_build_rave(cfg, n_channels=1, train=True)
    dis = jax_build_discriminator(cfg, n_channels=1)
    state = jax_state.create_train_state(cfg, model, dis, jax.random.key(0), n_signal=N_SIGNAL)
    state = state.replace(gen_params=drawn_alphas(state.gen_params))
    eval_model = jax_build_rave(cfg, n_channels=1, train=False)
    learned = {"params": state.gen_params, "buffers": state.model_state["buffers"],
               "adain": learned_adain(state.model_state["adain"])}
    port = build_rave(config.compose(["v3"], TINY), seed=3, device="cpu")
    from_jax_variables(port, as_np(learned))
    return {"cfg": cfg, "model": model, "dis": dis, "state": state, "eval_model": eval_model,
            "learned": learned, "port": port.eval()}


def test_v3_model_matches_jax(jax_v3):
    """Eval mode with learned AdaIN statistics: encode, decode and 8
    streaming blocks of each, against the JAX `train=False` model."""
    m, v, port = jax_v3["eval_model"], jax_v3["learned"], jax_v3["port"]
    cfg = config.compose(["v3"], TINY)
    block = cfg.block_size()
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((1, 8 * block, 1)) * 0.3).astype(np.float32)
    latent = rng.standard_normal((1, 8 * block // cfg.decimation(), 4)).astype(np.float32)
    with torch.no_grad():
        z_p, y_p = port.encode(to_port(x)), port.decode(to_port(latent))
    z_j = jax.jit(partial(m.apply, method="encode"))(v, jnp.asarray(x))
    y_j = jax.jit(partial(m.apply, method="decode"))(v, jnp.asarray(latent))
    assert rel_err(from_port(z_p), z_j) <= MODEL_TOL and rel_err(from_port(y_p), y_j) <= MODEL_TOL
    with torch.no_grad():  # AdaIN's transfer acts: training mode (identity) differs
        assert rel_err(from_port(port.train().encode(to_port(x))), z_j) > 1e-2
    port.eval()

    init = jax.jit(m.init)({"params": jax.random.key(0), "noise": jax.random.key(1)},
                           jnp.zeros((1, 2 * block, 1)))
    for method, signal, chunk in (("step_encode", x, block),
                                  ("step_decode", latent, block // cfg.decimation())):
        cache, want = init["cache"], []
        step = jax.jit(partial(m.apply, method=method, mutable=["cache"]))
        for i in range(0, signal.shape[1], chunk):
            y, upd = step({**v, "cache": cache}, jnp.asarray(signal[:, i:i + chunk]))
            cache = upd["cache"]
            want.append(np.asarray(y))
        init_stream_state(port, 1)
        buffers = {n: b.clone() for n, b in port.named_buffers()}
        with torch.no_grad():
            got = [from_port(getattr(port, method)(to_port(signal[:, i:i + chunk])))
                   for i in range(0, signal.shape[1], chunk)]
        assert rel_err(np.concatenate(got, 1), np.concatenate(want, 1)) <= MODEL_TOL
        adain = [n for n in buffers if n.rsplit(".", 1)[-1] in AdaIN.STATE]
        assert len(adain) == 8 * 8  # 4 units in each half, 8 buffers each
        assert all(torch.equal(port.get_buffer(n), buffers[n]) for n in adain)


def test_snake_unit_takes_no_fused_call(monkeypatch):
    """The residual units call `fused_dilated_unit` only with leaky ReLU."""
    calls = []
    fused = blocks.fused_dilated_unit
    monkeypatch.setattr(blocks, "fused_dilated_unit", lambda *a: calls.append(1) or fused(*a))
    x = torch.randn(1, 1, 4096, generator=torch.Generator().manual_seed(0)) * 0.1
    for names, n in ((["v3"], 0), (["v2"], 8)):
        cfg = config.compose(names, TINY)
        model = build_rave(cfg, device="cpu")
        calls.clear()
        with torch.no_grad():
            model.decode(model.encode(x)[:, :4])
        assert len(calls) == n, names
        units = [m for m in model.modules() if isinstance(m, blocks.FusedDilatedResidual)]
        assert len(units) == 8 and all(u.inner.activation == cfg.activation for u in units)


# ---------------------------------------------------------------------------
# the training steps
# ---------------------------------------------------------------------------


def jax_step_runs(cfg, model, dis, state, x, phases, chain=False):
    """The JAX steps of `phases` from `state`, its optimizer swapped for one
    that keeps the gradients: metrics, gradients and the state each ran from."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_steps, "make_optimizers", lambda c: (grad_stash(), grad_stash()))
        steps = jax_steps.build_train_steps(cfg, model, dis, crop_frames=CROP)
    out = {}
    for which, step, warmed, seed in phases:
        variables = {"params": state.gen_params, **state.model_state}
        rng = jax.random.key(seed)
        xs = x if x is not None else (np.random.default_rng(seed).standard_normal(
            (B, N_SIGNAL, 1)) * 0.1).astype(np.float32)
        ref = {"x": xs, "draws": jax_draws(model, variables, cfg, rng),
               "gen_params": as_np(state.gen_params), "model_state": as_np(state.model_state),
               "dis_params": as_np(state.dis_params)}
        s0 = jax.tree_util.tree_map(jnp.array, state.replace(step=jnp.asarray(step, jnp.int32)))
        if which == "gen":
            s1, m = steps["gen"](s0, jnp.asarray(xs), rng, warmed=warmed, quantize=True)
            grads = s1.gen_opt
        else:
            fake, _ = jax_steps._autoencode(cfg, model, variables, jnp.asarray(xs), rng, True,
                                            True, train=True)
            ref.update(y_raw=np.asarray(fake["y_raw"]),
                       critic_on=partial(jax_critic_grads, cfg, model, dis, s0, xs, rng))
            s1, m = steps["dis"](jax.tree_util.tree_map(jnp.array, s0), jnp.asarray(xs), rng,
                                 quantize=True)
            grads = s1.dis_opt
        ref.update(metrics={k: float(v) for k, v in m.items()}, grads=as_np(grads),
                   model_state_after=as_np(s1.model_state))
        out[(which, warmed)] = ref
        if chain:  # the run goes on from this step's codebooks
            state = state.replace(model_state=s1.model_state)
    return out


def jax_critic_grads(cfg, model, dis, state, x, rng, y_raw):
    """The gradients of the JAX critic step from `state` with its fake signal
    replaced by `y_raw` [B, T, 1]: the critic's own gradient on the port's input."""
    autoencode = jax_steps._autoencode

    def with_fake(*args, **kwargs):
        out, new_state = autoencode(*args, **kwargs)
        return {**out, "y_raw": jnp.asarray(y_raw)}, new_state

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_steps, "make_optimizers", lambda c: (grad_stash(), grad_stash()))
        mp.setattr(jax_steps, "_autoencode", with_fake)
        step = jax_steps.build_train_steps(cfg, model, dis, crop_frames=CROP)["dis"]
        s1, _ = step(jax.tree_util.tree_map(jnp.array, state), jnp.asarray(x), rng,
                     quantize=True)
    return as_np(s1.dis_opt)


def jax_draws(model, variables, cfg, rng):
    """What the family's reparametrize draws in a JAX step run with `rng`, as
    `LatentDraws` (tests/test_torch_families.py; variational: the eps of a
    zero latent's reparametrization)."""
    key = model.apply(variables, rngs={"noise": rng},
                      method=lambda m: m.encoder.make_rng("noise"))
    lat, T = cfg.latent, N_SIGNAL // cfg.decimation()
    if lat.family == "variational":
        return LatentDraws(eps=to_port(jax.random.normal(key, (B, T, cfg.latent_size))))
    k1, r2 = jax.random.split(key)
    draws = LatentDraws(noise=to_port(jax.random.normal(r2, (B, T, lat.noise_augmentation))))
    ks = [jax.random.fold_in(k1, i) for i in range(lat.num_quantizers)]
    rows = lambda k: np.asarray(jax.random.randint(k, (lat.codebook_size,), 0, B * T))  # noqa
    draws.init_idx = torch.from_numpy(np.stack([rows(k) for k in ks])).long()
    draws.expire_idx = torch.from_numpy(np.stack([rows(jax.random.fold_in(k, 1))
                                                  for k in ks])).long()
    return draws


@pytest.fixture(scope="module")
def v3_steps(jax_v3):
    x = (np.random.default_rng(0).standard_normal((B, N_SIGNAL, 1)) * 0.1).astype(np.float32)
    j = jax_v3
    out = jax_step_runs(j["cfg"], j["model"], j["dis"], j["state"], x, PHASES)
    cfg16 = jax_config.compose(["v3"], TINY + BF16)
    for key, ref in jax_step_runs(cfg16, j["model"], j["dis"], j["state"], x,
                                  PHASES[1:]).items():
        out[("bf16",) + key] = ref
    return out


def run_port_step(names, overrides, ref, which, step, warmed, monkeypatch):
    """The port's step from the JAX state of `ref`: its state, metrics,
    gradients, the module they belong to and the fake signal it made [B, T, 1]."""
    cfg = config.compose(names, TINY + overrides)
    st = create_train_state(cfg, seed=0, device="cpu")
    from_jax_variables(st.model, {"params": ref["gen_params"], **{
        k: v for k, v in ref["model_state"].items() if k != "cache"}})
    from_jax_variables(st.discriminator, {"params": ref["dis_params"]})
    st.ema = {n: p.detach().clone() for n, p in st.model.named_parameters()}
    st.step = step
    st.model.eval()  # the step itself must put it in training mode
    seen = {}
    autoencode = port_steps.autoencode

    def recorded(*args, **kwargs):
        seen.update(autoencode(*args, **kwargs))
        return seen

    monkeypatch.setattr(port_steps, "autoencode", recorded)
    steps = build_train_steps(cfg, CROP)
    x = to_port(ref["x"])
    if which == "gen":
        metrics = steps["gen"](st, x, warmed, draws=ref["draws"])
    else:
        metrics = steps["dis"](st, x, draws=ref["draws"])
    assert st.step == step + 1 and st.model.training
    module = st.model if which == "gen" else st.discriminator
    return (st, metrics, {n: p.grad.numpy() for n, p in module.named_parameters()}, module,
            from_port(seen["y_raw"]))


def assert_step_matches(metrics, grads, module, ref, which, warmed, fake):
    """Losses at 1e-4 and every gradient within GRAD_TOL of JAX's, relative
    to its max. A critic step's gradients are held to the JAX critic step run
    on the port's fake signal `fake`, which must be within FAKE_TOL of JAX's
    own: the critic's gradient is piecewise in its input (hinge loss, leaky
    ReLUs), and in discrete_v3's critic step JAX's own gradients on the two
    fake signals, 1.7e-6 apart, differ by up to 1.4e-2 (the MPD's and one
    MRD band's), while the port is within 2.4e-5 of JAX on the same one."""
    assert set(metrics) == set(ref["metrics"])
    for k, want in ref["metrics"].items():
        got = float(metrics[k])
        assert abs(got - want) <= LOSS_TOL * max(abs(want), 1e-2), (k, got, want)
    if which == "dis":
        assert rel_err(fake, ref["y_raw"]) <= FAKE_TOL
        want = convert_tree(module, ref["critic_on"](fake))
    else:
        want = convert_tree(module, ref["grads"])
    assert set(grads) == set(want)
    err = lambda a, b: np.abs(a - b).max() / (np.abs(b).max() or 1e-3)  # noqa: E731
    apart = {n: err(g, want[n]) for n, g in grads.items() if err(g, want[n]) > GRAD_TOL[warmed]}
    assert not apart, apart


@pytest.mark.parametrize("which,step,warmed,seed", PHASES, ids=PHASE_IDS)
def test_v3_step_matches_jax(v3_steps, which, step, warmed, seed, monkeypatch):
    ref = v3_steps[(which, warmed)]
    st, metrics, grads, module, fake = run_port_step(["v3"], [], ref, which, step, warmed,
                                                     monkeypatch)
    assert_step_matches(metrics, grads, module, ref, which, warmed, fake)
    if which == "gen":  # Snake's alphas train
        assert any(np.abs(g).max() > 0 for n, g in grads.items() if n.endswith(".alpha"))
    # training leaves AdaIN's buffers as they were, as JAX's
    for name, value in convert_tree(st.model, ref["model_state"]["adain"]).items():
        assert np.array_equal(st.model.get_buffer(name).numpy(), value)


@pytest.mark.parametrize("which,step,warmed,seed", PHASES[1:], ids=PHASE_IDS[1:])
def test_v3_bf16_step_matches_jax(v3_steps, which, step, warmed, seed, monkeypatch):
    """`train.bf16` + `bf16_dis` (the descript critic in bf16 after its fp32
    STFT): losses and gradients no further from the JAX fp32 step than twice
    the JAX bf16 step is, floor 1e-3; masters and gradients fp32."""
    ref, ref16 = v3_steps[(which, warmed)], v3_steps[("bf16", which, warmed)]
    _, metrics, grads, module, _ = run_port_step(["v3"], BF16, ref16, which, step, warmed,
                                                 monkeypatch)
    assert all(p.dtype == torch.float32 for p in module.parameters())
    want, jax16 = convert_tree(module, ref["grads"]), convert_tree(module, ref16["grads"])

    def loss_distance(m):
        return max(abs(float(m[k]) - v) / max(abs(v), 1e-2) for k, v in ref["metrics"].items())

    def grad_distance(g):
        num = sum(float(np.sum((np.asarray(g[k], np.float64) - w) ** 2)) for k, w in want.items())
        return (num / sum(float(np.sum(np.asarray(w, np.float64) ** 2))
                          for w in want.values())) ** 0.5

    assert loss_distance(metrics) <= max(2 * loss_distance(ref16["metrics"]), BF16_LOSS_FLOOR)
    assert grad_distance(grads) <= max(2 * grad_distance(jax16), BF16_FLOOR)


@pytest.fixture(scope="module")
def discrete_v3_steps():
    cfg = jax_config.compose(["discrete_v3"], TINY + DISCRETE)
    model = jax_build_rave(cfg, n_channels=1, train=True)
    dis = jax_build_discriminator(cfg, n_channels=1)
    state = jax_state.create_train_state(cfg, model, dis, jax.random.key(0), n_signal=N_SIGNAL)
    state = state.replace(gen_params=drawn_alphas(state.gen_params))
    # a batch per step, chained as a run goes (tests/test_torch_families.py)
    return jax_step_runs(cfg, model, dis, state, None, PHASES, chain=True)


@pytest.mark.parametrize("which,step,warmed,seed", PHASES, ids=PHASE_IDS)
def test_discrete_v3_step_matches_jax(discrete_v3_steps, which, step, warmed, seed,
                                     monkeypatch):
    ref = discrete_v3_steps[(which, warmed)]
    st, metrics, grads, module, fake = run_port_step(["discrete_v3"], DISCRETE, ref, which,
                                                     step, warmed, monkeypatch)
    assert_step_matches(metrics, grads, module, ref, which, warmed, fake)
    want = convert_tree(st.model, {"encoder": ref["model_state_after"]["codebook"]["encoder"]})
    assert want and all(rel_err(st.model.get_buffer(n).numpy(), v) <= CODEBOOK_TOL
                        for n, v in want.items())


# ---------------------------------------------------------------------------
# validation and eval (ROADMAP C8)
# ---------------------------------------------------------------------------


def jax_reconstruction(jax_v3, x, eps):
    """The spectral distance of the JAX `train=False` model's reconstruction
    of x [B, T, 1] with the reparametrization noise eps [B, T_lat, D]."""
    m, v = jax_v3["eval_model"], jax_v3["learned"]
    z = jax.jit(partial(m.apply, method="encode"))(v, jnp.asarray(x))
    mean, scale = jnp.split(z, 2, axis=-1)
    zs = mean + (jax.nn.softplus(scale) + 1e-4) * jnp.asarray(eps)
    y = jax.jit(partial(m.apply, method="decode"))(v, zs)[:, : x.shape[1]]
    return float(sum(jax_build_audio_distance(jax_v3["cfg"])(jnp.asarray(x), y).values()))


def test_validation_runs_in_eval_mode(jax_v3, tmp_path, monkeypatch):
    cfg = config.compose(["v3"], TINY)
    st = create_train_state(cfg, device="cpu")
    st.model.load_state_dict(jax_v3["port"].state_dict())
    st.model.train()
    st.ema = None  # validation would swap in the EMA weights
    x = (np.random.default_rng(5).standard_normal((B, 1, N_SIGNAL)) * 0.1).astype(np.float32)
    eps = np.random.default_rng(6).standard_normal(
        (B, N_SIGNAL // cfg.decimation(), 4)).astype(np.float32)
    monkeypatch.setattr(loop, "draw_noise", lambda *a: LatentDraws(eps=to_port(eps)))

    class Val:
        def __len__(self):
            return 1

        def epoch(self, _):
            yield x

    logger = MetricsLogger(str(tmp_path))
    val, _ = loop.run_validation(cfg, st, Val(), loop.build_audio_distance(cfg), logger, 1, 0)
    logger.close()
    assert st.model.training  # its mode put back
    want = jax_reconstruction(jax_v3, x.transpose(0, 2, 1), eps)
    assert abs(val - want) <= LOSS_TOL * want
    with torch.no_grad():  # the same pass in training mode (AdaIN the identity) differs
        zs, _ = st.model.reparametrize(st.model.encode(torch.from_numpy(x)),
                                       LatentDraws(eps=to_port(eps)))
        y = st.model.decode(zs)
    train_mode = float(sum(loop.build_audio_distance(cfg)(torch.from_numpy(x), y).values()))
    assert abs(train_mode - want) > 1e-2 * want


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A 52-record store (one validation record) of a seeded tone and noise."""
    root = tmp_path_factory.mktemp("torch_v3")
    (root / "corpus").mkdir()
    t = np.arange(52 * N_SIGNAL) / 44100
    wav = 0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * np.random.default_rng(0).standard_normal(
        t.size)
    wavfile.write(root / "corpus" / "a.wav", 44100, (wav * 32767).astype(np.int16))
    _cli(["preprocess", "--input_path", root / "corpus", "--output_path", root / "db",
          "--num_signal", N_SIGNAL, "--workers", 2])
    return root


def _cli(args):
    out = io.StringIO()
    with redirect_stdout(out):
        code = cli.main([str(a) for a in args])
    assert code == 0, out.getvalue()[-2000:]
    return out.getvalue()


def test_evaluate_runs_in_eval_mode(jax_v3, corpus, monkeypatch):
    """`evaluate` of a checkpoint with learned AdaIN statistics against the
    JAX `train=False` model on the batch it reads, with the same noise."""
    cfg = config.compose(["v3"], TINY)
    cfg.data.n_signal = N_SIGNAL
    st = create_train_state(cfg, device="cpu")
    st.model.load_state_dict(jax_v3["port"].state_dict())
    run = corpus / "eval_run"
    run.mkdir()
    (run / "config.json").write_text(config.snapshot(cfg))
    save_checkpoint(str(run), st)
    seen = []

    def draws(cfg_, x, generator):
        seen.append(x.numpy())
        eps = np.random.default_rng(7).standard_normal(
            (x.shape[0], x.shape[-1] // cfg.decimation(), 4)).astype(np.float32)
        seen.append(eps)
        return LatentDraws(eps=to_port(eps))

    monkeypatch.setattr(port_evaluate, "draw_noise", draws)
    out = port_evaluate.evaluate(str(run), str(corpus / "db"), split="all", batch=2,
                                 max_batches=1, device="cpu")
    x, eps = seen
    want = jax_reconstruction(jax_v3, x.transpose(0, 2, 1), eps)
    assert out["n_clips"] == 2 and abs(out["spectral_distance"] - want) <= LOSS_TOL * want


# ---------------------------------------------------------------------------
# export and the artifact's AdaIN attributes
# ---------------------------------------------------------------------------


def _peek_draws(art, n_calls):
    """The keys the JAX artifact's next `n_calls` calls draw their latent noise from."""
    k, keys = art._rng, []
    for _ in range(n_calls):
        k, _ = jax.random.split(k)
        k, r2 = jax.random.split(k)
        keys.append(r2)
    return keys


@pytest.fixture(scope="module")
def artifacts(jax_v3, tmp_path_factory):
    """Both packages' streaming mono v3 artifacts from one train state (its
    AdaIN collection as initialized: nothing learned)."""
    root = tmp_path_factory.mktemp("v3_export")
    state = jax_v3["state"]
    buffers = dict(state.model_state["buffers"])
    buffers["fidelity"] = jnp.asarray(FIDELITY, jnp.float32)
    state = state.replace(model_state={**state.model_state, "buffers": buffers})
    jcfg = jax_config.compose(["v3"], TINY)
    jcfg.data.n_signal = N_SIGNAL
    jax_run = root / "jax_run"
    jax_run.mkdir()
    (jax_run / "config.json").write_text(jax_config.snapshot(jcfg))
    jax_save_checkpoint(str(jax_run), 1, jax.device_get(state))
    cfg = config.compose(["v3"], TINY)
    cfg.data.n_signal = N_SIGNAL
    pstate = create_train_state(cfg, device="cpu")
    from_jax_variables(pstate.model, as_np({"params": state.gen_params, **{
        k: v for k, v in state.model_state.items() if k != "cache"}}))
    port_run = root / "port_run"
    port_run.mkdir()
    (port_run / "config.json").write_text(config.snapshot(cfg))
    save_checkpoint(str(port_run), pstate)
    jpath = jax_export_model(run=str(jax_run), streaming=True, output=str(root / "jax_art"))
    ppath = export_model(run=str(port_run), streaming=True, output=str(root / "port_art"),
                         device="cpu")
    return jpath, ppath


def test_artifact_attributes_match_jax(artifacts):
    """The manifest's attributes, then a stream that learns a target clip,
    learns a source clip and transfers, against the JAX artifact (its draws
    injected); offline calls read the state; resets bring back the identity."""
    jpath, ppath = artifacts
    theirs, mine = JaxExportedRAVE(jpath), ExportedRAVE(ppath, device="cpu")
    manifest = json.loads((Path(ppath) / "manifest.json").read_text())
    for key in ("attributes", "attribute_ops"):
        assert manifest[key] == theirs.manifest[key] and manifest[key]
    leaves = manifest["aot"]["forward_step"]["state_leaves"]
    for ops in manifest["attribute_ops"].values():
        for op in ops:
            assert sum(name.endswith(op["leaf"]) for name in leaves) == 8
    assert mine.latent_size == mine.full_latent_size == 4
    block, frames = mine.block_size, mine.block_size // mine.cfg.decimation()
    rng = np.random.default_rng(8)
    target = (rng.standard_normal((1, 2 * block, 1)) * 0.05 - 0.1).astype(np.float32)
    source = (rng.standard_normal((1, 2 * block, 1)) * 0.5).astype(np.float32)

    def stream(x):
        want, got = [], []
        for i in range(x.shape[1] // block):
            xb = x[:, i * block:(i + 1) * block]
            k1, _ = _peek_draws(theirs, 2)
            eps = to_port(jax.random.normal(k1, (1, frames, 4)))
            want.append(np.asarray(theirs.forward(jnp.asarray(xb), streaming=True)))
            got.append(from_port(mine.forward(to_port(xb), streaming=True, eps=eps)))
        assert rel_err(np.concatenate(got, 1), np.concatenate(want, 1)) <= MODEL_TOL
        adain = convert_tree(mine.model, as_np(theirs.variables["adain"]))
        state = {name: s for (name, _, _), s in zip(mine.slots, mine.state)}
        for name, value in adain.items():
            assert rel_err(state[name].numpy(), value) <= MODEL_TOL, name
        return np.concatenate(got, 1)

    def offline(x):
        (k,) = _peek_draws(theirs, 1)
        want = np.asarray(theirs.forward(jnp.asarray(x)))
        before = [s.clone() for s in mine.state]
        got = from_port(mine.forward(to_port(x), eps=to_port(jax.random.normal(
            k, (1, x.shape[1] // mine.cfg.decimation(), 4)))))
        assert all(torch.equal(a, b) for a, b in zip(before, mine.state))
        assert rel_err(got, want) <= MODEL_TOL

    eps = torch.from_numpy(rng.standard_normal((1, 4, source.shape[1] // mine.cfg.decimation()))
                           .astype(np.float32))
    identity = from_port(mine.forward(to_port(source), eps=eps))
    offline(source)
    for art in (theirs, mine):
        art.set_learn_target(True)
    stream(target)
    for art in (theirs, mine):
        art.set_learn_target(False)
        art.set_learn_source(True)
    stream(source)
    for art in (theirs, mine):
        art.set_learn_source(False)
    stream(source)  # the transfer
    offline(source)
    assert rel_err(from_port(mine.forward(to_port(source), eps=eps)), identity) > 1e-2
    for art in (theirs, mine):
        art.reset_target()
        art.reset_source()
        art.reset_stream()
    stream(source)
    offline(source)
    np.testing.assert_array_equal(from_port(mine.forward(to_port(source), eps=eps)), identity)


def test_step_programs_match_eager_with_adain(artifacts):
    """Each `.pt2` program against the eager step over 3 blocks while the
    target learns: bit-equal outputs and state, AdaIN's buffers included."""
    art = ExportedRAVE(artifacts[1], device="cpu", seed=5)
    names = [name for name, _, _ in stream_slots(art.model)]
    for method in ("encode", "decode", "forward"):
        art.reset_target()
        art.reset_stream()
        art.set_learn_target(True)
        program = art.load_program(method)
        entry = art.manifest["aot"][f"{method}_step"]
        assert entry["state_leaves"] == names
        state = [s.clone() for s in art.state]
        shape = entry["inputs"][entry["n_state"]]["shape"]
        x = torch.from_numpy(np.random.default_rng(3).standard_normal((3, *shape))
                             .astype(np.float32) * 0.3)
        for i in range(3):
            seed = art.next_seed()
            y_eager = getattr(art, method)(x[i], streaming=True, seed=seed)
            y_prog, state = program(state, x[i], torch.tensor(seed))
            assert torch.equal(y_prog, y_eager), (method, i)
            assert all(torch.equal(a, b) for a, b in zip(state, art.state)), (method, i)
        n_y = [s for n, s in zip(names, art.state) if n.endswith("num_update_y")]
        half = {"encode": "encoder.", "decode": "decoder.", "forward": ""}[method]
        assert all(float(s) == (3.0 if n.startswith(half) else 0.0)
                   for n, s in zip([n for n in names if n.endswith("num_update_y")], n_y))


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


def test_cli_train_resume_eval_export_generate(corpus):
    """`cli train --config v3` 3 steps unbroken, and 2 resumed to 3 (a
    pre-warmup, an adversarial and a critic step): bit-equal checkpoints,
    AdaIN buffers included; then `eval`, `export --streaming` (its programs
    are held in the tests above) and `generate`."""
    def train(name, steps):
        args = ["train", "--device", "cpu", "--config", "v3", "--name", name, "--db_path",
                corpus / "db", "--out_path", corpus / "runs", "--batch", 2, "--n_signal",
                N_SIGNAL, "--workers", 2, "--val_every", 2, "--no_progress", "--max_steps",
                steps, "--device_data", "on"]
        for o in TINY + ["train.phase_1_duration=1", "train.valid_signal_crop=false"]:
            args += ["--override", o]
        return Path(_cli(args).strip().splitlines()[-1].removeprefix("run dir: "))

    unbroken = train("a", 3)
    train("b", 2)
    resumed = train("b", 3)
    final = [torch.load(list_checkpoints(str(r))[-1], weights_only=True)
             for r in (unbroken, resumed)]
    assert final[0]["step"] == final[1]["step"] == 3
    for part in ("model", "discriminator"):
        assert final[0][part].keys() == final[1][part].keys()
        for k, v in final[0][part].items():
            assert torch.equal(v, final[1][part][k]), (part, k)
    adain = [k for k in final[1]["model"] if k.rsplit(".", 1)[-1] in AdaIN.STATE]
    assert len(adain) == 64 and not any(k in final[1]["ema"] for k in adain)
    ev = json.loads(_cli(["eval", "--device", "cpu", "--run", resumed, "--db_path",
                          corpus / "db", "--split", "all", "--max_batches", 1]
                         ).strip().splitlines()[-1])
    assert ev["step"] == 3 and np.isfinite(ev["spectral_distance"])
    art = Path(_cli(["export", "--device", "cpu", "--run", resumed, "--streaming", "--output",
                     corpus / "art"]).strip().splitlines()[-1].removeprefix("exported: "))
    manifest = json.loads((art / "manifest.json").read_text())
    assert manifest["name"] == "v3" and len(manifest["attributes"]) == 4
    _cli(["generate", "--device", "cpu", "--model", art, "--input", corpus / "corpus" / "a.wav",
          "--out_path", corpus / "gen"])
    sr, y = wavfile.read(corpus / "gen" / "a_reconstructed.wav")
    assert sr == 44100 and y.shape == (52 * N_SIGNAL,)
