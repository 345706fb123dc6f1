"""The v2 training step: rave_tpu_torch against rave_tpu, one step of each phase.

Both packages build the tiny v2 of tests/test_train.py from their own config;
the JAX model's and critic's variables go into the port through
`from_jax_variables`. From the same state, on the same seeded waveform and
the same reparametrization noise (recovered from the JAX step's rng), each
package runs one pre-warmup generator step, one adversarial generator step
and one critic step. The JAX step runs unmodified except for its optimizer:
`make_optimizers` is swapped for a transform whose state after an update is
the gradient itself, so the step hands back its exact gradients.

Tolerances: every loss term at 1e-4 relative (float32 through ~30 layers,
FFTs and critic stacks summed in other orders). Every gradient relative to
the tensor's max (1e-3 where the reference is all zero: the critics' last
bias under the hinge loss, a sum of +-1/N terms that cancel exactly, where
float32 leaves ~2e-7), at 1e-3
in the adversarial and critic steps; 5e-3 in the pre-warmup step, whose
loss is the log-spectral distance alone. There float32 itself is that far
off: against the same step run by the port in float64, the JAX package's
float32 gradients err by up to 1.8e-3 and the port's by up to 2.7e-3 (the
small encoder tensors); in the adversarial step, by 8.9e-4 and 8.8e-5. The
optimizer is held to optax on identical gradients at 1e-6, the schedules to
float32 rounding (the JAX package evaluates them in float32), and the
receptive field exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rave_tpu.config import compose as jax_compose
from rave_tpu.factory import build_discriminator as jax_build_discriminator
from rave_tpu.factory import build_rave as jax_build_rave
from rave_tpu.train import analysis as jax_analysis
from rave_tpu.train import schedules as jax_schedules
from rave_tpu.train import state as jax_state
from rave_tpu.train import steps as jax_steps
from rave_tpu_torch.config import compose
from rave_tpu_torch.models.blocks import LatentDraws
from rave_tpu_torch.ops.kernels import dilated_unit
from rave_tpu_torch.train import schedules
from rave_tpu_torch.train.analysis import crop_frames, receptive_field
from rave_tpu_torch.train.state import create_train_state, make_optimizers, update_ema
from rave_tpu_torch.train.steps import build_train_steps, pick_phase
from rave_tpu_torch.utils.convert import convert_tree, from_jax_variables

TINY = [
    "capacity=2",
    "discriminator.capacity=2",
    "latent_size=4",
    "ratios=[4,4,2]",
    "dilations=[[1],[1],[1]]",
    "distance.scales=[512,256]",
    "train.phase_1_duration=4",
    "train.update_discriminator_every=2",
    "train.beta_warmup_len=8",
    "train.ema=0.99",
]
CROP = (3, 2)  # band frames; asymmetric so a swapped crop shows
N_SIGNAL = 8192
# (phase, global step, warmed, rng seed): pre-warmup gen, adversarial gen, critic
PHASES = [("gen", 1, False, 11), ("gen", 5, True, 12), ("dis", 6, True, 13)]
LOSS_TOL = 1e-4
GRAD_TOL = {False: 5e-3, True: 1e-3}  # by `warmed`; see the module docstring


def rel_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() or 1e-3))


def grad_stash():
    """An optax transform that updates nothing and keeps the gradient as its state."""
    def init(params):
        return jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        return jax.tree_util.tree_map(jnp.zeros_like, grads), grads

    return optax.GradientTransformation(init, update)


@pytest.fixture(scope="module")
def jax_run():
    cfg = jax_compose(["v2"], TINY)
    model = jax_build_rave(cfg, n_channels=1, train=True)
    dis = jax_build_discriminator(cfg, n_channels=1)
    state = jax_state.create_train_state(cfg, model, dis, jax.random.key(0), n_signal=N_SIGNAL)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_steps, "make_optimizers", lambda c: (grad_stash(), grad_stash()))
        steps = jax_steps.build_train_steps(cfg, model, dis, crop_frames=CROP)
    x = (np.random.default_rng(0).standard_normal((2, N_SIGNAL, 1)) * 0.1).astype(np.float32)
    variables = {"params": state.gen_params, **state.model_state}
    T_lat = N_SIGNAL // cfg.decimation()

    def noise(rng):
        """The step's eps: reparametrize a zero latent (mean 0, std s) with its rng."""
        z0 = jnp.zeros((2, T_lat, 2 * cfg.latent_size), jnp.float32)
        zs, _ = model.apply(variables, z0, rngs={"noise": rng},
                            method=lambda m, z: m.reparametrize(z))
        return np.asarray(zs / (jax.nn.softplus(0.0) + 1e-4))

    out = {}
    for which, step, warmed, seed in PHASES:
        s0 = jax.tree_util.tree_map(jnp.array, state.replace(step=jnp.asarray(step, jnp.int32)))
        rng = jax.random.key(seed)
        if which == "gen":
            s1, m = steps["gen"](s0, jnp.asarray(x), rng, warmed=warmed, quantize=False)
            grads = s1.gen_opt
        else:
            s1, m = steps["dis"](s0, jnp.asarray(x), rng, quantize=False)
            grads = s1.dis_opt
        out[(which, warmed)] = {
            "metrics": {k: float(v) for k, v in m.items()},
            "grads": jax.tree_util.tree_map(np.asarray, grads),
            "eps": noise(rng),
            "step": int(s1.step),
        }
    as_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    return {"x": x, "gen_params": as_np(state.gen_params),
            "buffers": as_np(state.model_state["buffers"]),
            "dis_params": as_np(state.dis_params), "phases": out}


def port_state(jax_run, step):
    cfg = compose(["v2"], TINY)
    st = create_train_state(cfg, seed=0, device="cpu")
    from_jax_variables(st.model, {"params": jax_run["gen_params"], "buffers": jax_run["buffers"]})
    from_jax_variables(st.discriminator, {"params": jax_run["dis_params"]})
    st.ema = {n: p.detach().clone() for n, p in st.model.named_parameters()}
    st.step = step
    return cfg, st


def to_port(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1)))


@pytest.mark.parametrize("which,step,warmed,seed", PHASES,
                         ids=["gen-prewarmup", "gen-adversarial", "dis"])
def test_step_matches_jax(jax_run, which, step, warmed, seed):
    ref = jax_run["phases"][(which, warmed)]
    cfg, st = port_state(jax_run, step)
    steps = build_train_steps(cfg, CROP)
    x, draws = to_port(jax_run["x"]), LatentDraws(eps=to_port(ref["eps"]))
    gen_before = {n: p.detach().clone() for n, p in st.model.named_parameters()}
    dis_before = {n: p.detach().clone() for n, p in st.discriminator.named_parameters()}
    launches = dilated_unit.launches
    if which == "gen":
        metrics = steps["gen"](st, x, warmed, draws=draws)
    else:
        metrics = steps["dis"](st, x, draws=draws)
    assert dilated_unit.launches == launches  # CPU: the plain unit only
    assert st.step == ref["step"] == step + 1

    assert set(metrics) == set(ref["metrics"])
    for k, want in ref["metrics"].items():
        got = float(metrics[k])
        assert abs(got - want) <= LOSS_TOL * max(abs(want), 1e-2), (k, got, want)

    module = st.model if which == "gen" else st.discriminator
    want = convert_tree(module, ref["grads"])
    got = {n: p.grad for n, p in module.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        assert g is not None, name
        assert rel_err(g.numpy(), want[name]) <= GRAD_TOL[warmed], name
    if warmed and which == "gen":  # the frozen encoder: zero gradient, like JAX's
        assert all(not st.model.get_parameter(n).grad.any() for n in got
                   if n.startswith("encoder."))

    # the step moved what it trains and nothing else
    moved = lambda m, before: [n for n, p in m.named_parameters()  # noqa: E731
                               if not torch.equal(p, before[n])]
    if which == "gen":
        assert moved(st.model, gen_before) and not moved(st.discriminator, dis_before)
        assert any(not torch.equal(st.ema[n], gen_before[n]) for n in st.ema)
    else:
        assert moved(st.discriminator, dis_before) and not moved(st.model, gen_before)


def test_dis_full_metrics_only_adds_logging(jax_run):
    cfg, st = port_state(jax_run, 6)
    x = to_port(jax_run["x"])
    draws = LatentDraws(eps=to_port(jax_run["phases"][("dis", True)]["eps"]))
    lite = build_train_steps(cfg, CROP)["dis"](st, x, draws=draws)
    assert "loss_gen" not in lite and "multiband_spectral_distance" not in lite
    full_cfg = compose(["v2"], TINY + ["train.dis_full_metrics=true"])
    _, st2 = port_state(jax_run, 6)
    full = build_train_steps(full_cfg, CROP)["dis"](st2, x, draws=draws)
    assert "loss_gen" in full and "multiband_spectral_distance" in full
    assert float(full["loss_dis"]) == float(lite["loss_dis"])
    for a, b in zip(st.discriminator.parameters(), st2.discriminator.parameters()):
        assert torch.equal(a, b)


def test_pick_phase_and_schedules_match_jax():
    for overrides in (TINY, []):
        cfg_j, cfg_p = jax_compose(["v2"], overrides), compose(["v2"], overrides)
        t = cfg_p.train
        steps = list(range(0, 40)) + [999_999, 1_000_000, 1_000_001, 1_000_004, 5_000_000]
        for s in steps:
            assert pick_phase(cfg_p, s) == jax_steps.pick_phase(cfg_j, s), s
            beta_j = float(jax_schedules.beta_factor(s, t.beta_initial, t.beta_target,
                                                     t.beta_warmup_len, t.beta_log_warmup))
            beta_p = schedules.beta_factor(s, t.beta_initial, t.beta_target,
                                           t.beta_warmup_len, t.beta_log_warmup)
            # float32 exp of an argument up to |log 1e-6| = 14: ~1e-6 relative
            assert beta_p == pytest.approx(beta_j, rel=1e-5), s
            lr_j = float(jax_schedules.gen_lr_schedule(t.gen_lr, t.lr_end_factor,
                                                       t.phase_1_duration)(s))
            lr_p = schedules.gen_lr_schedule(t.gen_lr, t.lr_end_factor, t.phase_1_duration)(s)
            assert lr_p == pytest.approx(lr_j, rel=1e-6), s
    for s in (0, 3, 7, 8, 9, 20):  # the linear ramp
        want = float(jax_schedules.beta_factor(s, 0.1, 1.0, 8, log_warmup=False))
        assert schedules.beta_factor(s, 0.1, 1.0, 8, log_warmup=False) == pytest.approx(
            want, rel=1e-6)
    for wq in (None, -1, 3):
        for s in range(6):
            assert schedules.quantize_enabled(s, wq) == jax_schedules.quantize_enabled(s, wq)


def test_optimizers_and_ema_match_optax():
    """Three updates on identical gradients: the generator's Adam with its lr
    from the global step, the critic's at dis_lr, and the EMA."""
    cfg = compose(["v2"], TINY)
    t = cfg.train
    st = create_train_state(cfg, seed=0, device="cpu")
    gen_tx, dis_tx = jax_state.make_optimizers(jax_compose(["v2"], TINY))
    gen_lr = schedules.gen_lr_schedule(t.gen_lr, t.lr_end_factor, t.phase_1_duration)
    modules = {"gen": st.model, "dis": st.discriminator}
    gen_opt, dis_opt = make_optimizers(cfg, st.model, st.discriminator)
    # copies: jnp.asarray of a tensor's numpy view would alias the parameter
    ref = {k: {n: jnp.array(p.detach().numpy(), copy=True) for n, p in m.named_parameters()}
           for k, m in modules.items()}
    opt_state = {"gen": gen_tx.init(ref["gen"]), "dis": dis_tx.init(ref["dis"])}
    ema_j = dict(ref["gen"])
    ema_p = {n: p.detach().clone() for n, p in st.model.named_parameters()}
    rng = np.random.default_rng(0)
    for step in range(3):
        for k, m in modules.items():
            grads = {n: (rng.standard_normal(p.shape) * 10.0 ** rng.integers(-6, 0))
                     .astype(np.float32) for n, p in m.named_parameters()}
            for n, p in m.named_parameters():
                p.grad = torch.from_numpy(grads[n])
            if k == "gen":
                for group in gen_opt.param_groups:
                    group["lr"] = gen_lr(step)
                gen_opt.step()
                upd, opt_state[k] = gen_tx.update(grads, opt_state[k], ref[k])
                upd = jax.tree_util.tree_map(lambda u: -gen_lr(step) * u, upd)
            else:
                dis_opt.step()
                upd, opt_state[k] = dis_tx.update(grads, opt_state[k], ref[k])
            ref[k] = optax.apply_updates(ref[k], upd)
        update_ema(ema_p, st.model, t.ema)  # rave_tpu/train/steps.py:234-236
        ema_j = {n: ema_j[n] * t.ema + ref["gen"][n] * (1 - t.ema) for n in ema_j}
    for k, m in modules.items():
        for n, p in m.named_parameters():
            assert rel_err(p.detach().numpy(), ref[k][n]) <= 1e-6, (k, n)
    for n, e in ema_p.items():
        assert rel_err(e.numpy(), ema_j[n]) <= 1e-6, n


@pytest.mark.parametrize("names", [["v2"], ["v2", "causal"]], ids=["centered", "causal"])
def test_receptive_field_matches_jax(names):
    overrides = ["capacity=2", "latent_size=4", "ratios=[4,4,2]", "dilations=[[1,3],[1],[1]]"]
    cfg = compose(names, overrides)
    rf = receptive_field(cfg, device="cpu")
    assert rf == jax_analysis.receptive_field(jax_compose(names, overrides))
    assert crop_frames(cfg, rf) == (rf[0] // 16, rf[1] // 16)
    if "causal" in names:  # the causal output lags: nothing right of the probed sample
        assert rf[1] <= 0
