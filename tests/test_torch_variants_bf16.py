"""The v2 variants' bf16 steps: rave_tpu_torch against rave_tpu on the CPU.

`v2_small` (the noise synth) and `v2_nopqmf` (raw-waveform output) at
tests/test_torch_variants.py's tiny widths: each package runs one
pre-warmup generator step, one adversarial generator step and one critic
step from the same state (the JAX weights carried into the port by
`from_jax_variables`), in fp32 and with `train.bf16` + `train.bf16_dis`
(the CLI's `--bf16`), on the same waveform, reparametrization noise and
noise-synth uniforms (recorded from the JAX step that is compared,
tests/test_torch_variants.py::record_uniforms).

The rule is tests/test_torch_bf16.py's: the referee is the JAX package's
fp32 step, and the port's bf16 step may be no further from it than twice
the JAX bf16 step, or 1e-3, whichever is larger, for the losses (the
largest relative difference of any metric) and for the gradients (the
global relative L2 distance over every parameter). The pre-warmup step runs
at `distance.log_epsilon=1e-3` for the reason given there (ROADMAP C6), and
so does `v2_nopqmf`'s adversarial generator step: its decoder writes the
waveform that the full-band `log(|STFT| + eps)` loss reads, and at v2's
1e-7 the port's bf16 gradient is 0.97 from the JAX fp32 step where JAX's
bf16 one is 0.21 (0.126 against 0.131 at 1e-3; the port's fp32 step is
2.1e-4 from JAX's at 1e-7 and 1.1e-6 at 1e-3: C4, then C6's eager
rounding).
`test_nopqmf_adversarial_bf16_stock_epsilon_gap` pins that gap at 1e-7.
`v2_small`'s adversarial step holds at v2's own epsilon.

Mel input (`hybrid`, `v2_with_augs`) has no bf16 step in rave_tpu: its mel
front-end takes `jnp.fft.rfft` of bfloat16 frames, which raises. The port
refuses the same configuration when its steps are built (ROADMAP C14).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rave_tpu.factory import build_discriminator as jax_build_discriminator
from rave_tpu.factory import build_rave as jax_build_rave
from rave_tpu.train import state as jax_state
from rave_tpu.train import steps as jax_steps
from rave_tpu_torch.models.blocks import LatentDraws
from rave_tpu_torch.ops.kernels import dilated_unit
from rave_tpu_torch.train.state import create_train_state
from rave_tpu_torch.train.steps import build_train_steps
from rave_tpu_torch.utils.convert import convert_tree, from_jax_variables
from tests.test_torch_variants import (
    CROP, N_SIGNAL, TRAIN, grad_stash, preset, record_uniforms, to_port,
)

BF16 = ["train.bf16=true", "train.bf16_dis=true"]
LOG_EPS = ["distance.log_epsilon=1e-3"]
PRESETS = ["v2_small", "v2_nopqmf"]
# (phase, global step, warmed, rng seed): pre-warmup gen, adversarial gen, critic
PHASES = [("gen", 1, False, 11), ("gen", 5, True, 12), ("dis", 6, True, 13)]
PHASE_IDS = ["gen-prewarmup", "gen-adversarial", "dis"]
FLOOR = 1e-3  # of the bf16 bound (tests/test_torch_bf16.py)


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def phase_overrides(name: str, which: str, warmed: bool) -> list:
    """The log-spectral epsilon of a step (see the module's docstring)."""
    if which == "gen" and (not warmed or name == "v2_nopqmf"):
        return LOG_EPS
    return []


def loss_distance(metrics, ref) -> float:
    """The largest relative difference of any metric from the referee's."""
    return max(abs(float(metrics[k]) - v) / max(abs(v), 1e-2) for k, v in ref.items())


def grad_distance(grads, ref) -> float:
    """Global relative L2 distance over every tensor: |g - ref| / |ref|."""
    num = sum(float(np.sum((np.asarray(grads[k], np.float64) - ref[k]) ** 2)) for k in ref)
    den = sum(float(np.sum(np.asarray(ref[k], np.float64) ** 2)) for k in ref)
    return (num / den) ** 0.5


@pytest.fixture(scope="module", params=PRESETS)
def jax_runs(request):
    """The JAX package's three steps of `request.param` from one state, fp32
    and bf16: metrics, gradients, eps and the noise synth's uniforms."""
    name = request.param
    _, jcfg = preset(name, TRAIN)
    model = jax_build_rave(jcfg, n_channels=1, train=True)
    dis = jax_build_discriminator(jcfg, n_channels=1)
    state = jax_state.create_train_state(jcfg, model, dis, jax.random.key(0), n_signal=N_SIGNAL)
    x = (np.random.default_rng(0).standard_normal((2, N_SIGNAL, 1)) * 0.1).astype(np.float32)
    variables = {"params": state.gen_params, **state.model_state}
    T_lat = N_SIGNAL // jcfg.decimation()

    def eps(rng):
        """The step's eps: reparametrize a zero latent (mean 0, std s) with its rng."""
        z0 = jnp.zeros((2, T_lat, 2 * jcfg.latent_size), jnp.float32)
        zs, _ = model.apply(variables, z0, rngs={"noise": rng},
                            method=lambda m, z: m.reparametrize(z))
        return np.asarray(zs / (jax.nn.softplus(0.0) + 1e-4))

    out = {}
    # the held steps, then (v2_nopqmf) its adversarial step at v2's own log_epsilon
    runs = [(precision, flags, which, step, warmed, seed, phase_overrides(name, which, warmed))
            for precision, flags in (("fp32", []), ("bf16", BF16))
            for which, step, warmed, seed in PHASES]
    if name == "v2_nopqmf":
        runs += [(precision, flags, "gen", 5, True, 12, [], "stock")
                 for precision, flags in (("fp32", []), ("bf16", BF16))]
    for precision, flags, which, step, warmed, seed, extra, *stock in runs:
        _, jcfg_p = preset(name, TRAIN + flags + extra)
        with pytest.MonkeyPatch.context() as mp, record_uniforms() as drawn:
            mp.setattr(jax_steps, "make_optimizers", lambda c: (grad_stash(), grad_stash()))
            steps = jax_steps.build_train_steps(jcfg_p, model, dis, crop_frames=CROP)
            s0 = jax.tree_util.tree_map(jnp.array,
                                        state.replace(step=jnp.asarray(step, jnp.int32)))
            rng = jax.random.key(seed)
            if which == "gen":
                s1, m = steps["gen"](s0, jnp.asarray(x), rng, warmed=warmed, quantize=False)
                grads = s1.gen_opt
            else:
                s1, m = steps["dis"](s0, jnp.asarray(x), rng, quantize=False)
                grads = s1.dis_opt
            jax.block_until_ready(m)
        out[(precision, which, warmed, *stock)] = {
            "metrics": {k: float(v) for k, v in m.items()},
            "grads": jax.tree_util.tree_map(np.asarray, grads),
            "eps": eps(rng),
            "uniform": np.asarray(drawn[-1], np.float32) if drawn else None,
        }
    as_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    return {"name": name, "x": x, "gen_params": as_np(state.gen_params),
            "buffers": as_np(state.model_state["buffers"]),
            "dis_params": as_np(state.dis_params), "steps": out}


def port_step(jax_runs, overrides, which, step, warmed, ref):
    """One port step from the JAX state, on the draws of the JAX step `ref`:
    (metrics, {name: grad}, the module it trains)."""
    cfg, _ = preset(jax_runs["name"], TRAIN + overrides)
    st = create_train_state(cfg, seed=0, device="cpu")
    from_jax_variables(st.model, {"params": jax_runs["gen_params"],
                                  "buffers": jax_runs["buffers"]})
    from_jax_variables(st.discriminator, {"params": jax_runs["dis_params"]})
    st.step = step
    uniform = None if ref["uniform"] is None else torch.tensor(ref["uniform"])
    assert (uniform is None) == (not cfg.decoder.use_noise)
    draws = LatentDraws(eps=to_port(ref["eps"]), uniform=uniform)
    x = to_port(jax_runs["x"])
    steps = build_train_steps(cfg, CROP)
    metrics = (steps["gen"](st, x, warmed, draws=draws) if which == "gen"
               else steps["dis"](st, x, draws=draws))
    assert st.step == step + 1
    module = st.model if which == "gen" else st.discriminator
    return metrics, {n: p.grad.numpy() for n, p in module.named_parameters()}, module


@pytest.mark.parametrize("which,step,warmed,seed", PHASES, ids=PHASE_IDS)
def test_variant_bf16_step_matches_jax(jax_runs, which, step, warmed, seed):
    ref = jax_runs["steps"][("fp32", which, warmed)]
    ref16 = jax_runs["steps"][("bf16", which, warmed)]
    launches = dilated_unit.launches_bf16
    extra = phase_overrides(jax_runs["name"], which, warmed)
    metrics, grads, module = port_step(jax_runs, BF16 + extra, which, step, warmed, ref16)
    assert dilated_unit.launches_bf16 == launches  # CPU: the plain unit only
    assert set(metrics) == set(ref["metrics"])
    # the masters and their gradients stay fp32
    assert all(p.dtype == torch.float32 for p in module.parameters())
    assert all(g.dtype == np.float32 and np.isfinite(g).all() for g in grads.values())

    want, jax16 = convert_tree(module, ref["grads"]), convert_tree(module, ref16["grads"])
    assert set(grads) == set(want)
    loss_jax, loss_port = loss_distance(ref16["metrics"], ref["metrics"]), \
        loss_distance(metrics, ref["metrics"])
    grad_jax, grad_port = grad_distance(jax16, want), grad_distance(grads, want)
    assert loss_port <= max(2 * loss_jax, FLOOR), (loss_port, loss_jax)
    assert grad_port <= max(2 * grad_jax, FLOOR), (grad_port, grad_jax)


@pytest.mark.parametrize("name", ["hybrid", "v2_with_augs"])
def test_mel_input_bf16_refused_by_both(name):
    """rave_tpu's bf16 generator step with mel input raises in its rfft of
    bfloat16 frames; the port refuses the configuration when it builds the
    steps, with a ValueError that says why."""
    cfg, jcfg = preset(name, TRAIN + BF16 + ["train.valid_signal_crop=false"])
    model = jax_build_rave(jcfg, n_channels=1, train=True)
    dis = jax_build_discriminator(jcfg, n_channels=1)
    state = jax_state.create_train_state(jcfg, model, dis, jax.random.key(0), n_signal=N_SIGNAL)
    steps = jax_steps.build_train_steps(jcfg, model, dis, crop_frames=(0, 0))
    with pytest.raises(ValueError, match="RFFT input must be float32 or float64"):
        steps["gen"](state, jnp.zeros((2, N_SIGNAL, 1)), jax.random.key(1), warmed=False,
                     quantize=False)
    assert cfg.input_mode == "mel" and cfg.train.bf16
    with pytest.raises(ValueError, match="rfft of bfloat16"):
        build_train_steps(cfg, (0, 0))
    fp32, _ = preset(name, TRAIN + ["train.valid_signal_crop=false"])
    assert set(build_train_steps(fp32, (0, 0))) == {"gen", "dis"}


# ROADMAP C6 at v2's own log_epsilon (1e-7), v2_nopqmf's adversarial generator step:
# gradient distances from the JAX fp32 step as measured on the CPU, held within 25%
STOCK_JAX_BF16, STOCK_PORT_BF16, STOCK_MARGIN = 0.210, 0.972, 1.25


@pytest.mark.parametrize("jax_runs", ["v2_nopqmf"], indirect=True)
def test_nopqmf_adversarial_bf16_stock_epsilon_gap(jax_runs):
    """The gap that the 2x rule cannot hold, pinned (ROADMAP C6): at v2's own
    log_epsilon the port's fp32 step matches JAX's and both bf16 steps keep
    their losses within the rule, but the port's bf16 gradient is 0.97 from
    JAX's fp32 one where JAX's bf16 is 0.21. A further drift of either fails
    here; so does a repair that brings the port within twice JAX's distance,
    and then this step is held to the rule like the cases above."""
    ref = jax_runs["steps"][("fp32", "gen", True, "stock")]
    ref16 = jax_runs["steps"][("bf16", "gen", True, "stock")]
    metrics, grads, module = port_step(jax_runs, BF16, "gen", 5, True, ref16)
    metrics32, grads32, _ = port_step(jax_runs, [], "gen", 5, True, ref)
    want, jax16 = convert_tree(module, ref["grads"]), convert_tree(module, ref16["grads"])
    assert loss_distance(metrics32, ref["metrics"]) <= FLOOR
    assert grad_distance(grads32, want) <= FLOOR
    loss_jax, loss_port = loss_distance(ref16["metrics"], ref["metrics"]), \
        loss_distance(metrics, ref["metrics"])
    assert loss_port <= max(2 * loss_jax, FLOOR), (loss_port, loss_jax)
    grad_jax, grad_port = grad_distance(jax16, want), grad_distance(grads, want)
    assert STOCK_JAX_BF16 / STOCK_MARGIN <= grad_jax <= STOCK_JAX_BF16 * STOCK_MARGIN, grad_jax
    assert grad_port > max(2 * grad_jax, FLOOR), (
        f"C6 repaired at log_epsilon 1e-7 ({grad_port:.3f} within twice JAX's "
        f"{grad_jax:.3f}): hold this step to the rule")
    assert grad_port <= STOCK_PORT_BF16 * STOCK_MARGIN, grad_port
