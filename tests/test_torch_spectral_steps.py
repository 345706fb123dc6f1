"""The training steps with the spectral critic and the other distances:
rave_tpu_torch against rave_tpu.

One step of each program of `compose(["v2", "spectral_discriminator"])`
and one adversarial generator step with each other distance (`encodec`,
`instantaneous`, `num_mels`), from the same state and noise in both
packages (the JAX step's optimizer swapped for one that hands back its
gradients, as tests/test_torch_train.py does): losses within 1e-4, every
gradient within test_torch_train.py's tolerances of its tensor's max (1e-3
in the warmed steps, 5e-3 in the pre-warmup one); and the bf16 critic step
by test_torch_bf16.py's rule (the port no further from the JAX fp32 step
than twice the JAX bf16 step, floor 1e-3). The modules themselves:
tests/test_torch_spectral.py.
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
from rave_tpu.train import state as jax_state
from rave_tpu.train import steps as jax_steps
from rave_tpu_torch.config import compose
from rave_tpu_torch.models.blocks import LatentDraws
from rave_tpu_torch.train.state import create_train_state
from rave_tpu_torch.train.steps import build_train_steps
from rave_tpu_torch.utils.convert import convert_tree, from_jax_variables

SPECTRAL = ["discriminator.spectral_scales=[512,256]", "discriminator.encodec_capacity=4"]


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() or 1e-3))


def signal(shape, seed=0, scale=0.3):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def to_port(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 2, 1)))


TINY = ["capacity=2", "discriminator.capacity=2", "latent_size=4", "ratios=[4,4,2]",
        "dilations=[[1],[1],[1]]", "distance.scales=[512,256]", "train.phase_1_duration=4",
        "train.update_discriminator_every=2", "train.beta_warmup_len=8"]
CROP, N_SIGNAL = (3, 2), 8192
BF16 = ["train.bf16=true", "train.bf16_dis=true"]
LOSS_TOL, GRAD_TOL = 1e-4, {False: 5e-3, True: 1e-3}  # test_torch_train.py's, by `warmed`
# (which, global step, warmed, rng seed)
PRE, ADV, DIS = ("gen", 1, False, 11), ("gen", 5, True, 12), ("dis", 6, True, 13)
CASES = {  # id -> (presets, overrides, phase)
    "spectral-gen-prewarmup": (["v2", "spectral_discriminator"], SPECTRAL, PRE),
    "spectral-gen-adversarial": (["v2", "spectral_discriminator"], SPECTRAL, ADV),
    "spectral-dis": (["v2", "spectral_discriminator"], SPECTRAL, DIS),
    "spectral-dis-bf16": (["v2", "spectral_discriminator"], SPECTRAL + BF16, DIS),
    # not centered: every scale fits the 507 cropped band frames
    "encodec-gen-adversarial": (["v2"], ['distance.kind="encodec"',
                                         "distance.scales=[256,128]"], ADV),
    "instantaneous-gen-adversarial": (["v2"], ['distance.kind="instantaneous"'], ADV),
    "mel-gen-adversarial": (["v2"], ["distance.num_mels=16"], ADV),
}


def grad_stash():
    """An optax transform that updates nothing and keeps the gradient as its state."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree_util.tree_map(jnp.zeros_like, grads), grads))


def jax_step(names, overrides, phase):
    """The JAX package's step from its seed-0 state: (metrics, gradients,
    eps, the state's weights)."""
    which, step, warmed, seed = phase
    cfg = jax_compose(names, TINY + overrides)
    model = jax_build_rave(cfg, n_channels=1, train=True)
    dis = jax_build_discriminator(cfg, n_channels=1)
    state = jax_state.create_train_state(cfg, model, dis, jax.random.key(0), n_signal=N_SIGNAL)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_steps, "make_optimizers", lambda c: (grad_stash(), grad_stash()))
        steps = jax_steps.build_train_steps(cfg, model, dis, crop_frames=CROP)
    x = signal((2, N_SIGNAL, 1), seed=0, scale=0.1)
    as_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    out = {"x": x, "gen_params": as_np(state.gen_params),
           "buffers": as_np(state.model_state["buffers"]), "dis_params": as_np(state.dis_params)}
    s0 = jax.tree_util.tree_map(jnp.array, state.replace(step=jnp.asarray(step, jnp.int32)))
    rng = jax.random.key(seed)
    if which == "gen":
        s1, m = steps["gen"](s0, jnp.asarray(x), rng, warmed=warmed, quantize=False)
    else:
        s1, m = steps["dis"](s0, jnp.asarray(x), rng, quantize=False)
    variables = {"params": out["gen_params"], "buffers": out["buffers"]}
    z0 = jnp.zeros((2, N_SIGNAL // cfg.decimation(), 2 * cfg.latent_size), jnp.float32)
    zs, _ = model.apply(variables, z0, rngs={"noise": rng},
                        method=lambda mod, z: mod.reparametrize(z))
    return {**out, "metrics": {k: float(v) for k, v in m.items()},
            "grads": as_np(s1.gen_opt if which == "gen" else s1.dis_opt),
            "eps": np.asarray(zs / (jax.nn.softplus(0.0) + 1e-4))}


def port_step(ref, names, overrides, phase):
    which, step, warmed, _ = phase
    cfg = compose(names, TINY + overrides)
    st = create_train_state(cfg, seed=0, device="cpu")
    from_jax_variables(st.model, {"params": ref["gen_params"], "buffers": ref["buffers"]})
    from_jax_variables(st.discriminator, {"params": ref["dis_params"]})
    st.step = step
    steps = build_train_steps(cfg, CROP)
    x, draws = to_port(ref["x"]), LatentDraws(eps=to_port(ref["eps"]))
    metrics = (steps["gen"](st, x, warmed, draws=draws) if which == "gen"
               else steps["dis"](st, x, draws=draws))
    module = st.model if which == "gen" else st.discriminator
    return metrics, {n: p.grad.numpy() for n, p in module.named_parameters()}, module


def grad_distance(grads, ref) -> float:
    """Global relative L2 distance over every tensor: |g - ref| / |ref|."""
    num = sum(float(np.sum((np.asarray(grads[k], np.float64) - ref[k]) ** 2)) for k in ref)
    return (num / sum(float(np.sum(np.asarray(ref[k], np.float64) ** 2)) for k in ref)) ** 0.5


def loss_distance(metrics, ref) -> float:
    return max(abs(float(metrics[k]) - v) / max(abs(v), 1e-2) for k, v in ref.items())


@pytest.mark.parametrize("case", [c for c in CASES if not c.endswith("bf16")])
def test_step_matches_jax(case):
    names, overrides, phase = CASES[case]
    ref = jax_step(names, overrides, phase)
    metrics, grads, module = port_step(ref, names, overrides, phase)
    assert set(metrics) == set(ref["metrics"])
    for k, want in ref["metrics"].items():
        assert abs(float(metrics[k]) - want) <= LOSS_TOL * max(abs(want), 1e-2), (k, want)
    want = convert_tree(module, ref["grads"])
    assert set(grads) == set(want)
    for name, g in grads.items():
        assert rel_err(g, want[name]) <= GRAD_TOL[phase[2]], name


def test_bf16_critic_step_matches_jax():
    """The spectral critic under `train.bf16_dis`: its STFT in float32, the
    image cast back to bf16, the masters' gradients fp32."""
    names, overrides, phase = CASES["spectral-dis-bf16"]
    ref = jax_step(names, [o for o in overrides if o not in BF16], phase)
    ref16 = jax_step(names, overrides, phase)
    metrics, grads, module = port_step(ref, names, overrides, phase)
    assert all(p.dtype == torch.float32 for p in module.parameters())
    assert all(g.dtype == np.float32 and np.isfinite(g).all() for g in grads.values())
    want, jax16 = convert_tree(module, ref["grads"]), convert_tree(module, ref16["grads"])
    loss_jax, loss_port = (loss_distance(ref16["metrics"], ref["metrics"]),
                           loss_distance(metrics, ref["metrics"]))
    grad_jax, grad_port = grad_distance(jax16, want), grad_distance(grads, want)
    assert loss_port <= max(2 * loss_jax, 1e-3), (loss_port, loss_jax)
    assert grad_port <= max(2 * grad_jax, 1e-3), (grad_port, grad_jax)
    critic = module.discriminators_1
    img = critic(to_port(ref["x"]).to(torch.bfloat16))
    assert all(f.dtype == torch.bfloat16 for fs in img for f in fs)
