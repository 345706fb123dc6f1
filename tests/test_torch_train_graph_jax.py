"""The steps with their schedules on the device, against rave_tpu's jitted steps.

The port's steps read the generator's learning rate and the regularization's
beta from `state.schedule`'s 0-d tensors, filled from the global step before
each step (train/steps.py), as rave_tpu computes them inside its jitted
`gen_step` and `dis_step`. At the tiny v2 of tests/test_torch_train.py
(`phase_1_duration` 4, beta warmed up over 8 steps), from the same state and
draws, one step of each program on both sides of the warmup's end: the last
pre-warmup generator step (3: the learning rate on its ramp, beta rising),
the first critic step (4) and the first adversarial generator step (5: the
learning rate at its end value), in fp32, under `train.bf16` +
`train.bf16_dis` and under `train.remat`.

The JAX step's optimizer is swapped for one that hands back its gradients
(as in tests/test_torch_train.py). Held: the schedule's values (`gen_lr`,
`beta_factor`) to float32 rounding (1e-6), every loss and gradient at
test_torch_train.py's tolerances (fp32 and remat; remat against the JAX
remat step) or by test_torch_bf16.py's rule (bf16: no further from the JAX
fp32 step than twice the JAX bf16 step, floor 1e-3), and the port's Adam
update of that step against optax's Adam (rave_tpu's transforms) on the
port's own gradients at the step's learning rate: within 1e-2 of the
update's size (the float32 parameters round the difference; the ramp's
neighbouring steps differ by 40% or more). The pre-warmup step runs at `distance.log_epsilon=
1e-3` in every mode: at v2's 1e-7 the float32 gradient of some draws is
over 1e-2 from float64 in both packages (6e-3 for JAX's, 1.7e-2 for the
port's at this step's draw: ROADMAP C4, C6), so the gradients could not be
held to test_torch_train.py's 5e-3.
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
from rave_tpu.train import schedules as jax_schedules
from rave_tpu.train import state as jax_state
from rave_tpu.train import steps as jax_steps
from rave_tpu_torch.config import compose
from rave_tpu_torch.models.blocks import LatentDraws
from rave_tpu_torch.train.state import create_train_state
from rave_tpu_torch.train.steps import build_train_steps
from rave_tpu_torch.utils.convert import convert_tree, from_jax_variables


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Two intra-op threads, as the suite's other torch files run beside its
    other workers: the default (one per core) in every worker oversubscribes
    the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


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
MODES = {"fp32": [], "bf16": ["train.bf16=true", "train.bf16_dis=true"],
         "remat": ["train.remat=true"]}
LOG_EPS = ["distance.log_epsilon=1e-3"]
CROP = (3, 2)
N_SIGNAL = 8192
# (program, global step, warmed, rng seed) on both sides of phase_1_duration
PHASES = [("gen", 3, False, 21), ("dis", 4, True, 22), ("gen", 5, True, 23)]
PHASE_IDS = ["gen-prewarmup-3", "dis-4", "gen-adversarial-5"]
SCHEDULE_TOL, LOSS_TOL, UPDATE_TOL, FLOOR = 1e-6, 1e-4, 1e-2, 1e-3
GRAD_TOL = {False: 5e-3, True: 1e-3}  # by `warmed` (tests/test_torch_train.py)


def grad_stash():
    """An optax transform that updates nothing and keeps the gradient as its state."""
    def init(params):
        return jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        return jax.tree_util.tree_map(jnp.zeros_like, grads), grads

    return optax.GradientTransformation(init, update)


def extra(which: str, warmed: bool) -> list:
    """The pre-warmup step runs at log_epsilon 1e-3 (ROADMAP C4, C6)."""
    return LOG_EPS if which == "gen" and not warmed else []


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's steps from one state: each phase in fp32 (bf16's
    referee), bf16 and remat."""
    cfg = jax_compose(["v2"], TINY)
    model = jax_build_rave(cfg, n_channels=1, train=True)
    dis = jax_build_discriminator(cfg, n_channels=1)
    state = jax_state.create_train_state(cfg, model, dis, jax.random.key(0), n_signal=N_SIGNAL)
    x = (np.random.default_rng(0).standard_normal((2, N_SIGNAL, 1)) * 0.1).astype(np.float32)
    variables = {"params": state.gen_params, **state.model_state}
    T_lat = N_SIGNAL // cfg.decimation()

    def noise(rng):
        """The step's eps: reparametrize a zero latent (mean 0, std s) with its rng."""
        z0 = jnp.zeros((2, T_lat, 2 * cfg.latent_size), jnp.float32)
        zs, _ = model.apply(variables, z0, rngs={"noise": rng},
                            method=lambda m, z: m.reparametrize(z))
        return np.asarray(zs / (jax.nn.softplus(0.0) + 1e-4))

    def run(overrides, which, step, warmed, seed):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_steps, "make_optimizers", lambda c: (grad_stash(), grad_stash()))
            steps = jax_steps.build_train_steps(jax_compose(["v2"], TINY + overrides), model,
                                                dis, crop_frames=CROP)
        s0 = jax.tree_util.tree_map(jnp.array, state.replace(step=jnp.asarray(step, jnp.int32)))
        rng = jax.random.key(seed)
        if which == "gen":
            s1, m = steps["gen"](s0, jnp.asarray(x), rng, warmed=warmed, quantize=False)
        else:
            s1, m = steps["dis"](s0, jnp.asarray(x), rng, quantize=False)
        return {"metrics": {k: float(v) for k, v in m.items()},
                "grads": jax.tree_util.tree_map(np.asarray,
                                                s1.gen_opt if which == "gen" else s1.dis_opt),
                "eps": noise(rng)}

    out = {}
    for which, step, warmed, seed in PHASES:
        phase, more = (which, warmed), extra(which, warmed)
        for mode in ("fp32", "bf16", "remat"):
            if mode == "remat" and which == "dis":  # no remat in a critic step
                out[mode, phase] = out["fp32", phase]
            else:
                out[mode, phase] = run(MODES[mode] + more, which, step, warmed, seed)
    as_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    return {"x": x, "gen_params": as_np(state.gen_params),
            "buffers": as_np(state.model_state["buffers"]),
            "dis_params": as_np(state.dis_params), "steps": out}


def to_port(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1)))


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() or 1e-3))


def loss_distance(metrics, ref) -> float:
    """The largest relative difference of any metric from the referee's."""
    return max(abs(float(metrics[k]) - v) / max(abs(v), 1e-2) for k, v in ref.items())


def grad_distance(grads, ref) -> float:
    """Global relative L2 distance over every tensor: |g - ref| / |ref|."""
    num = sum(float(np.sum((np.asarray(grads[k], np.float64) - ref[k]) ** 2)) for k in ref)
    den = sum(float(np.sum(np.asarray(ref[k], np.float64) ** 2)) for k in ref)
    return (num / den) ** 0.5


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("which,step,warmed,seed", PHASES, ids=PHASE_IDS)
def test_step_with_device_schedule_matches_jax(jax_run, mode, which, step, warmed, seed):
    overrides = MODES[mode] + extra(which, warmed)
    cfg = compose(["v2"], TINY + overrides)
    st = create_train_state(cfg, seed=0, device="cpu")
    from_jax_variables(st.model, {"params": jax_run["gen_params"], "buffers": jax_run["buffers"]})
    from_jax_variables(st.discriminator, {"params": jax_run["dis_params"]})
    st.ema = {n: p.detach().clone() for n, p in st.model.named_parameters()}
    st.step = step
    module = st.model if which == "gen" else st.discriminator
    before = {n: p.detach().clone() for n, p in module.named_parameters()}
    steps = build_train_steps(cfg, CROP)
    phase = (which, warmed)
    ref = jax_run["steps"][mode, phase]
    x = to_port(jax_run["x"])
    draws = LatentDraws(eps=to_port(ref["eps"]))
    metrics = (steps["gen"](st, x, warmed, draws=draws) if which == "gen"
               else steps["dis"](st, x, draws=draws))
    assert st.step == step + 1
    assert set(metrics) == set(ref["metrics"])
    assert all(torch.is_tensor(v) and v.dim() == 0 for v in metrics.values())

    t = cfg.train
    lr = jax_schedules.gen_lr_schedule(t.gen_lr, t.lr_end_factor, t.phase_1_duration)(step)
    for k in ("gen_lr", "beta_factor"):
        if k in ref["metrics"]:
            assert abs(float(metrics[k]) - ref["metrics"][k]) <= SCHEDULE_TOL * ref["metrics"][k]
    if which == "gen":
        assert float(metrics["gen_lr"]) == pytest.approx(float(lr), rel=SCHEDULE_TOL)

    grads = {n: p.grad.numpy() for n, p in module.named_parameters()}
    want = convert_tree(module, ref["grads"])
    if mode == "bf16":
        referee = jax_run["steps"]["fp32", phase]
        ref32, jax16 = convert_tree(module, referee["grads"]), want
        loss_jax = loss_distance(ref["metrics"], referee["metrics"])
        loss_port = loss_distance(metrics, referee["metrics"])
        grad_jax, grad_port = grad_distance(jax16, ref32), grad_distance(grads, ref32)
        assert loss_port <= max(2 * loss_jax, FLOOR), (loss_port, loss_jax)
        assert grad_port <= max(2 * grad_jax, FLOOR), (grad_port, grad_jax)
    else:
        for k, v in ref["metrics"].items():
            assert abs(float(metrics[k]) - v) <= LOSS_TOL * max(abs(v), 1e-2), (k, v)
        for name, g in grads.items():
            assert rel_err(g, want[name]) <= GRAD_TOL[warmed], name

    # the Adam update at the step's learning rate, on the port's own gradients
    gen_tx, dis_tx = jax_state.make_optimizers(jax_compose(["v2"], TINY + overrides))
    tx = gen_tx if which == "gen" else dis_tx
    params = {n: jnp.asarray(p.numpy()) for n, p in before.items()}
    upd, _ = tx.update({n: jnp.asarray(g) for n, g in grads.items()}, tx.init(params), params)
    if which == "gen":
        upd = jax.tree_util.tree_map(lambda u: -lr * u, upd)
    size = max(float(jnp.abs(u).max()) for u in upd.values())
    for n, p in module.named_parameters():
        assert float(np.abs(p.detach().numpy() - (params[n] + upd[n])).max()) <= UPDATE_TOL * size, n
