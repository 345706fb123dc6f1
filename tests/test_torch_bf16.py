"""The bf16 and remat training steps: rave_tpu_torch against rave_tpu on the CPU.

Both packages build the tiny v2 of tests/test_train.py; the JAX model's and
critic's variables go into the port, and each package runs one pre-warmup
generator step, one adversarial generator step and one critic step from the
same state, on the same seeded waveform and reparametrization noise (as in
tests/test_torch_train.py, whose optimizer swap hands back the JAX step's
gradients).

bf16 (`train.bf16` with `train.bf16_dis`, the CLI's `--bf16`): the referee
is the JAX package's fp32 step. XLA's CPU fusions skip bf16 roundings that
eager PyTorch makes between ops, so the two bf16 steps are not held to each
other: the port's bf16 step must be no further from the fp32 referee than
twice the JAX bf16 step's own distance from it, or 1e-3, whichever is
larger, for the losses (the largest relative difference of any metric) and
for the gradients (the global relative L2 distance over every parameter).
The pre-warmup step is compared with `distance.log_epsilon=1e-3`: at v2's
1e-7 the `log(|STFT| + eps)` loss weights near-empty bins by up to 1e7
(ROADMAP C4), and its cotangent, rounded to bf16 at every op of the eager
backward, buries the pre-warmup gradient in rounding noise many times its
norm, while XLA keeps fp32 intermediates inside its fusions (ROADMAP C6);
chip_smoke.py measures that case at full width. The other phases run v2's
own epsilon.

remat (`train.remat`): the port with and without it gives the same losses
and gradients to 1e-6 (the recompute is the same arithmetic), and its
remat step matches the JAX package's at test_torch_train.py's tolerances.

Also: the stft of a bf16 input is the stft of its fp32 upcast; the fused
unit's plain twin in bf16 against the JAX plain unit in bf16; the kernel
wrapper's input checks.
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
from rave_tpu.ops.kernels import dilated_unit as jax_unit
from rave_tpu.train import state as jax_state
from rave_tpu.train import steps as jax_steps
from rave_tpu_torch.config import compose
from rave_tpu_torch.factory import build_discriminator, build_rave
from rave_tpu_torch.models.blocks import LatentDraws
from rave_tpu_torch.nn.conv import get_padding
from rave_tpu_torch.ops.kernels import dilated_unit
from rave_tpu_torch.ops.stft import stft
from rave_tpu_torch.train.analysis import receptive_field
from rave_tpu_torch.train.state import create_train_state
from rave_tpu_torch.train.steps import build_train_steps
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
BF16 = ["train.bf16=true", "train.bf16_dis=true"]
REMAT = ["train.remat=true"]
CROP = (3, 2)
N_SIGNAL = 8192
LOG_EPS = ["distance.log_epsilon=1e-3"]
# (phase, global step, warmed, rng seed, overrides): pre-warmup gen, adversarial gen, critic
PHASES = [("gen", 1, False, 11, LOG_EPS), ("gen", 5, True, 12, []), ("dis", 6, True, 13, [])]
PHASE_IDS = ["gen-prewarmup", "gen-adversarial", "dis"]
FLOOR = 1e-3  # of the bf16 bound
EQUAL_TOL = 1e-6  # remat on vs off in the port
LOSS_TOL, GRAD_TOL = 1e-4, 5e-3  # port vs JAX, fp32 pre-warmup step (test_torch_train.py)


def grad_stash():
    """An optax transform that updates nothing and keeps the gradient as its state."""
    def init(params):
        return jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        return jax.tree_util.tree_map(jnp.zeros_like, grads), grads

    return optax.GradientTransformation(init, update)


def loss_distance(metrics, ref) -> float:
    """The largest relative difference of any metric from the referee's."""
    return max(abs(float(metrics[k]) - v) / max(abs(v), 1e-2) for k, v in ref.items())


def grad_distance(grads, ref) -> float:
    """Global relative L2 distance over every tensor: |g - ref| / |ref|."""
    num = sum(float(np.sum((np.asarray(grads[k], np.float64) - ref[k]) ** 2)) for k in ref)
    den = sum(float(np.sum(np.asarray(ref[k], np.float64) ** 2)) for k in ref)
    return (num / den) ** 0.5


def run_jax(phases, remat: bool = True):
    """The JAX package's steps from one state: fp32 and bf16 for each of
    `phases`, and fp32 with remat for the first (a pre-warmup generator step)."""
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

    def run(overrides, phases):
        out = {}
        for which, step, warmed, seed, extra in phases:
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jax_steps, "make_optimizers", lambda c: (grad_stash(), grad_stash()))
                steps = jax_steps.build_train_steps(
                    jax_compose(["v2"], TINY + overrides + extra), model, dis, crop_frames=CROP)
            s0 = jax.tree_util.tree_map(jnp.array,
                                        state.replace(step=jnp.asarray(step, jnp.int32)))
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
            }
        return out

    as_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    return {"x": x, "gen_params": as_np(state.gen_params),
            "buffers": as_np(state.model_state["buffers"]),
            "dis_params": as_np(state.dis_params),
            "fp32": run([], phases), "bf16": run(BF16, phases),
            "remat": run(REMAT, [phases[0][:4] + ([],)]) if remat else None}


@pytest.fixture(scope="module")
def jax_run():
    return run_jax(PHASES)


def to_port(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1)))


def port_step(jax_run, overrides, which, step, warmed):
    """One port step from the JAX state: (metrics, {name: grad}, the module it trains)."""
    cfg = compose(["v2"], TINY + overrides)
    assert cfg.distance.log_epsilon in (1e-7, 1e-3)
    st = create_train_state(cfg, seed=0, device="cpu")
    from_jax_variables(st.model, {"params": jax_run["gen_params"], "buffers": jax_run["buffers"]})
    from_jax_variables(st.discriminator, {"params": jax_run["dis_params"]})
    st.ema = {n: p.detach().clone() for n, p in st.model.named_parameters()}
    st.step = step
    steps = build_train_steps(cfg, CROP)
    x = to_port(jax_run["x"])
    draws = LatentDraws(eps=to_port(jax_run["fp32"][(which, warmed)]["eps"]))
    if which == "gen":
        metrics = steps["gen"](st, x, warmed, draws=draws)
    else:
        metrics = steps["dis"](st, x, draws=draws)
    assert st.step == step + 1
    module = st.model if which == "gen" else st.discriminator
    grads = {n: p.grad.numpy() for n, p in module.named_parameters()}
    return metrics, grads, module


@pytest.mark.parametrize("which,step,warmed,seed,extra", PHASES, ids=PHASE_IDS)
def test_bf16_step_matches_jax(jax_run, which, step, warmed, seed, extra):
    ref, ref16 = jax_run["fp32"][(which, warmed)], jax_run["bf16"][(which, warmed)]
    launches = dilated_unit.launches
    metrics, grads, module = port_step(jax_run, BF16 + extra, which, step, warmed)
    assert dilated_unit.launches == launches  # CPU: the plain unit only
    assert set(metrics) == set(ref["metrics"])

    # the masters and their gradients stay fp32
    assert all(p.dtype == torch.float32 for p in module.parameters())
    assert all(g.dtype == np.float32 and np.isfinite(g).all() for g in grads.values())
    if warmed and which == "gen":  # the frozen encoder: zero gradient, like JAX's
        assert all(not g.any() for n, g in grads.items() if n.startswith("encoder."))

    want = convert_tree(module, ref["grads"])
    jax16 = convert_tree(module, ref16["grads"])
    loss_jax, loss_port = loss_distance(ref16["metrics"], ref["metrics"]), \
        loss_distance(metrics, ref["metrics"])
    grad_jax, grad_port = grad_distance(jax16, want), grad_distance(grads, want)
    assert loss_port <= max(2 * loss_jax, FLOOR), (loss_port, loss_jax)
    assert grad_port <= max(2 * grad_jax, FLOOR), (grad_port, grad_jax)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("which,step,warmed,seed,extra", PHASES[:2], ids=PHASE_IDS[:2])
def test_remat_changes_nothing(jax_run, which, step, warmed, seed, extra, bf16):
    """The generator step with `train.remat` recomputes its autoencode pass in
    the backward: the same losses and gradients as without."""
    base = BF16 if bf16 else []
    m0, g0, _ = port_step(jax_run, base, which, step, warmed)
    m1, g1, _ = port_step(jax_run, base + REMAT, which, step, warmed)
    assert set(m0) == set(m1)
    for k in m0:
        assert abs(float(m1[k]) - float(m0[k])) <= EQUAL_TOL * max(abs(float(m0[k])), 1e-2), k
    for n, g in g0.items():
        assert np.abs(g1[n] - g).max() <= EQUAL_TOL * max(np.abs(g).max(), 1e-3), n


def test_remat_step_matches_jax(jax_run):
    """The pre-warmup generator step with remat in both packages."""
    which, step, warmed, _, _ = PHASES[0]
    ref = jax_run["remat"][(which, warmed)]
    metrics, grads, module = port_step(jax_run, REMAT, which, step, warmed)
    for k, want in ref["metrics"].items():
        assert abs(float(metrics[k]) - want) <= LOSS_TOL * max(abs(want), 1e-2), k
    for name, want in convert_tree(module, ref["grads"]).items():
        err = np.abs(grads[name] - want).max() / (np.abs(want).max() or 1e-3)
        assert err <= GRAD_TOL, name


@pytest.mark.parametrize("normalized", [False, True])
def test_stft_upcasts_bf16(normalized):
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 1024)).astype(np.float32))
    x16 = x.to(torch.bfloat16)
    got = stft(x16, 256, 64, normalized=normalized)
    assert got.dtype == torch.complex64
    torch.testing.assert_close(got, stft(x16.float(), 256, 64, normalized=normalized),
                               rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["centered", "causal"])
@pytest.mark.parametrize("d", [1, 3, 9])
def test_plain_unit_bf16_matches_jax(d, mode):
    """The fused unit's plain twin in bf16 against the JAX plain unit in bf16,
    on the same bf16 numbers: within 1e-2 of the output's max (a few bf16
    roundings, 2^-8 each, taken at other places by XLA and PyTorch)."""
    rng = np.random.default_rng(d)
    K, B, T, C = 3, 2, 53, 16
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    w1 = (rng.standard_normal((K, C, C)) / np.sqrt(K * C)).astype(np.float32)  # [K, I, O]
    w2 = (rng.standard_normal((C, C)) / np.sqrt(C)).astype(np.float32)        # [I, O]
    left, right = get_padding(K, 1, d, mode)
    bf = jnp.bfloat16
    y_j = np.asarray(jax_unit._reference_impl(
        jnp.asarray(x, bf), jnp.asarray(w1, bf), jnp.asarray(w2, bf), d, left, right
    ).astype(jnp.float32))
    before = dilated_unit.launches
    y_p = dilated_unit.fused_dilated_unit(
        torch.from_numpy(x.transpose(0, 2, 1).copy()).bfloat16(),
        torch.from_numpy(w1.transpose(2, 1, 0).copy()).bfloat16(),  # [O, I, K]
        torch.from_numpy(w2.T.copy()).bfloat16(),                   # [O, I]
        d, left, right,
    )
    assert y_p.dtype == torch.bfloat16 and dilated_unit.launches == before
    y_p = y_p.float().numpy().transpose(0, 2, 1)
    assert np.abs(y_p - y_j).max() / np.abs(y_j).max() < 1e-2


@pytest.mark.parametrize("case", ["float64", "mixed", "bf16-C24", "fp32-C12"])
def test_kernel_checks_refuse(case):
    """What the CUDA kernel does not take raises before any launch: a dtype
    other than float32 / bfloat16, mixed dtypes, C % 16 in bf16, C % 8 in
    fp32 (the wrapper's checks, run here on CPU tensors)."""
    dtype = {"float64": torch.float64, "mixed": torch.bfloat16, "bf16-C24": torch.bfloat16,
             "fp32-C12": torch.float32}[case]
    C = {"bf16-C24": 24, "fp32-C12": 12}.get(case, 16)
    x = torch.zeros(1, C, 16, dtype=dtype)
    w1 = torch.zeros(C, C, 3, dtype=torch.float32 if case == "mixed" else dtype)
    w2 = torch.zeros(C, C, dtype=dtype)
    error = ValueError if case.endswith(("C24", "C12")) else TypeError
    with pytest.raises(error):
        dilated_unit._check(x, w1, w2, 1, 1, 1)
    if case == "mixed":  # the same tensors all in bf16 pass
        dilated_unit._check(x, w1.bfloat16(), w2, 1, 1, 1)


def test_modules_keep_bf16():
    """Every module of the model and the critic hands on a bf16 input as
    bf16, as the JAX modules do (weights cast per op): the PQMF analysis, the
    encoder, the decoder with its amplitude modulation, the synthesis and
    every critic feature. No op upcasts silently."""
    cfg = compose(["v2"], TINY)
    model = build_rave(cfg, seed=0, device="cpu")
    critic = build_discriminator(cfg, seed=1, device="cpu")
    seen = []

    def record(module, args, out):
        outs = out if isinstance(out, (list, tuple)) else [out]
        flat = [t for o in outs for t in (o if isinstance(o, (list, tuple)) else [o])]
        seen.extend((type(module).__name__, t.dtype) for t in flat if torch.is_tensor(t))

    for m in (*model.modules(), *critic.modules()):
        m.register_forward_hook(record)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 1, N_SIGNAL))
                         .astype(np.float32) * 0.1).bfloat16()
    with torch.no_grad():
        z = model.encoder(model.transform_input(x))
        y = model.synthesize(model.decode_multiband(z[:, : cfg.latent_size]))
        critic(torch.cat([x, y], dim=0))
    assert y.dtype == torch.bfloat16 and y.shape == x.shape
    names = {n for n, _ in seen}
    assert {"PQMFAnalysis", "PQMFSynthesis", "FusedDilatedResidual", "GeneratorV2",
            "ConvNet", "WNConv"} <= names, names
    upcast = sorted({n for n, dtype in seen if dtype != torch.bfloat16})
    assert not upcast, upcast


@pytest.mark.parametrize("entry", ["build_rave", "build_discriminator", "create_train_state",
                                   "receptive_field"])
def test_entry_points_default_to_the_card(entry):
    """The entry points build on CUDA unless asked for the CPU: without a
    card they raise rather than build on the CPU."""
    cfg = compose(["v2"], TINY)
    call = {"build_rave": build_rave, "build_discriminator": build_discriminator,
            "create_train_state": create_train_state, "receptive_field": receptive_field}[entry]
    if torch.cuda.is_available():
        out = call(cfg)
        module = out.model if entry == "create_train_state" else out
        if entry != "receptive_field":
            assert next(module.parameters()).is_cuda
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call(cfg)


if __name__ == "__main__":
    # The pre-warmup step's bf16 distances at v2's log_epsilon and at the
    # 1e-3 the tests use: python tests/test_torch_bf16.py (JAX_PLATFORMS=cpu)
    for log_eps in ("1e-7", "1e-3"):
        phase = ("gen", 1, False, 11, [f"distance.log_epsilon={log_eps}"])
        run = run_jax([phase], remat=False)
        ref, ref16 = run["fp32"][("gen", False)], run["bf16"][("gen", False)]
        m16, g16, module = port_step(run, BF16 + phase[4], *phase[:3])
        m32, g32, _ = port_step(run, phase[4], *phase[:3])
        want, jax16 = convert_tree(module, ref["grads"]), convert_tree(module, ref16["grads"])
        print(f"log_epsilon {log_eps}, distance from the JAX fp32 step: losses JAX bf16 "
              f"{loss_distance(ref16['metrics'], ref['metrics']):.3e}, port bf16 "
              f"{loss_distance(m16, ref['metrics']):.3e}; gradients JAX bf16 "
              f"{grad_distance(jax16, want):.3e}, port bf16 {grad_distance(g16, want):.3e}, "
              f"port fp32 {grad_distance(g32, want):.3e}")
