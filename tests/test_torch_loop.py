"""The port's training driver and evaluation against rave_tpu's.

Pieces: `pca` (exact: the same numpy); checkpoints (a round trip bit-equal,
newest-step and `step=` choice, a temporary file never chosen, run and
config discovery answering as the JAX package's on the same tree).

The slice as a whole: both `train()` loops run 6 steps of the tiny v2 on
the same db with the threaded host loader (`device_data="off"`; the JAX
loop's native sampler is made to raise, so its own fallback picks
`Loader`, and the port's rule, which would take its C++ sampler there, is
made to pick `Loader`: tests/test_torch_native.py holds the two packages'
native loaders to each other). Both
start from the JAX loop's initial state (the port's through
`from_jax_variables`) and draw the same noise: the port's `draw_noise` is
replaced by the JAX loop's per-step eps, recovered from
`fold_in(key(seed + 1), step)` and, for validation, `key(1234)`, as
tests/test_torch_train.py recovers it. Then the phases picked, the steps
checkpointed and the keys of every metrics.jsonl row must be equal; the
losses logged at steps 1 and 2 within 1e-4 relative (step 1 is one step
of float32 arithmetic in two frameworks, tests/test_torch_train.py's
tolerance; step 2 follows one Adam update from gradients that agree to
5e-3, and Adam's first update is lr * sign(g), so elements whose gradient
is near zero may move by 2 lr in one package and not the other: 1e-3); the
validation values and the PCA mean and fidelity after 3 and 6 steps
within 1e-3 (the same, over more updates), and the PCA components within
1e-2: a principal axis moves by the latents' difference over the gap
between its variance and the next, which magnifies it here (3.9e-3
measured, with the mean within 1e-3). A resumed port run continues the global
step, and with the device pipeline ends bit-equal to an unbroken run.

`evaluate` against rave_tpu's from the same weights and noise: spectral
distance and waveform L1 within 1e-4 relative, FMD within 1e-3.
"""
import json
import os
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from rave_tpu import config as jax_config
from rave_tpu.data import loader as jax_loader_mod
from rave_tpu.data.preprocess import preprocess as jax_preprocess
from rave_tpu.factory import build_rave as jax_build_rave
from rave_tpu.train import analysis as jax_analysis
from rave_tpu.train import loop as jax_loop
from rave_tpu.train.evaluate import evaluate as jax_evaluate
from rave_tpu.utils import checkpoint as jax_checkpoint
from rave_tpu.utils import logging as jax_logging
from rave_tpu_torch import config
from rave_tpu_torch.models.blocks import LatentDraws
from rave_tpu_torch.train import evaluate as port_evaluate
from rave_tpu_torch.train import loop
from rave_tpu_torch.train.analysis import pca
from rave_tpu_torch.train.state import create_train_state
from rave_tpu_torch.train.steps import build_train_steps, draw_noise
from rave_tpu_torch.utils import checkpoint
from rave_tpu_torch.utils.convert import from_jax_variables
from rave_tpu_torch.utils.rng import fold_in

TINY = ["capacity=2", "discriminator.capacity=2", "latent_size=4", "ratios=[4,4,2]",
        "dilations=[[1],[1],[1]]", "distance.scales=[512,256]", "train.phase_1_duration=3",
        "train.update_discriminator_every=2", "train.valid_signal_crop=false", "train.ema=0.9",
        "data.n_signal=8192", "data.workers=2"]
SR, N_SIGNAL, BATCH, SEED = 44100, 8192, 8, 0  # batch 8: the JAX loop's 8-device CPU mesh
STEP1_TOL, STEP2_TOL, VAL_TOL = 1e-4, 1e-3, 1e-3
PCA_AXES_TOL = 1e-2
EVAL_TOL, FMD_TOL = 1e-4, 1e-3
LOGGED = (1, 2)


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Two torch threads for this module: beside the suite's other parallel
    workers, torch's default of one thread per core oversubscribes the host
    and slows these tests several-fold (alone, two threads are as fast)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-2)


def make_cfg(module):
    cfg = module.compose(["v2"], TINY)
    cfg.data.batch = BATCH
    return cfg


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    """110 records of 8192 samples (108 train, 2 val) of tones, chirps and noise."""
    root = tmp_path_factory.mktemp("torch_loop")
    (root / "corpus").mkdir()
    rng = np.random.default_rng(0)
    t = np.arange(37 * N_SIGNAL) / SR
    for i, x in enumerate([0.4 * np.sin(2 * np.pi * 330 * t),
                           0.3 * np.sin(2 * np.pi * (80 + 300 * t) * t),
                           0.2 * rng.standard_normal(t.size)]):
        wavfile.write(root / "corpus" / f"{i}.wav", SR, (x * 32767).astype(np.int16))
    jax_preprocess(str(root / "corpus"), str(root / "db"), N_SIGNAL, SR, 1, workers=2)
    return str(root / "db")


def recorder(module, name, log):
    """Wrap module.name so each call's (args, result) is appended to log."""
    orig = getattr(module, name)

    def wrapped(*args, **kwargs):
        out = orig(*args, **kwargs)
        log.append((args, out))
        return out

    return wrapped


@pytest.fixture(scope="module")
def jax_run(db, tmp_path_factory):
    """The JAX loop, 6 steps; its initial state, phases, saves and per-step eps."""
    out = tmp_path_factory.mktemp("jax_runs")
    cfg = make_cfg(jax_config)
    inits, phases, saves = [], [], []

    def no_native(*a, **k):
        raise RuntimeError("native sampler off in this test")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_loader_mod, "NativeLoader", no_native)
        # JSON files only: its TensorBoard writer would import tensorflow (~20 s) for
        # event files that nothing here reads
        mp.setattr(jax_loop, "MetricsLogger",
                   lambda run_dir: jax_logging.MetricsLogger(run_dir, use_tensorboard=False))
        create = jax_loop.create_train_state

        def create_and_keep(*args, **kwargs):  # a copy: the steps donate the state's buffers
            state = create(*args, **kwargs)
            inits.append(jax.tree_util.tree_map(np.array, state))
            return state

        mp.setattr(jax_loop, "create_train_state", create_and_keep)
        mp.setattr(jax_loop, "pick_phase", recorder(jax_loop, "pick_phase", phases))
        save = jax_loop.save_checkpoint

        def save_and_keep(run_dir, step, state):
            saves.append((step, jax.tree_util.tree_map(np.asarray, state)))
            save(run_dir, step, state)

        mp.setattr(jax_loop, "save_checkpoint", save_and_keep)
        run_dir = jax_loop.train(cfg, db, name="j", out_path=str(out), max_steps=6, val_every=3,
                                 save_every=4, seed=SEED, resume=False, progress=False,
                                 device_data="off")
    state0 = inits[0]
    # each step's eps: reparametrize a zero latent (mean 0, std s) with the step's rng,
    # through the same module path as the step and validation
    model = jax_build_rave(cfg, n_channels=1, train=True)
    variables = {"params": state0.gen_params, **state0.model_state}
    T_lat = N_SIGNAL // cfg.decimation()

    def eps(rng, batch):
        z0 = jnp.zeros((batch, T_lat, 2 * cfg.latent_size), jnp.float32)
        zs, _ = model.apply(variables, z0, rngs={"noise": rng},
                            method=lambda m, z: m.reparametrize(z))
        return torch.from_numpy(np.asarray(zs / (jax.nn.softplus(0.0) + 1e-4))
                                .transpose(0, 2, 1).copy())

    noise = {fold_in(SEED + 1, s): eps(jax.random.fold_in(jax.random.key(SEED + 1), s), BATCH)
             for s in range(8)}
    noise[loop.VAL_NOISE_SEED] = eps(jax.random.key(1234), 2)
    return {"run_dir": run_dir, "state0": state0, "noise": noise,
            "phases": [(a[1], out) for a, out in phases], "saves": saves}


def port_patches(mp, jax_run, phases=None, saves=None):
    """Start the port's loop from the JAX initial state and draw the JAX eps."""
    state0 = jax_run["state0"]

    def create(cfg, n_channels=1, seed=0, device="cpu"):
        st = create_train_state(cfg, n_channels=n_channels, seed=seed, device=device)
        from_jax_variables(st.model, {"params": state0.gen_params,
                                      "buffers": state0.model_state["buffers"]})
        from_jax_variables(st.discriminator, {"params": state0.dis_params})
        st.ema = {n: p.detach().clone() for n, p in st.model.named_parameters()}
        return st

    def noise(cfg, x, generator=None):
        eps = jax_run["noise"][generator.initial_seed()]
        assert eps.shape == draw_noise(cfg, x).eps.shape
        return LatentDraws(eps=eps)

    mp.setattr(loop, "create_train_state", create)
    mp.setattr(loop, "draw_noise", noise)
    if phases is not None:
        mp.setattr(loop, "pick_phase", recorder(loop, "pick_phase", phases))
    if saves is not None:
        save = loop.save_checkpoint

        def save_and_keep(run_dir, state):
            saves.append((state.step, {n: b.clone() for n, b in state.model.named_buffers()}))
            return save(run_dir, state)

        mp.setattr(loop, "save_checkpoint", save_and_keep)


@pytest.fixture(scope="module")
def port_run(db, jax_run, tmp_path_factory):
    out = tmp_path_factory.mktemp("port_runs")
    phases, saves = [], []
    with pytest.MonkeyPatch.context() as mp:
        port_patches(mp, jax_run, phases, saves)
        mp.setattr(loop, "input_pipeline", lambda *a, **k: "threads")
        run_dir = loop.train(make_cfg(config), db, name="p", out_path=str(out), max_steps=6,
                             val_every=3, save_every=4, seed=SEED, resume=False,
                             progress=False, device_data="off", device="cpu")
    return {"run_dir": run_dir, "phases": [(a[1], out) for a, out in phases], "saves": saves,
            "out": out}


def metrics(run_dir):
    return [json.loads(line) for line in Path(run_dir, "metrics.jsonl").read_text().splitlines()]


def test_loop_matches_jax(jax_run, port_run):
    assert port_run["phases"] == jax_run["phases"]
    assert [p[0] for p in port_run["phases"]] == list(range(6))
    assert {p[1][0] for p in port_run["phases"]} == {"gen", "dis"}
    assert [s for s, _ in port_run["saves"]] == [s for s, _ in jax_run["saves"]]
    ours, theirs = metrics(port_run["run_dir"]), metrics(jax_run["run_dir"])
    assert [sorted(r) for r in ours] == [sorted(r) for r in theirs]
    for a, b in zip(ours, theirs):
        assert a["step"] == b["step"]
        for k in set(a) - {"step", "time", "steps_per_sec"}:
            tol = {1: STEP1_TOL, 2: STEP2_TOL}.get(a["step"], VAL_TOL)
            if k.startswith("fidelity_"):  # index of the first component past p
                assert a[k] == b[k], (a["step"], k)
            else:
                assert rel(a[k], b[k]) <= tol, (a["step"], k, a[k], b[k])
    assert sum("validation" in r for r in ours) == 2
    assert {r["step"] for r in ours if "loss_gen" in r} == set(LOGGED)
    # the PCA buffers of every save (set by the pre-warmup validation at step 3)
    for (step, bufs), (_, jstate) in zip(port_run["saves"], jax_run["saves"]):
        jbufs = jstate.model_state["buffers"]
        for name, tol in (("latent_mean", VAL_TOL), ("fidelity", VAL_TOL),
                          ("latent_pca", PCA_AXES_TOL)):
            np.testing.assert_allclose(bufs[name].numpy(), jbufs[name], atol=tol, rtol=0,
                                       err_msg=f"{name} at step {step}")
        assert not np.array_equal(jbufs["fidelity"], 0 * jbufs["fidelity"])
    for name in ("config.json", "status.json", "config.txt", "model.txt"):
        assert Path(port_run["run_dir"], name).is_file()
    assert json.loads(Path(port_run["run_dir"], "status.json").read_text()) == {
        "step": 2, "warmed": False}


def test_resume_continues(db, jax_run, port_run):
    """`train` again with more steps: the newest checkpoint is restored, the
    global step goes on from it, and (device pipeline) the result is the
    result of an unbroken run, bit for bit."""
    out = port_run["out"] / "resume"
    cfg = make_cfg(config)
    runs = {}
    for name, legs in (("resumed", (6, 8)), ("unbroken", (8,))):
        for max_steps in legs:
            phases = []
            with pytest.MonkeyPatch.context() as mp:
                port_patches(mp, jax_run, phases)
                run_dir = loop.train(cfg, db, name=name, out_path=str(out),
                                     max_steps=max_steps, val_every=3, save_every=4, seed=SEED,
                                     progress=False, device_data="on", device="cpu")
        runs[name] = (run_dir, [args[1] for args, _ in phases])
    run_dir, steps = runs["resumed"]
    assert steps == [6, 7]  # the second leg started at the saved step 6
    assert [checkpoint.checkpoint_step(p) for p in checkpoint.list_checkpoints(run_dir)] == [
        3, 4, 6, 8]
    a = torch.load(checkpoint.latest_checkpoint(run_dir), weights_only=True)
    b = torch.load(checkpoint.latest_checkpoint(runs["unbroken"][0]), weights_only=True)
    assert a["step"] == b["step"] == 8
    assert_same(a, b)


def assert_same(a, b, path="ckpt"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif torch.is_tensor(a):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    else:
        assert a == b, path


def test_evaluate_matches_jax(db, jax_run, tmp_path):
    """The port's eval of a run holding the JAX run's final weights."""
    step, jstate = jax_run["saves"][-1]
    cfg = make_cfg(config)
    cfg.data.n_channels = 1
    st = create_train_state(cfg, device="cpu")
    from_jax_variables(st.model, {"params": jstate.gen_params,
                                  "buffers": jstate.model_state["buffers"]})
    st.step = step
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    (run_dir / "config.json").write_text(config.snapshot(cfg))
    checkpoint.save_checkpoint(str(run_dir), st)
    want = jax_evaluate(jax_run["run_dir"], db, split="val")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_evaluate, "draw_noise", lambda cfg, x, generator: LatentDraws(
            eps=jax_run["noise"][generator.initial_seed()]))
        got = port_evaluate.evaluate(str(run_dir), db, split="val", device="cpu")
        again = port_evaluate.evaluate(str(run_dir), db, split="val", device="cpu")
    assert got == again
    for k in ("n_clips", "n_batches", "split", "step", "ema"):
        assert got[k] == want[k], k
    assert got["n_clips"] == 2 and got["step"] == 6
    for k in ("spectral_distance", "waveform_l1"):
        assert rel(got[k], want[k]) <= EVAL_TOL, (k, got[k], want[k])
    assert rel(got["frechet_mel_distance"], want["frechet_mel_distance"]) <= FMD_TOL


# ---- pieces ----------------------------------------------------------------

@pytest.mark.parametrize("n", [3, 64])
def test_pca_exact(n):
    z = np.random.default_rng(n).standard_normal((n, 8)).astype(np.float32) @ np.diag(
        np.arange(1, 9)).astype(np.float32)
    for mine, theirs in zip(pca(z), jax_analysis.pca(z)):
        assert mine.dtype == theirs.dtype
        np.testing.assert_array_equal(mine, theirs)


@pytest.fixture
def trained_state():
    """A tiny state after a critic step and a generator step, with an EMA."""
    cfg = make_cfg(config)
    st = create_train_state(cfg, seed=3, device="cpu")
    steps = build_train_steps(cfg)
    x = torch.randn(2, 1, N_SIGNAL, generator=torch.Generator().manual_seed(0)) * 0.1
    g = torch.Generator().manual_seed(1)
    steps["dis"](st, x, generator=g)
    steps["gen"](st, x, True, generator=g)
    st.model.latent_mean.fill_(0.5)
    return cfg, st


def test_checkpoint_round_trip(trained_state, tmp_path):
    cfg, st = trained_state
    path = checkpoint.save_checkpoint(str(tmp_path), st)
    assert path.name == "step_0000000002.pt"
    fresh = create_train_state(cfg, seed=9, device="cpu")
    assert checkpoint.restore_checkpoint(str(tmp_path), fresh) == path
    assert fresh.step == 2
    assert_same(fresh.model.state_dict(), st.model.state_dict())
    assert_same(fresh.discriminator.state_dict(), st.discriminator.state_dict())
    assert_same(fresh.gen_opt.state_dict(), st.gen_opt.state_dict())
    assert_same(fresh.dis_opt.state_dict(), st.dis_opt.state_dict())
    assert_same(fresh.ema, st.ema)
    assert all(s["step"].device.type == "cpu" for s in fresh.gen_opt.state.values())
    ckpt = torch.load(path, weights_only=True)
    assert set(ckpt) == {"step", "model", "discriminator", "gen_opt", "dis_opt", "ema"}
    assert {"receptive_field", "latent_pca", "latent_mean", "fidelity"} <= set(ckpt["model"])


def test_checkpoint_choice(trained_state, tmp_path):
    _, st = trained_state
    assert checkpoint.latest_checkpoint(str(tmp_path)) is None
    assert checkpoint.restore_checkpoint(str(tmp_path), st) is None
    for step in (3, 12, 7):
        st.step = step
        checkpoint.save_checkpoint(str(tmp_path), st)
    # what a save cut short leaves behind is never chosen
    (tmp_path / "checkpoints" / "step_0000000099.pt.tmp").write_bytes(b"half")
    (tmp_path / "checkpoints" / "notes.txt").write_text("x")
    assert [checkpoint.checkpoint_step(p) for p in checkpoint.list_checkpoints(str(tmp_path))] == [
        3, 7, 12]
    assert checkpoint.latest_checkpoint(str(tmp_path)).name == "step_0000000012.pt"
    assert checkpoint.latest_checkpoint(str(tmp_path), step=7).name == "step_0000000007.pt"
    with pytest.raises(FileNotFoundError, match="available"):
        checkpoint.latest_checkpoint(str(tmp_path), step=5)
    checkpoint.restore_checkpoint(str(tmp_path), st, step=3)
    assert st.step == 3


def test_run_discovery_matches_jax(tmp_path):
    root = tmp_path / "runs"
    for i, name in enumerate(("old", "new")):
        (root / name / "checkpoints").mkdir(parents=True)
        stamp = time.time() - 100 + 50 * i
        os.utime(root / name / "checkpoints", (stamp, stamp))
    (root / "new" / "config.json").write_text("{}")
    (root / "config.json").write_text("{}")
    (root / "nested" / "deep" / "x").mkdir(parents=True)
    (root / "nested" / "deep" / "config.json").write_text("{}")
    queries = [root, root / "old", root / "new", root / "nested", tmp_path / "none", None]
    for q in queries:
        q = None if q is None else str(q)
        assert checkpoint.search_for_run(q) == jax_checkpoint.search_for_run(q), q
    for q in (root / "old", root / "new", root / "new" / "config.json", root / "nested",
              root / "nested" / "deep" / "x", tmp_path):
        assert checkpoint.search_for_config(str(q)) == jax_checkpoint.search_for_config(str(q)), q


def test_config_snapshot_round_trip():
    cfg = config.compose(["v2", "causal"], TINY + ['data.augmentations=["mute"]'])
    back = config.from_dict(json.loads(config.snapshot(cfg)))
    assert back == cfg and config.config_hash(back) == config.config_hash(cfg)
    assert config.config_hash(cfg) != config.config_hash(config.compose(["v2"], TINY))
    # a JAX config.json loads too: the port keeps the fields it has
    jcfg = jax_config.compose(["v2"], TINY)
    assert config.from_dict(jax_config.to_dict(jcfg)) == config.compose(["v2"], TINY)


def test_fp32_exact_restores_tf32_flags():
    before = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with loop.fp32_exact():
            assert not torch.backends.cudnn.allow_tf32
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before
