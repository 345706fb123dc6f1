"""Data parallelism over processes: rave_tpu_torch's ranks against one
process and against rave_tpu's multi-process worker, on the CPU (gloo).

`rave_tpu_torch.parallel.mpworker` runs the JAX worker's tiny v2 at its
length, pre-warmup, adversarial and critic steps, in two ranks of four rows
each, started by `torch.distributed.run`, and in one process over the
global batch of eight, on the same weights and draws: the JAX package's
initial state (`from_jax_variables`) and the draws of its steps,
recovered from the steps' rngs (tests/test_torch_train.py's rule). Then:

  * the two ranks end bit-equal (every parameter and buffer, every loss);
  * two ranks are within 1e-6 of one process (losses and checksums);
  * the losses are within 1e-4 of the JAX package's steps over the same
    global batch, which are themselves `rave_tpu.parallel.mpworker.run`'s
    numbers (1e-6, the JAX worker's own tolerance across topologies).

The seeded mode (weights from seed 0, draws from `draw_noise`, which draws
at the global batch and keeps the rank's rows) is held to one process the
same way. A two-rank `cli train` takes the native loader, validates in
lockstep, saves from rank 0 alone and resumes. The discrete and v1
families (codebooks, BatchNorm) are in tests/test_torch_parallel_families.py.
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rave_tpu.config import compose as jax_compose
from rave_tpu.factory import build_discriminator as jax_build_discriminator
from rave_tpu.factory import build_rave as jax_build_rave
from rave_tpu.parallel import mpworker as jax_mpworker
from rave_tpu.train import state as jax_state
from rave_tpu.train import steps as jax_steps
from rave_tpu_torch.config import compose
from rave_tpu_torch.parallel import mesh, mpworker
from rave_tpu_torch.train.state import create_train_state
from rave_tpu_torch.utils.convert import from_jax_variables

ROOT = Path(__file__).resolve().parents[1]
RANKS, PER_RANK = 2, 4
GLOBAL = RANKS * PER_RANK
LOSSES = ("step0_loss_gen", "step1_loss_gen", "step2_loss_dis")
CHECKSUMS = ("checksum", "buffer_checksum", "dis_checksum")
RANK_TOL, JAX_TOL, JAX_WORKER_TOL = 1e-6, 1e-4, 1e-6


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def child_env() -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT)] + [p for p in env.get(
        "PYTHONPATH", "").split(os.pathsep) if p])
    for key in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                "MASTER_PORT"):
        env.pop(key, None)
    return env


def launch(module_args, ranks: int, torchrun: bool = False):
    """Start `python -m <module_args>` as `ranks` ranks: through
    torch.distributed.run, or as processes given torchrun's environment
    (one plain process when ranks is 1). Returns the processes."""
    port = free_port()
    if torchrun:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(ranks),
               "--master_addr", "127.0.0.1", "--master_port", str(port), "-m", *module_args]
        return [subprocess.Popen(cmd, cwd=ROOT, env=child_env(), stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)]
    procs = []
    for r in range(ranks):
        env = child_env()
        if ranks > 1:
            env.update(WORLD_SIZE=str(ranks), RANK=str(r), LOCAL_RANK=str(r),
                       LOCAL_WORLD_SIZE=str(ranks), MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port))
        procs.append(subprocess.Popen([sys.executable, "-m", *module_args], cwd=ROOT, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    return procs


def finish(procs) -> str:
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, f"rank failed ({p.returncode}):\n{err[-4000:]}"
        outs.append(out)
    return "".join(outs)


def worker_runs(tmp: Path, extra) -> tuple:
    """(the two ranks' results, one process's result) of the port's worker
    with `extra` arguments, the three processes run at once."""
    args = ["rave_tpu_torch.parallel.mpworker", "--device", "cpu", *map(str, extra)]
    two = launch(args + ["--batch", str(PER_RANK), "--out_dir", str(tmp / "two")], RANKS)
    one = launch(args + ["--batch", str(GLOBAL), "--out_dir", str(tmp / "one")], 1)
    finish(two + one)
    ranks = [json.loads((tmp / "two" / f"rank{r}.json").read_text()) for r in range(RANKS)]
    return ranks, json.loads((tmp / "one" / "rank0.json").read_text())


def assert_ranks_bit_equal(ranks):
    assert [r["world_size"] for r in ranks] == [RANKS] * RANKS
    for r in ranks[1:]:
        for k, v in ranks[0].items():
            if k not in ("rank", "ms"):
                assert r[k] == v, (k, r[k], v)


def assert_close(a: dict, b: dict, keys, tol: float):
    for k in keys:
        err = abs(a[k] - b[k]) / max(abs(b[k]), 1e-12)
        assert err <= tol, f"{k}: {a[k]} vs {b[k]} ({err:.2e} > {tol})"


def to_port(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 2, 1)))


def variational_eps(model, variables, cfg, rng, batch, n_signal):
    """The step's eps: reparametrize a zero latent (mean 0, std s) with its rng."""
    z0 = jnp.zeros((batch, n_signal // cfg.decimation(), 2 * cfg.latent_size), jnp.float32)
    zs, _ = model.apply(variables, z0, rngs={"noise": rng},
                        method=lambda m, z: m.reparametrize(z))
    return to_port(zs / (jax.nn.softplus(0.0) + 1e-4))


def jax_worker_steps(names, extra, quantize: bool, draw_fn, record=None,
                     final_state: bool = False):
    """The JAX worker's schedule on one device over the global batch
    (rave_tpu/parallel/mpworker.py:98-124, with `quantize`): its losses, the
    initial variables and the steps' draws as the port's `LatentDraws`
    fields (and with `final_state` the model's variables after the steps)."""
    cfg = jax_compose(names, jax_mpworker.TINY + list(extra))
    model = jax_build_rave(cfg, n_channels=1, train=True)
    dis = jax_build_discriminator(cfg, n_channels=1)
    state = jax_state.create_train_state(cfg, model, dis, jax.random.key(0),
                                         n_signal=jax_mpworker.N_SIGNAL)
    variables = {"params": state.gen_params, **state.model_state}
    initial = {"model": jax.tree_util.tree_map(np.asarray, variables),
               "dis": {"params": jax.tree_util.tree_map(np.asarray, state.dis_params)}}
    steps = jax_steps.build_train_steps(cfg, model, dis, crop_frames=mpworker.CROP_FRAMES)
    x = (np.random.default_rng(mpworker.X_SEED).standard_normal(
        (GLOBAL, jax_mpworker.N_SIGNAL, 1)) * 0.1).astype(np.float32)
    out, draws = {}, []
    for i, (which, warmed) in enumerate(mpworker.SCHEDULE):
        rng = jax.random.fold_in(jax.random.key(mpworker.DRAW_SEED), i)
        drawn = draw_fn(model, variables, cfg, rng)
        if record is not None:
            with record() as uniforms:
                state, m = run_jax_step(steps, state, x, rng, which, warmed, quantize)
            drawn["uniform"] = torch.from_numpy(np.asarray(uniforms[-1], np.float32))
        else:
            state, m = run_jax_step(steps, state, x, rng, which, warmed, quantize)
        draws.append(drawn)
        out[f"step{i}_loss_{which}"] = float(m[f"loss_{which}"])
    if final_state:
        final = jax.tree_util.tree_map(np.asarray, {"params": state.gen_params,
                                                    **state.model_state})
        return out, initial, draws, final
    return out, initial, draws


def run_jax_step(steps, state, x, rng, which, warmed, quantize):
    if which == "gen":
        return steps["gen"](state, jnp.asarray(x), rng, warmed=warmed, quantize=quantize)
    return steps["dis"](state, jnp.asarray(x), rng, quantize=quantize)


def write_inputs(tmp: Path, names, extra, initial, draws) -> list:
    """The JAX initial weights and draws in the port's files; the worker's arguments."""
    cfg = compose(names, mpworker.TINY + list(extra))
    st = create_train_state(cfg, seed=0, device="cpu")
    from_jax_variables(st.model, initial["model"])
    from_jax_variables(st.discriminator, initial["dis"])
    torch.save({"model": st.model.state_dict(), "discriminator": st.discriminator.state_dict()},
               tmp / "state.pt")
    torch.save(draws, tmp / "draws.pt")
    args = ["--state", tmp / "state.pt", "--draws", tmp / "draws.pt"]
    for n in names:
        args += ["--config", n]
    for o in extra:
        args += ["--override", o]
    return args


@pytest.fixture(scope="module")
def v2_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_parallel")

    def draw(model, variables, cfg, rng):
        return {"eps": variational_eps(model, variables, cfg, rng, GLOBAL,
                                       jax_mpworker.N_SIGNAL)}

    ref, initial, draws = jax_worker_steps(["v2"], [], False, draw)
    args = write_inputs(tmp, ["v2"], [], initial, draws)
    two = launch(["rave_tpu_torch.parallel.mpworker", "--device", "cpu", "--batch",
                  str(PER_RANK), "--out_dir", str(tmp / "two"), *map(str, args)],
                 RANKS, torchrun=True)
    one = launch(["rave_tpu_torch.parallel.mpworker", "--device", "cpu", "--batch",
                  str(GLOBAL), "--out_dir", str(tmp / "one"), *map(str, args)], 1)
    seeded = worker_runs(tmp / "seeded", [])
    finish(two + one)
    ranks = [json.loads((tmp / "two" / f"rank{r}.json").read_text()) for r in range(RANKS)]
    return {"ref": ref, "ranks": ranks,
            "one": json.loads((tmp / "one" / "rank0.json").read_text()), "seeded": seeded}


def test_jax_steps_are_the_jax_worker(v2_runs):
    """The reference steps reproduce rave_tpu's mpworker.run over 8 devices."""
    worker = jax_mpworker.run(0, 1, 0, GLOBAL, configure=False)
    assert worker["device_count"] == GLOBAL
    assert_close(v2_runs["ref"], worker, LOSSES, JAX_WORKER_TOL)


def test_ranks_bit_equal(v2_runs):
    assert_ranks_bit_equal(v2_runs["ranks"])
    assert v2_runs["ranks"][0]["global_batch"] == v2_runs["one"]["global_batch"] == GLOBAL


def test_two_ranks_match_one_process(v2_runs):
    r, one = v2_runs["ranks"][0], v2_runs["one"]
    assert_close(r, one, LOSSES + CHECKSUMS + ("x_checksum", "param0_checksum"), RANK_TOL)
    for i in range(3):
        for k in one[f"step{i}_metrics"]:
            a, b = r[f"step{i}_metrics"][k], one[f"step{i}_metrics"][k]
            assert abs(a - b) <= RANK_TOL * max(abs(b), 1e-3), (i, k, a, b)


def test_losses_match_jax(v2_runs):
    assert_close(v2_runs["ranks"][0], v2_runs["ref"], LOSSES, JAX_TOL)


def test_seeded_draws_match_one_process(v2_runs):
    """`draw_noise` under two ranks: the global batch's draws, each rank its rows."""
    ranks, one = v2_runs["seeded"]
    assert_ranks_bit_equal(ranks)
    assert_close(ranks[0], one, LOSSES + CHECKSUMS, RANK_TOL)
    assert ranks[0]["launches"] == [0, 0, 0]  # the plain unit on the CPU


def test_helpers_without_a_process_group():
    assert mesh.world_size() == 1 and mesh.rank() == 0 and mesh.is_main()
    x = torch.arange(12.0).reshape(4, 3)
    with mesh.sharded_batch():
        assert mesh.batch_shards() == 1
        assert mesh.gather_rows(x) is x and mesh.all_reduce_sum(x) is x
        assert mesh.rank_rows(x) is x
    assert torch.equal(mesh.put_batch(x.numpy(), torch.device("cpu")), x)
    assert mesh.all_processes_min(5) == 5
    np.testing.assert_array_equal(mesh.gather_to_hosts(x), x.numpy())
    m = {"a": torch.tensor(1.5), "b": 2.0}
    assert mesh.mean_over_ranks(m) is m
    assert mesh.init_from_env(torch.device("cpu")) == torch.device("cpu")


@pytest.mark.parametrize("device, local_world, cards, want", [
    ("cpu", 2, 0, "gloo"), ("cuda", 1, 1, "nccl"), ("cuda", 2, 1, "gloo"),
    ("cuda", 4, 4, "nccl"), ("cuda", 8, 4, "gloo")])
def test_backend_rule(monkeypatch, device, local_world, cards, want):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert mesh.backend_for(torch.device(device), local_world) == want


TINY_LOOP = ["sampling_rate=22050", "capacity=2", "discriminator.capacity=2", "latent_size=4",
             "ratios=[4,4,2]", "dilations=[[1],[1],[1]]", "distance.scales=[512,256]",
             "train.phase_1_duration=2", "train.update_discriminator_every=2"]


def test_two_rank_cli_train_validates_saves_and_resumes(tmp_path):
    """104 records of 16384 samples (2 in the validation split, one per
    rank): 2 ranks of batch 1 through torchrun, native loader, validation
    every 2 steps, then a resume to step 6."""
    from scipy.io import wavfile

    from rave_tpu_torch import cli
    from rave_tpu_torch.utils.checkpoint import checkpoint_step, list_checkpoints

    sr, n = 22050, 16384
    (tmp_path / "corpus").mkdir()
    t = np.arange(104 * n) / sr
    x = 0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * np.random.default_rng(0).standard_normal(
        t.size)
    wavfile.write(tmp_path / "corpus" / "a.wav", sr, (x * 32767).astype(np.int16))
    assert cli.main(["preprocess", "--input_path", str(tmp_path / "corpus"), "--output_path",
                     str(tmp_path / "db"), "--num_signal", str(n), "--sampling_rate", str(sr),
                     "--workers", "2"]) == 0
    args = ["rave_tpu_torch.cli", "train", "--device", "cpu", "--name", "dp", "--db_path",
            str(tmp_path / "db"), "--out_path", str(tmp_path / "runs"), "--batch", "1",
            "--n_signal", str(n), "--workers", "2", "--val_every", "2", "--save_every", "100",
            "--device_data", "off"]
    for o in TINY_LOOP:
        args += ["--override", o]
    out = finish(launch(args + ["--max_steps", "4"], RANKS, torchrun=True))
    assert "data parallel: 2 ranks, backend gloo" in out
    assert out.count("using the native (C++) input pipeline") == 1  # rank 0 prints
    run_dir = Path(out.strip().splitlines()[-1].removeprefix("run dir: "))
    out2 = finish(launch(args + ["--max_steps", "6"], RANKS, torchrun=True))
    assert "resumed at step 4" in out2 and out2.count("resumed at") == 1
    rows = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows if "validation" in r] == [2, 4, 6]
    assert [r["step"] for r in rows if "loss_gen" in r] == [1, 2]  # rank 0's rows, once each
    assert [checkpoint_step(p) for p in list_checkpoints(str(run_dir))] == [2, 4, 6]
