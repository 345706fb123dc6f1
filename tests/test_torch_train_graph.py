"""The training programs as CUDA graphs (train/graphs.py): what the CPU can check.

A CUDA graph is captured and replayed on the card only (chip_smoke.py,
phase `train_graph`, holds the graphed steps bit-equal to the eager ones
there). Here, at the tiny v2 of tests/test_torch_train.py:

  * every program of every family reads nothing back to the host and makes
    no cross-device copy (a `TorchDispatchMode` raises on the ops that would
    end a capture, and on the data a step makes from host arrays), the
    discrete family after its k-means step. Two CPU-only
    reads are let through, each because the card's path has none: the CPU's
    Adam, which is not capturable (torch refuses `capturable` for CPU
    parameters) and reads its step count and learning rate, and ATen's
    `one_hot`, which checks its indices' range on the host for a CPU tensor
    only;
  * `TrainGraphs`' key follows the address of every tensor of the train
    state, a checkpoint's restore included, and nothing else;
  * `TrainGraphs` is bit-equal to the eager steps over phase `train`'s
    schedule (5 pre-warmup steps, then 4 cycles of the critic's period), on
    CPU tensors and along its card path with an emulated capture and replay
    (one capture per program);
  * the launch counts of a warm-up, a capture and its replays, a restore
    that drops the graphs made before it, and a capture that would change the
    key, with `torch.cuda`'s graph calls replaced by stand-ins that run
    nothing;
  * the device constants a graph reads (`ops/stft.py::on_device`) stay;
  * a checkpoint in the layout written before the schedule's tensors (float
    learning rates, Adams never capturable) loads and trains on;
  * the loop's rule: graphs on one card, eager steps on the CPU and under
    data parallelism;
  * the unit's tile counters: made once, never made or grown inside a capture.
"""
import contextlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from rave_tpu_torch.config import compose
from rave_tpu_torch.models.blocks import LatentDraws
from rave_tpu_torch.ops.kernels import dilated_unit
from rave_tpu_torch.parallel import mesh
from rave_tpu_torch.train import graphs as train_graphs
from rave_tpu_torch.train import loop
from rave_tpu_torch.train.graphs import TrainGraphs, state_tensors
from rave_tpu_torch.train.state import create_train_state
from rave_tpu_torch.train.steps import build_train_steps, draw_noise, pick_phase
from rave_tpu_torch.utils import checkpoint

TINY = [
    "capacity=2",
    "discriminator.capacity=2",
    "latent_size=4",
    "ratios=[4,4,2]",
    "dilations=[[1],[1],[1]]",
    "distance.scales=[512,256]",
    "train.phase_1_duration=6",
    "train.update_discriminator_every=2",
    "train.beta_warmup_len=8",
    "train.ema=0.99",
]
N_SIGNAL = 8192
PREWARMUP, CYCLES = 5, 4  # chip_smoke.py's `_train_run` schedule

# (presets, overrides beyond TINY) of every family the loop trains
FAMILIES = {
    "v2": (["v2"], []),
    "v2-bf16": (["v2"], ["train.bf16=true", "train.bf16_dis=true"]),
    "v2-remat": (["v2"], ["train.remat=true"]),
    "discrete": (["discrete"], ["latent.num_quantizers=2", "latent.codebook_size=16",
                                "latent.noise_augmentation=2"]),
    "wasserstein": (["v2", "wasserstein"], []),
    "spherical": (["v2", "spherical"], []),
    "v3": (["v3"], ["discriminator.descript_periods=[2]", "discriminator.descript_fft_sizes=[256]",
                    "train.valid_signal_crop=false"]),
    "v1": (["v1"], ["n_band=16"]),
    "v2_small": (["v2_small"], ["ratios=[4,2]", "dilations=[[1],[1]]",
                                "decoder.noise_hidden=4"]),
    "v2_nopqmf": (["v2_nopqmf"], ["encoder.ratios=[4,2]", "decoder.ratios=[16,8]"]),
    "hybrid": (["hybrid"], ["n_mels=16", "mel_n_fft=512", "mel_hop=128", "encoder.ratios=[4]",
                            "train.valid_signal_crop=false"]),
    "spectral": (["v2", "spectral_discriminator"], ["discriminator.spectral_scales=[512,256]"]),
}
# the ops that read a tensor back to the host or size an output by its data: each
# synchronizes with the card, which a CUDA graph capture cannot do
HOST_READS = {"aten::_local_scalar_dense", "aten::nonzero", "aten::is_nonzero", "aten::equal",
              "aten::masked_select", "aten::_unique2", "aten::unique_dim",
              "aten::unique_consecutive", "aten::item"}


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Two intra-op threads, as the suite's other torch files run beside its
    other workers: the default (one per core) in every worker oversubscribes
    the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class NoHostRead(TorchDispatchMode):
    """Raises on an op that reads a tensor back to the host (HOST_READS),
    copies between devices or makes a tensor of host data (`torch.tensor`;
    `watch_from_numpy` adds `torch.from_numpy`): on the card each is a copy
    from pageable host memory, which a capture refuses. Except while
    `paused`."""

    def __init__(self):
        super().__init__()
        self.paused, self.active = 0, False

    def __enter__(self):
        self.active = True
        return super().__enter__()

    def __exit__(self, *exc):
        self.active = False
        return super().__exit__(*exc)

    def watch_from_numpy(self, monkeypatch):
        from_numpy = torch.from_numpy

        def watched(array):
            if self.active and not self.paused:
                raise AssertionError("torch.from_numpy: host data inside a training program")
            return from_numpy(array)

        monkeypatch.setattr(torch, "from_numpy", watched)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._schema.name
        if not self.paused:
            if name in HOST_READS:
                raise AssertionError(f"{name}: a host read inside a training program")
            if name == "aten::lift_fresh":
                raise AssertionError(f"{name}: host data inside a training program")
            if name in ("aten::_to_copy", "aten::copy_"):
                src = args[1] if name == "aten::copy_" else args[0]
                dst = args[0].device if name == "aten::copy_" else kwargs.get("device")
                if dst is not None and torch.is_tensor(src) and src.device != torch.device(dst):
                    raise AssertionError(f"{name}: a copy from {src.device} to {dst}")
        return func(*args, **kwargs)

    @contextlib.contextmanager
    def pause(self):
        self.paused += 1
        try:
            yield
        finally:
            self.paused -= 1


def tiny(names, extra=(), more=()):
    return compose(list(names), TINY + list(extra) + list(more))


def signal(seed: int = 0):
    return torch.randn(2, 1, N_SIGNAL, generator=torch.Generator().manual_seed(seed)) * 0.1


def test_host_read_mode_raises(monkeypatch):
    """The mode does see a host read, a copy to another device and host data."""
    t = torch.ones(3)
    mode = NoHostRead()
    mode.watch_from_numpy(monkeypatch)
    with mode:
        with pytest.raises(AssertionError, match="from_numpy"):
            torch.from_numpy(np.ones(3))
        with pytest.raises(AssertionError, match="_local_scalar_dense"):
            float(t.sum())
        with pytest.raises(AssertionError, match="is_nonzero|_local_scalar_dense"):
            bool(t.sum() > 0)
        with pytest.raises(AssertionError, match="nonzero"):
            t.nonzero()
        with pytest.raises(AssertionError, match="a copy from cpu to meta"):
            t.to("meta")
        with pytest.raises(AssertionError, match="lift_fresh"):
            torch.tensor([1.0, 2.0])


@pytest.mark.parametrize("family", list(FAMILIES))
def test_programs_read_nothing_back(family, monkeypatch):
    names, extra = FAMILIES[family]
    cfg = tiny(names, extra)
    st = create_train_state(cfg, seed=0, device="cpu")
    steps = build_train_steps(cfg)
    x, g = signal(), torch.Generator().manual_seed(1)
    steps["gen"](st, x, False, generator=g)  # the first step: discrete's k-means reads `inited`
    mode = NoHostRead()
    mode.watch_from_numpy(monkeypatch)
    for opt in (st.gen_opt, st.dis_opt):  # the CPU's Adam is not capturable
        monkeypatch.setattr(opt, "step", _paused(mode, opt.step))
    one_hot = torch.nn.functional.one_hot
    monkeypatch.setattr(torch.nn.functional, "one_hot",
                        lambda t, num_classes=-1: (_paused(mode, one_hot) if num_classes > 0
                                                   else one_hot)(t, num_classes))

    def in_mode(which, program, *args):  # the device program alone, not the step's host work
        with mode:
            return program(*args)

    for which, warmed in (("gen", False), ("gen", True), ("dis", True)):
        metrics = steps.run(which, st, x, warmed, draw_noise(cfg, x, g), None, True, in_mode)
        assert all(torch.is_tensor(v) for v in metrics.values()), (which, warmed)


def _paused(mode, fn):
    def call(*args, **kwargs):
        with mode.pause():
            return fn(*args, **kwargs)
    return call


def key(graphs, st, x, draws, which="gen", warmed=False):
    return graphs.key_of(which, st, x, draws, warmed, True)


def test_key_follows_every_state_tensor(tmp_path):
    cfg = tiny(["v2"])
    st = create_train_state(cfg, seed=0, device="cpu")
    steps = build_train_steps(cfg)
    graphs = TrainGraphs(steps)
    x, g = signal(), torch.Generator().manual_seed(1)
    for warmed in (False, True):  # every gradient and Adam state made
        graphs.gen(st, x, warmed, generator=g)
    graphs.dis(st, x, generator=g)
    draws = draw_noise(cfg, x, g)
    k0 = key(graphs, st, x, draws)
    graphs.gen(st, x, False, draws=draws)  # a step writes in place: the same key
    assert key(graphs, st, x, draws) == k0
    assert key(graphs, st, x.clone(), draw_noise(cfg, x, g)) == k0  # inputs: shapes only
    assert key(graphs, st, x, draws, warmed=True) != k0
    assert key(graphs, st, x, draws, which="dis") != k0
    assert key(graphs, st, x[:1], draws) != k0
    assert key(graphs, st, x, LatentDraws()) != k0

    p = next(st.model.parameters())
    c = next(st.discriminator.parameters())
    name, buf = next(iter(st.model.named_buffers()))
    owner, attr = st.model.get_submodule(name.rpartition(".")[0]), name.rpartition(".")[2]
    ema_name = next(iter(st.ema))
    # (what is replaced, the programs whose key follows it)
    replacements = [
        ("parameter", lambda: setattr(p, "data", p.data.clone()), "gen dis"),
        ("critic parameter", lambda: setattr(c, "data", c.data.clone()), "gen dis"),
        ("gradient", lambda: setattr(p, "grad", p.grad.clone()), "gen"),
        ("critic gradient", lambda: setattr(c, "grad", c.grad.clone()), "dis"),
        ("buffer", lambda: setattr(owner, attr, getattr(owner, attr).clone()), "gen dis"),
        ("Adam moment", lambda: st.gen_opt.state[p].__setitem__(
            "exp_avg", st.gen_opt.state[p]["exp_avg"].clone()), "gen"),
        ("critic Adam step", lambda: st.dis_opt.state[c].__setitem__(
            "step", st.dis_opt.state[c]["step"].clone()), "dis"),
        ("EMA", lambda: st.ema.__setitem__(ema_name, st.ema[ema_name].clone()), "gen"),
        ("learning rate", lambda: setattr(st.schedule, "gen_lr", st.schedule.gen_lr.clone()),
         "gen dis"),
        ("beta", lambda: setattr(st.schedule, "beta", st.schedule.beta.clone()), "gen dis"),
    ]
    before = {w: key(graphs, st, x, draws, which=w) for w in ("gen", "dis")}
    for what, replace, follows in replacements:
        replace()
        after = {w: key(graphs, st, x, draws, which=w) for w in ("gen", "dis")}
        for w in ("gen", "dis"):
            assert (after[w] != before[w]) == (w in follows.split()), (what, w)
        before = after

    path = checkpoint.save_checkpoint(str(tmp_path), st)
    in_place = key(graphs, st, x, draws)
    with torch.no_grad():  # in-place writes: validation's EMA swap, the PCA buffers
        for t in (p, getattr(owner, attr), st.ema[ema_name]):
            t.add_(1.0)
    assert key(graphs, st, x, draws) == in_place
    assert checkpoint.restore_checkpoint(str(tmp_path), st) == path
    assert key(graphs, st, x, draws) != in_place  # new Adam states and EMA


@pytest.mark.parametrize("path", ["cpu", "emulated"])
@pytest.mark.parametrize("family", ["v2", "v2-bf16", "v2-remat", "discrete", "v1", "v2_small",
                                    "v2_nopqmf", "hybrid", "spectral"])
def test_graphs_bit_equal_to_steps(family, path, emulated_graphs):
    """Phase `train`'s schedule through `TrainGraphs` and through the steps,
    from one seed and the same draws: every metric, parameter, gradient,
    buffer, Adam state and EMA tensor bit-equal. `cpu`: `TrainGraphs` on CPU
    tensors (the program runs eagerly); `emulated`: its card path, each key
    warmed up, captured and replayed by `emulated_graphs`' stand-in, with
    exactly one capture per program."""
    names, extra = FAMILIES[family]
    cfg = tiny(names, extra)
    runs = []
    for graphed in (False, True):
        st = create_train_state(cfg, seed=0, device="cpu")
        steps = build_train_steps(cfg)
        graphs = TrainGraphs(steps)
        x, noise = signal(), torch.Generator().manual_seed(7)
        metrics, captures = [], train_graphs.captures
        for i in range(PREWARMUP + CYCLES * cfg.train.update_discriminator_every):
            if i == PREWARMUP:
                st.step = cfg.train.phase_1_duration
            which, warmed, quantize = pick_phase(cfg, st.step)
            draws = draw_noise(cfg, x, noise)
            if not graphed:
                m = (steps["gen"](st, x, warmed, draws=draws, quantize=quantize) if which == "gen"
                     else steps["dis"](st, x, draws=draws, quantize=quantize))
            elif path == "cpu":
                m = (graphs.gen(st, x, warmed, draws=draws, quantize=quantize) if which == "gen"
                     else graphs.dis(st, x, draws=draws, quantize=quantize))
            else:  # the steps' host work around TrainGraphs' card path
                m = steps.run(which, st, x, warmed, draws, None, quantize, graphs._graphed)
            metrics.append(m)
        if graphed and path == "emulated":
            assert len(graphs.graphs) == train_graphs.captures - captures == 3
        runs.append((metrics, st))
    (m_eager, eager), (m_graph, graph) = runs
    assert graph.step == eager.step == cfg.train.phase_1_duration + 8
    for a, b in zip(m_eager, m_graph):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    for a, b in zip(state_tensors(eager), state_tensors(graph)):
        assert (a is None) == (b is None)
        assert a is None or (a.dtype == b.dtype and torch.equal(a, b))


@pytest.fixture
def emulated_graphs(fake_cuda, monkeypatch):
    """`TrainGraphs`' card path on the CPU: `fake_cuda`'s stand-ins, and a
    capture that leaves the train state as it found it (the stand-in ran the
    program; a CUDA capture runs nothing) and whose graph's replay runs the
    program again on the static inputs, writing the captured outputs."""
    capture = TrainGraphs._capture

    def emulated(self, key, which, program, state, x, draws, warmed, quantize):
        saved = [None if t is None else t.detach().clone() for t in state_tensors(state)]
        entry = capture(self, key, which, program, state, x, draws, warmed, quantize)
        with torch.no_grad():
            for t, v in zip(state_tensors(state), saved):
                if t is not None:
                    t.copy_(v)

        def replay():
            out = program(state, entry.x, entry.draws, warmed, quantize)
            for k, v in out.items():
                entry.outputs[k].copy_(v)

        entry.graph.replay = replay
        return entry

    monkeypatch.setattr(TrainGraphs, "_capture", emulated)


class _Stream:
    def wait_stream(self, other):
        pass


class _Graph:
    """A stand-in for torch.cuda.CUDAGraph: a replay runs nothing."""

    made, capturing = [], False

    def __init__(self):
        self.replays = 0
        _Graph.made.append(self)

    def replay(self):
        self.replays += 1


@contextlib.contextmanager
def _capture(graph, pool=None, capture_error_mode=None):
    """A stand-in for torch.cuda.graph: the program runs, and says it is captured."""
    _Graph.capturing = True
    try:
        yield
    finally:
        _Graph.capturing = False


@pytest.fixture
def fake_cuda(monkeypatch):
    """`torch.cuda`'s stream and graph calls replaced by stand-ins, so that
    `TrainGraphs._graphed` runs its bookkeeping on the CPU."""
    _Graph.made = []
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: ("pool",))
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph", _capture)
    return _Graph


# launches (forward, forward bf16, gradient, gradient bf16) of each program's call
LAUNCHES = {("gen", False): (22, 0, 22, 0), ("gen", True): (22, 22, 11, 11),
            ("dis", True): (22, 0, 0, 0)}


def _counting_program(which):
    """A program that counts its call's LAUNCHES as the unit's wrappers do."""
    def program(state, x, draws, warmed, quantize):
        n = LAUNCHES[(which, warmed)]
        dilated_unit.launches += n[0]
        dilated_unit.launches_bf16 += n[1]
        dilated_unit.launches_backward += n[2]
        dilated_unit.launches_backward_bf16 += n[3]
        return {"loss": x.sum() * state.schedule.gen_lr}
    return program


def test_replays_add_each_graphs_launches(fake_cuda):
    """The launch counts along the card path: a warm-up call counts its
    launches, a capturing call those it recorded (its one replay runs them),
    a later replay none (it runs no Python; the card's trace counts its
    kernels); one capture per key, right after its warm-up."""
    cfg = tiny(["v2"])
    st = create_train_state(cfg, seed=0, device="cpu")
    graphs = TrainGraphs(build_train_steps(cfg))
    x, draws = signal(), LatentDraws(eps=torch.zeros(2, 4, N_SIGNAL // cfg.decimation()))
    calls = [("gen", False)] * 4 + [("dis", True), ("gen", True)] * 3 + [("gen", False)]
    # warm-up or capture (True), or a replay of an earlier capture (False)
    counted = [True, True, False, False, True, True, True, True, False, False, False]
    captures, replays = train_graphs.captures, train_graphs.replays
    for i, ((which, warmed), counts) in enumerate(zip(calls, counted)):
        before = dilated_unit.launch_counts()
        out = graphs._graphed(which, _counting_program(which), st, x, draws, warmed, True)
        after = dilated_unit.launch_counts()
        want = LAUNCHES[(which, warmed)] if counts else (0, 0, 0, 0)
        assert tuple(a - b for a, b in zip(after, before)) == want, i
        assert set(out) == {"loss"}
    # one warm-up call per key, then one capture each, replayed at every later call
    assert len(fake_cuda.made) == len(graphs.graphs) == 3
    assert train_graphs.captures - captures == 3
    assert [g.replays for g in fake_cuda.made] == [4, 2, 2]
    assert train_graphs.replays - replays == 8


def test_restore_drops_the_graphs(fake_cuda, tmp_path, monkeypatch):
    """A replay walks none of the state's tensors; a restore, which replaces
    the Adams' state dicts and the EMA dict, drops the graphs made before it,
    and the restored state's key is warmed up and captured anew."""
    cfg = tiny(["v2"])
    st = create_train_state(cfg, seed=0, device="cpu")
    graphs = TrainGraphs(build_train_steps(cfg))
    x, draws = signal(), LatentDraws()
    walks = [0]
    walk = train_graphs.state_tensors

    def counted(*args, **kwargs):
        walks[0] += 1
        return walk(*args, **kwargs)

    monkeypatch.setattr(train_graphs, "state_tensors", counted)

    def call():
        return graphs._graphed("gen", _counting_program("gen"), st, x, draws, False, True)

    for _ in range(3):  # a warm-up, a capture and its replay, a replay
        call()
    assert len(graphs.graphs) == 1 and fake_cuda.made[0].replays == 2
    walks[0] = 0
    call()
    assert walks[0] == 0 and fake_cuda.made[0].replays == 3
    checkpoint.save_checkpoint(str(tmp_path), st)
    checkpoint.restore_checkpoint(str(tmp_path), st)
    captures, replays = train_graphs.captures, train_graphs.replays
    call()  # the restored state: a warm-up, no replay of the old graph
    assert graphs.graphs == {} and train_graphs.replays == replays
    assert fake_cuda.made[0].replays == 3
    call()
    assert len(graphs.graphs) == 1 and train_graphs.captures == captures + 1
    assert fake_cuda.made[1].replays == 1


def test_device_constants_are_never_evicted():
    """`ops/stft.py::on_device` keeps every constant it made: a captured
    graph reads them by address, and its replays never touch the cache."""
    from rave_tpu_torch.ops.stft import _reflect_index, hann_window, on_device

    cpu = torch.device("cpu")
    window = on_device(hann_window, (64,), cpu, torch.float32)
    address = window.data_ptr()
    for length in range(1, 301):  # more keys than a bounded cache of 256 held
        on_device(_reflect_index, (length, 4), cpu)
    again = on_device(hann_window, (64,), cpu, torch.float32)
    assert again is window and again.data_ptr() == address
    assert on_device.cache_info().maxsize is None


def test_capture_that_changes_the_key_raises(fake_cuda):
    cfg = tiny(["v2"])
    st = create_train_state(cfg, seed=0, device="cpu")
    graphs = TrainGraphs(build_train_steps(cfg))
    x, draws = signal(), LatentDraws()
    name = next(iter(st.ema))

    def replaces_ema(state, x, draws, warmed, quantize):
        if fake_cuda.capturing:  # a new tensor, not an in-place write
            state.ema[name] = state.ema[name] + 0.0
        return {"loss": x.sum()}

    graphs._graphed("gen", replaces_ema, st, x, draws, False, True)  # the warm-up
    with pytest.raises(RuntimeError, match="replaced a tensor of the train state"):
        graphs._graphed("gen", replaces_ema, st, x, draws, False, True)


def test_pre_schedule_checkpoint_loads(tmp_path):
    """A checkpoint whose Adams hold float learning rates and CPU step counts,
    as the port wrote them before the schedule's tensors, restores and trains
    on bit-equal to the state that wrote it; a restore keeps the optimizer's
    own `capturable`."""
    cfg = tiny(["v2"])
    st = create_train_state(cfg, seed=0, device="cpu")
    steps = build_train_steps(cfg)
    x, g = signal(), torch.Generator().manual_seed(1)
    steps["gen"](st, x, False, generator=g)
    steps["dis"](st, x, generator=g)
    old = {"step": st.step, "model": st.model.state_dict(),
           "discriminator": st.discriminator.state_dict(), "ema": st.ema}
    for name, opt in (("gen_opt", st.gen_opt), ("dis_opt", st.dis_opt)):
        sd = opt.state_dict()
        sd["param_groups"] = [{**grp, "lr": float(grp["lr"]), "capturable": False}
                              for grp in sd["param_groups"]]
        assert all(s["step"].device.type == "cpu" for s in sd["state"].values())
        old[name] = sd
    path = checkpoint._write_checkpoint(str(tmp_path), st.step, old)
    fresh = create_train_state(cfg, seed=5, device="cpu")
    assert checkpoint.restore_checkpoint(str(tmp_path), fresh) == path
    assert fresh.step == st.step
    draws = draw_noise(cfg, x, g)
    a = steps["gen"](st, x, False, draws=draws)
    b = steps["gen"](fresh, x, False, draws=draws)
    assert all(torch.equal(a[k], b[k]) for k in a)
    for p, q in zip(st.model.parameters(), fresh.model.parameters()):
        assert torch.equal(p, q)

    # the flag: a capturable optimizer stays capturable, its counts float32 on its device
    for group in fresh.gen_opt.param_groups:
        group["capturable"] = True
    checkpoint.load_optimizer(fresh.gen_opt, old["gen_opt"])
    assert all(grp["capturable"] for grp in fresh.gen_opt.param_groups)
    assert all(s["step"].dtype == torch.float32 and s["step"].device == p.device
               for p, s in fresh.gen_opt.state.items())


def test_loop_picks_its_steps(monkeypatch):
    cfg = tiny(["v2"])
    cpu, card = torch.device("cpu"), torch.device("cuda", 0)
    assert loop.step_method(cpu) == ("eager", "the training steps run eagerly (on the CPU)")
    assert loop.step_method(card) == (
        "graph", "the training steps run as CUDA graphs (one per program and key) on cuda:0")
    eager = loop.train_steps(cfg, (0, 0), cpu)
    assert set(eager) == {"gen", "dis"} and hasattr(eager, "programs")
    graphed = loop.train_steps(cfg, (0, 0), card)
    assert isinstance(graphed["gen"].__self__, TrainGraphs)
    monkeypatch.setattr(mesh, "world_size", lambda: 2)  # a process group of two ranks
    method, why = loop.step_method(card)
    assert method == "eager" and "data parallel" in why
    assert not isinstance(getattr(loop.train_steps(cfg, (0, 0), card)["gen"], "__self__", None),
                          TrainGraphs)
    st = create_train_state(cfg, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="gloo"):
        TrainGraphs(build_train_steps(cfg)).gen(st, signal(), False, draws=LatentDraws())


def test_tile_counters_never_made_in_a_capture(monkeypatch):
    monkeypatch.setattr(dilated_unit, "_COUNTERS", {})
    monkeypatch.setattr(dilated_unit, "_RETIRED", [])
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    cpu = torch.device("cpu")
    capturing[0] = True
    with pytest.raises(RuntimeError, match="B=8 C=768.*inside a CUDA graph capture"):
        dilated_unit._counters(cpu, 100, "B=8 C=768 T=128 K=3 d=1")
    capturing[0] = False
    buf = dilated_unit._counters(cpu, 100)
    assert buf.numel() == dilated_unit.COUNTER_CAPACITY and not buf.any()
    capturing[0] = True
    assert dilated_unit._counters(cpu, dilated_unit.COUNTER_CAPACITY) is buf
    with pytest.raises(RuntimeError, match="holds 16384"):
        dilated_unit._counters(cpu, dilated_unit.COUNTER_CAPACITY + 1, "C=1280")
    capturing[0] = False
    grown = dilated_unit._counters(cpu, dilated_unit.COUNTER_CAPACITY + 1)
    assert grown.numel() == dilated_unit.COUNTER_CAPACITY + 1
    assert dilated_unit._RETIRED == [buf]  # a graph may still hold its address
