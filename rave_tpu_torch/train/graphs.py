"""The three training programs served as CUDA graphs: one captured step per key.

The port's counterpart of the `jax.jit(..., donate_argnums=0)` around
rave_tpu's `gen_step` and `dis_step` (rave_tpu/train/steps.py:204, 249):
there a step is one compiled program over donated state; here it is one
`torch.cuda.CUDAGraph` that runs the forward, the backward, both Adams and
the EMA of a step (`TrainSteps.programs`, train/steps.py) and writes the
model, the critic, their gradients, the Adams' moments and step counts, the
EMA and the modules' buffers in place.

`TrainGraphs(steps)` takes `build_train_steps`'s steps and serves them with
the same signatures (`graphs.gen(state, x, warmed, draws=...)`,
`graphs.dis(state, x, draws=...)`): the steps' own host work
(`TrainSteps.run`: the draws, the schedule's tensors, the global step)
around `TrainGraphs`' execution of the device program. On a card the
program runs by its key:

  * a key is the program and its Python constants (`warmed`, `quantize`),
    the shapes and dtypes of x and of each draw, the backend flags
    (nn/graphs.py's `backend_flags`) and the address of every tensor the
    program reads or writes in place (`state_tensors`): the parameters and
    the gradients of what it trains, the modules' buffers, its Adam's states
    and learning rate, the EMA and the schedule's tensors;
  * a key never seen runs the program eagerly on a side stream: a real step
    (a training step is not pure, so a warm-up cannot run it again), which
    makes what a capture must find made (the gradients, the Adams' states,
    the frozen encoder's zero gradients, the codebooks' k-means, the unit's
    shared-memory caps and tile counters, cuDNN's and cuFFT's plans). The
    key that the state has after it is marked warm: the next call with that
    key copies x and the draws into static buffers, captures the program into
    a graph (all of this instance's graphs share one memory pool: they never
    run concurrently) and replays it once; later calls copy their inputs in
    and replay. No step runs twice, none is skipped;
  * the addresses are walked once and walked again only after a step that
    ran Python (a warm-up) or where the state's containers changed: another
    `TrainState`, or a restore (utils/checkpoint.py), which replaces the
    Adams' state dicts and the EMA dict. A replay writes in place only. Where
    the containers changed, the graphs made on the old ones are dropped, and
    the new state's keys are warmed up and captured anew: never a replay
    that writes where the state no longer is. Each graph also holds the
    tensors it was captured on, so that no replay writes to freed memory.

Python's garbage collector is held off during a capture
(`nn/graphs.py::collector_held`). A capture that changes the key (it
replaced a state tensor, or gave a parameter its first gradient) raises, as
does any capture or replay error: nothing falls back to eager. The metrics
a replay returns are clones of the graph's outputs, which the next replay
of any graph in the pool overwrites. The fused unit's wrappers count the
launches they make (`dilated_unit.launches`); inside a capture a launch is
recorded into the graph and counted there, and the capturing call's one
replay runs it. A later replay runs no Python and counts nothing: its
kernels are counted in a device trace (chip_smoke.py, phase `train_graph`).
`captures` and `replays` count the graphs and replays of every
`TrainGraphs`.

On the CPU the program runs eagerly on the caller's tensors, as the eager
step runs it. Under data parallelism (a process group) `TrainGraphs` raises:
gloo's collectives cannot be captured, and the loop runs the eager steps
there (train/loop.py::step_method).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from rave_tpu_torch.models.blocks import LatentDraws
from rave_tpu_torch.nn.graphs import backend_flags, collector_held
from rave_tpu_torch.parallel import mesh
from rave_tpu_torch.train.state import TrainState
from rave_tpu_torch.train.steps import TrainSteps

captures = 0  # graphs captured by every TrainGraphs
replays = 0  # their replays


def state_tensors(state: TrainState, which: Optional[str] = None) -> list:
    """Every tensor a step reads or writes in place, None where a gradient
    or the EMA is absent: the model's and the critic's parameters, each
    followed by its gradient, then their buffers, the Adams' learning rates
    and states, the EMA and the schedule's tensors. `which` keeps those of
    one program: the generator's ("gen") reads the critic's parameters and
    buffers but neither its gradients nor its Adam; the critic's ("dis")
    reads the model's parameters and buffers (its codebooks and batch
    statistics train there) but neither their gradients, nor the generator's
    Adam, nor the EMA."""
    trains = {"gen": (state.model,), "dis": (state.discriminator,)}.get(
        which, (state.model, state.discriminator))
    out = []
    for module in (state.model, state.discriminator):
        for p in module.parameters():
            out += [p, p.grad] if module in trains else [p]
        out += list(module.buffers())
    opts = {"gen": (state.gen_opt,), "dis": (state.dis_opt,)}.get(
        which, (state.gen_opt, state.dis_opt))
    for opt in opts:
        for group in opt.param_groups:
            if torch.is_tensor(group["lr"]):
                out.append(group["lr"])
            for p in group["params"]:
                out += [v for v in opt.state.get(p, {}).values() if torch.is_tensor(v)]
    if which != "dis":
        out += [None] if state.ema is None else list(state.ema.values())
    return out + [state.schedule.gen_lr, state.schedule.beta]


def _containers(state: TrainState) -> tuple:
    """What holds the state's tensors, and what a restore replaces: the
    state, its modules, the Adams and their per-parameter state dicts, the
    EMA dict and the schedule."""
    return (state, state.model, state.discriminator, state.gen_opt, state.gen_opt.state,
            state.dis_opt, state.dis_opt.state, state.ema, state.schedule)


def _signature(t: Optional[torch.Tensor]):
    return None if t is None else (tuple(t.shape), t.dtype)


def _draws(draws: LatentDraws) -> list:
    return [getattr(draws, f.name) for f in dataclasses.fields(draws)]


class _Graph:
    def __init__(self, graph, x, draws, outputs, held):
        self.graph, self.x, self.draws, self.outputs = graph, x, draws, outputs
        self.held = held  # the state tensors it was captured on, kept alive


class TrainGraphs:
    """`steps`' programs served from static buffers (the module docstring).
    `graphs` holds the captured graphs by key, `warm` the keys an eager step
    left the state at, `pool` the graphs' memory pool once the first is
    captured."""

    def __init__(self, steps: TrainSteps):
        self.steps = steps
        self.graphs: dict = {}
        self.warm: set = set()
        self.pool = None
        self._containers: Optional[tuple] = None  # those the graphs were made on
        self._addresses: dict = {}  # which -> addresses of state_tensors(state, which)

    def gen(self, state: TrainState, x: torch.Tensor, warmed: bool,
            draws: Optional[LatentDraws] = None, generator: Optional[torch.Generator] = None,
            quantize: bool = True) -> dict:
        return self.steps.run("gen", state, x, warmed, draws, generator, quantize, self.execute)

    def dis(self, state: TrainState, x: torch.Tensor, draws: Optional[LatentDraws] = None,
            generator: Optional[torch.Generator] = None, quantize: bool = True) -> dict:
        return self.steps.run("dis", state, x, True, draws, generator, quantize, self.execute)

    def key_of(self, which: str, state: TrainState, x: torch.Tensor, draws: LatentDraws,
               warmed: bool, quantize: bool, addresses: Optional[tuple] = None) -> tuple:
        """The graph that this call replays (the module docstring); the
        addresses walked anew unless given."""
        if addresses is None:
            addresses = tuple(None if t is None else t.data_ptr()
                              for t in state_tensors(state, which))
        return (which, warmed, quantize, _signature(x),
                tuple(_signature(t) for t in _draws(draws)), backend_flags(), addresses)

    def execute(self, which, program, state, x, draws, warmed, quantize) -> dict:
        """`program` on this step's inputs (`TrainSteps.run`'s `execute`)."""
        if mesh.world_size() > 1:
            raise RuntimeError("TrainGraphs: a data-parallel step reduces over gloo, whose "
                               "collectives a CUDA graph cannot hold; run the eager steps")
        if x.device.type != "cuda":
            return program(state, x, draws, warmed, quantize)
        return self._graphed(which, program, state, x, draws, warmed, quantize)

    def _known(self, which: str, state: TrainState) -> tuple:
        """The addresses of `state_tensors(state, which)`, from the last walk
        unless the state's containers changed since (the module docstring)."""
        containers = _containers(state)
        if self._containers is None or any(a is not b for a, b in
                                           zip(containers, self._containers)):
            self.graphs.clear()
            self.warm.clear()
            self._addresses.clear()
            self._containers = containers
        if which not in self._addresses:
            self._addresses[which] = tuple(None if t is None else t.data_ptr()
                                           for t in state_tensors(state, which))
        return self._addresses[which]

    def _graphed(self, which, program, state, x, draws, warmed, quantize) -> dict:
        key = self.key_of(which, state, x, draws, warmed, quantize, self._known(which, state))
        entry = self.graphs.get(key)
        if entry is None and key not in self.warm:
            metrics = self._warm(program, state, x, draws, warmed, quantize)
            self._addresses.clear()
            self.warm.add(self.key_of(which, state, x, draws, warmed, quantize,
                                      self._known(which, state)))
            return metrics
        if entry is None:
            entry = self.graphs[key] = self._capture(key, which, program, state, x, draws,
                                                     warmed, quantize)
        else:
            entry.x.copy_(x)
            for buf, t in zip(_draws(entry.draws), _draws(draws)):
                if t is not None:
                    buf.copy_(t)
        return self._replay(entry)

    @staticmethod
    def _warm(program, state, x, draws, warmed, quantize) -> dict:
        """One real step, eagerly, on a side stream."""
        current = torch.cuda.current_stream(x.device)
        side = torch.cuda.Stream(x.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            metrics = program(state, x, draws, warmed, quantize)
        current.wait_stream(side)
        return metrics

    def _capture(self, key, which, program, state, x, draws, warmed, quantize) -> _Graph:
        static_x = x.clone()
        static_draws = LatentDraws(*(None if t is None else t.clone() for t in _draws(draws)))
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with collector_held(), torch.cuda.graph(graph, pool=self.pool,
                                                capture_error_mode="thread_local"):
            outputs = program(state, static_x, static_draws, warmed, quantize)
        if self.key_of(which, state, static_x, static_draws, warmed, quantize) != key:
            raise RuntimeError(
                f"TrainGraphs: capturing the {which} step (warmed={warmed}) replaced a tensor "
                f"of the train state or gave a parameter its first gradient; the graph would "
                f"write where the state no longer is")
        global captures
        captures += 1
        return _Graph(graph, static_x, static_draws, outputs,
                      [t for t in state_tensors(state, which) if t is not None])

    @staticmethod
    def _replay(entry: _Graph) -> dict:
        entry.graph.replay()
        global replays
        replays += 1
        return {k: v.clone() for k, v in entry.outputs.items()}
