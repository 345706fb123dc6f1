"""Streaming steps served as CUDA graphs: one captured program per block shape.

The port's counterpart of the `jax.jit` that rave_tpu/export/artifact.py
puts around each streaming call. A streaming step is a function

    fn(state: List[Tensor], *inputs, **consts) -> (outputs, new_state)

(`StepProgram.forward`, `PriorStep.forward`, a loaded `.pt2` program, the
model's step pair): it reads its state and returns the next one, and never
writes a state tensor in place (the modules reassign their buffers, and
`artifact.swapped` puts the originals back). `StepGraphs` serves such a
step from static buffers. On the card it warms the step up on a side
stream (`_lib()` builds, cuDNN's algorithm choice, cuBLAS and cuFFT plans),
captures one `torch.cuda.CUDAGraph` that also copies `new_state` into the
state tensors, and from then on copies each call's inputs into the graph's
input buffers and replays. The state tensors keep their addresses, so
every write to them between calls must be in place. On the CPU the same
step runs eagerly on the same state tensors, with the same in-place copy
back. A capture or replay error raises: nothing falls back to eager. Python's
garbage collector is held off during a capture (`collector_held`).

A graph is keyed by the inputs' shapes and dtypes (the batch, the block,
which injected draws are present), the Python constants, the state
tensors' addresses, the backend flags that choose the kernels a capture
records (`backend_flags`) and the caller's `key()`. A new key captures a
new graph; the module's `captures` and `replays` count them over every
`StepGraphs` (an instance's graphs are `len(self.graphs)`).
"""
from __future__ import annotations

import contextlib
import gc
from typing import Callable, List, Optional, Sequence, Union

import torch

captures = 0  # graphs captured by every StepGraphs
replays = 0  # their replays
WARMUP_CALLS = 2  # eager calls on a side stream before a capture


def backend_flags() -> tuple:
    """The settings that change which kernels a capture records: cuDNN on or
    off, its deterministic and benchmark modes, TF32 in convolutions and in
    matmuls."""
    cudnn = torch.backends.cudnn
    return (cudnn.enabled, cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


@contextlib.contextmanager
def collector_held():
    """Python's cyclic garbage collector held off until exit: around a
    capture, where it could free an earlier CUDA graph (an artifact or a
    train state left in a reference cycle), whose destruction inside the
    capture ends it (cudaErrorStreamCaptureInvalidated)."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def _is_seed(x) -> bool:
    return isinstance(x, int) and not isinstance(x, bool)


def _signature(x):
    if x is None:
        return None
    if _is_seed(x):
        return "int64"
    return tuple(x.shape), x.dtype


def _tree(fn, tree):
    """`fn` over the tensors of a tensor, or a tuple or list of them."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree(fn, t) for t in tree)
    return fn(tree)


def copy_back(state: Sequence[torch.Tensor], new: Sequence[torch.Tensor]) -> None:
    """`new` into the state tensors, in place. A step returns either the
    tensor it was given (a buffer it did not touch) or a new one, which
    shares no memory with another state tensor: the order does not matter."""
    if len(new) != len(state):
        raise ValueError(f"the step returned {len(new)} state tensors for {len(state)}")
    for s, n in zip(state, new):
        if n is not s:
            s.copy_(n)


class _Graph:
    def __init__(self, graph, inputs, outputs):
        self.graph, self.inputs, self.outputs = graph, inputs, outputs


class StepGraphs:
    """`fn` served from static buffers: `self(*inputs, **consts)` returns
    `fn`'s outputs and leaves its next state in the state tensors.

    `state` is the list of state tensors, or a function returning it (the
    model's own buffers, read at each call). `inputs` are tensors, None (an
    absent optional input) or ints (seeds: an int64 scalar buffer filled
    with the value, so a graph never holds one as a constant); `consts` are
    Python values passed to `fn` as they are and keyed. `pool` is a memory
    pool shared by graphs that are never replayed concurrently
    (`torch.cuda.graph_pool_handle()`); each graph's outputs are held by it
    and cloned for the caller, so a replay of another graph in the pool
    overwrites nothing that outlives its own replay."""

    def __init__(self, fn: Callable, state: Union[List[torch.Tensor], Callable],
                 pool=None, key: Optional[Callable[[], tuple]] = None):
        self.fn, self._state, self.pool, self.key = fn, state, pool, key
        self.graphs = {}

    @property
    def state(self) -> List[torch.Tensor]:
        return self._state() if callable(self._state) else self._state

    def key_of(self, inputs, consts, state=None) -> tuple:
        """The graph that a call with `inputs` and `consts` replays: the
        inputs' shapes and dtypes (an int's value is not in it), the
        constants, the state tensors, the backend flags, the caller's key."""
        state = self.state if state is None else state
        return (tuple(_signature(x) for x in inputs), tuple(sorted(consts.items())),
                tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in state), backend_flags(),
                self.key() if self.key is not None else ())

    def __call__(self, *inputs, **consts):
        state = self.state
        device = (state or [x for x in inputs if torch.is_tensor(x)])[0].device
        with torch.no_grad():
            if device.type != "cuda":
                args = [torch.tensor(x, dtype=torch.int64, device=device) if _is_seed(x) else x
                        for x in inputs]
                outputs, new = self.fn(state, *args, **consts)
                copy_back(state, new)
                return outputs
            key = self.key_of(inputs, consts, state)
            entry = self.graphs.get(key)
            if entry is None:
                entry = self.graphs[key] = self._capture(state, inputs, consts, device)
            for buf, x in zip(entry.inputs, inputs):
                if _is_seed(x):
                    buf.fill_(x)
                elif x is not None:
                    buf.copy_(x)
            entry.graph.replay()
            global replays
            replays += 1
            return _tree(torch.clone, entry.outputs)

    def _capture(self, state, inputs, consts, device) -> _Graph:
        with torch.inference_mode(False):  # buffers that any later call may copy into
            static = [None if x is None else
                      torch.empty((), dtype=torch.int64, device=device) if _is_seed(x) else
                      torch.empty(x.shape, dtype=x.dtype, device=device) for x in inputs]
        for buf, x in zip(static, inputs):
            if _is_seed(x):
                buf.fill_(x)
            elif x is not None:
                buf.copy_(x)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_CALLS):  # the step is pure: the state stays as it was
                self.fn(state, *static, **consts)
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with collector_held(), torch.cuda.graph(graph, pool=self.pool,
                                                capture_error_mode="thread_local"):
            outputs, new = self.fn(state, *static, **consts)
            # the modules reassigned their buffers inside the step; the graph
            # writes the new values into the state tensors it was given
            copy_back(state, new)
        global captures
        captures += 1
        return _Graph(graph, static, outputs)
