"""Data parallelism over processes: the torch.distributed counterpart of
rave_tpu/parallel/mesh.py.

A JAX host is a rank here: one process per rank, started by `torchrun`
(`python -m torch.distributed.run --nproc_per_node N ...`), whose
environment (WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) sets
up the process group (`init_from_env`). Without those variables a run is
one process and nothing here communicates. The backend is NCCL where each
rank has a card of its own, and gloo where ranks share a card (NCCL
refuses two ranks on one device) or run on the CPU; the step stays on the
card either way.

Each rank loads its own shard of the sample indices (data/loader.py), and
its batch is rows [r*B, (r+1)*B) of the global batch of W*B rows (`--batch`
is per process, as in the JAX package's multi-process runs). JAX computes
every step over the global batch; so does the port, inside
`sharded_batch()`:

  * the ops that couple a batch's rows reduce over the global batch
    (`all_reduce_sum`, `gather_rows`): the relative distances' numerator
    and denominator (ops/dsp.py), BatchNorm's moments (models/blocks.py),
    the codebooks' k-means, EMA and expiry on the gathered samples in rank
    order (models/quantization.py), the wasserstein MMD;
  * the draws are made at the global shape from the step's generator and
    each rank keeps its rows (train/steps.py::draw_noise);
  * each rank backpropagates its own loss, whose terms are its rows' means
    (and the global values of the coupled terms), through collectives
    whose backward is the all-reduce of the gradient (their adjoint), and
    the step averages the gradients over the ranks before the optimizers
    (`average_gradients`): the sum over ranks of the ranks' gradients of
    their own losses, over W, is the global batch's gradient;
  * the logged metrics are their mean over the ranks (`mean_over_ranks`).

Every rank then applies the same gradient and commits the same codebooks
and statistics, so the ranks stay bit-equal (JAX's replicated-decision
contract, rave_tpu/parallel/mesh.py:9-11).
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict, Iterable

import numpy as np
import torch
import torch.distributed as dist

_SHARDED = False  # inside sharded_batch() with more than one rank


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_main() -> bool:
    return rank() == 0


def backend_for(device: torch.device, local_world: int) -> str:
    """NCCL where each of the host's `local_world` ranks has a card of its
    own, gloo where they share one or run on the CPU."""
    if device.type == "cuda" and local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_from_env(device: torch.device) -> torch.device:
    """Join the process group torchrun's environment describes (once per
    process) and return this rank's device: card LOCAL_RANK modulo the
    host's cards on CUDA. Without WORLD_SIZE > 1, `device` as it is."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return device
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if device.type == "cuda":
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
        backend = backend_for(device, local_world)
        dist.init_process_group(backend, init_method="env://", world_size=world,
                                rank=int(os.environ["RANK"]))
        if is_main():
            print(f"data parallel: {world} ranks, backend {backend}, "
                  f"{'card' if device.type == 'cuda' else 'cpu'} step", flush=True)
    return device


def shutdown() -> None:
    """Leave the process group, after every rank got here (no-op without one)."""
    if dist.is_available() and dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def _coll_device(like: torch.device) -> torch.device:
    """Where a small host-side collective runs: the card under NCCL."""
    return like if dist.get_backend() == "nccl" else torch.device("cpu")


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


@contextlib.contextmanager
def sharded_batch():
    """Inside, the batch a step or validation sees is this rank's rows of
    the global batch, and the ops reduce over the global batch (no-op with
    one rank)."""
    global _SHARDED
    saved, _SHARDED = _SHARDED, world_size() > 1
    try:
        yield
    finally:
        _SHARDED = saved


def batch_shards() -> int:
    """The ranks the batch is split over: the world size inside
    `sharded_batch()`, else 1."""
    return world_size() if _SHARDED else 1


def rank_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a tensor of the global batch (rows r*B..(r+1)*B)."""
    n = batch_shards()
    if n == 1:
        return x
    b = x.shape[0] // n
    return x[rank() * b:(rank() + 1) * b]


def put_batch(x, device: torch.device) -> torch.Tensor:
    """This rank's rows of a host global batch, on `device`."""
    with sharded_batch():
        return rank_rows(torch.as_tensor(x)).to(device)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; its adjoint is the same sum of the gradients."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        return grad


class _GatherRows(torch.autograd.Function):
    """The ranks' tensors concatenated along dim 0 in rank order (as a sum
    of zero-padded copies: any backend, any device); its adjoint is this
    rank's rows of the summed gradient."""

    @staticmethod
    def forward(ctx, x):
        n, r = world_size(), rank()
        ctx.rows = x.shape[0]
        out = x.new_zeros((n * x.shape[0],) + tuple(x.shape[1:]))
        out[r * x.shape[0]:(r + 1) * x.shape[0]] = x
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        r, b = rank(), ctx.rows
        return grad[r * b:(r + 1) * b]


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the ranks the batch is split over (differentiable)."""
    return _AllReduceSum.apply(x) if batch_shards() > 1 else x


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's `x` concatenated along dim 0 in rank order, under
    `sharded_batch()` (differentiable); `x` itself otherwise."""
    return _GatherRows.apply(x) if batch_shards() > 1 else x


def average_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """Replace every parameter's gradient by its mean over the ranks, in one
    collective over their concatenation (no-op with one rank)."""
    n = batch_shards()
    if n == 1:
        return
    params = [p for p in params if p.grad is not None]
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    dist.all_reduce(flat)
    flat /= n
    offset = 0
    for p in params:
        k = p.grad.numel()
        p.grad.copy_(flat[offset:offset + k].view_as(p.grad))
        offset += k


def mean_over_ranks(metrics: Dict[str, object]) -> Dict[str, object]:
    """The tensor values of `metrics` averaged over the ranks, in one
    collective (numbers and the one-rank case pass as they are)."""
    n = batch_shards()
    keys = [k for k, v in metrics.items() if torch.is_tensor(v)]
    if n == 1 or not keys:
        return metrics
    flat = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
    dist.all_reduce(flat)
    flat /= n
    return {**metrics, **dict(zip(keys, flat.unbind()))}


def replicate(module: torch.nn.Module) -> None:
    """Broadcast `module`'s parameters and buffers from rank 0 (no-op with one rank)."""
    if world_size() == 1:
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, 0)


def broadcast_object(obj):
    """Rank 0's picklable `obj` on every rank."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, 0)
    return box[0]


def all_processes_min(value: int, device: torch.device = torch.device("cpu")) -> int:
    """The smallest `value` over the ranks (e.g. the common number of
    validation batches, so that the ranks' collectives stay in lockstep)."""
    if world_size() == 1:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64, device=_coll_device(device))
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return int(t.item())


def gather_to_hosts(x: torch.Tensor) -> np.ndarray:
    """Every rank's `x` concatenated along dim 0 in rank order, as numpy on every rank."""
    if world_size() == 1:
        return x.detach().cpu().numpy()
    with sharded_batch():
        return gather_rows(x.detach()).cpu().numpy()
