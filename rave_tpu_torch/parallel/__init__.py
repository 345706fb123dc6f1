"""Data parallelism over processes (PyTorch port of rave_tpu/parallel/):
the process group from torchrun's environment, the batch's shards and the
collectives of a step over the global batch (mesh.py), and the
deterministic multi-process worker that tests it (mpworker.py)."""
from rave_tpu_torch.parallel.mesh import (
    all_processes_min, gather_to_hosts, init_from_env, put_batch, replicate, sharded_batch,
)

__all__ = ["all_processes_min", "gather_to_hosts", "init_from_env", "put_batch", "replicate",
           "sharded_batch"]
