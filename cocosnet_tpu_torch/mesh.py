"""Process groups for data and spatial parallelism: the port's counterpart
of cocosnet_tpu/mesh.py.

The JAX package runs one program over a (data, model) device mesh: the
batch shards over `data`, the correlation's query rows over `model`
(ops/corr_sp.py), and XLA inserts the collectives. The port runs one
process per device, torch's idiom, and names the same layout with process
groups: rank = d * model + k for data index d and model index k (JAX's
device order, process-major), the model groups consecutive ranks, the
data groups every model-th rank. `--batchSize` stays the global batch:
each data rank takes its contiguous `process_shard` of every global batch,
and the ranks of one model group take the same shard.

Backends: NCCL where each rank has a card of its own, gloo on the CPU
(gloo also takes CUDA tensors: chip_smoke.py runs two processes sharing
one card over it). `maybe_init_distributed`
joins a job: one started by torchrun (its environment), or one of
--num_processes hosts (--distributed, --coordinator_address, --process_id,
each host running one worker per local device), or the local workers that
the command-line twins spawn for --mesh_data / --mesh_model > 1. Nothing
here starts a process or opens a socket at import time.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist


def process_shard(global_batch_size: int, process_index: int = 0,
                  process_count: int = 1) -> tuple[int, int]:
    """(start, size) of this data rank's slice of every global batch
    (mesh.py:75-91 of the JAX package, there per host): the global batch
    split contiguously and equally; batchSize must divide."""
    if global_batch_size % process_count != 0:
        raise ValueError(
            f"global batchSize {global_batch_size} must be divisible by the "
            f"process count {process_count} (each host feeds an equal "
            f"contiguous shard)")
    size = global_batch_size // process_count
    return process_index * size, size


@dataclasses.dataclass
class Mesh:
    """A (data, model) layout of the job's ranks, with this rank's groups
    (None where the axis has one rank, or the job one process)."""
    data: int
    model: int
    rank: int
    data_group: Optional[object] = None
    model_group: Optional[object] = None

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    @property
    def size(self) -> int:
        return self.data * self.model

    def __str__(self) -> str:
        return (f"Mesh('data': {self.data}, 'model': {self.model}; rank "
                f"{self.rank} = data {self.data_rank} x model "
                f"{self.model_rank})")


def world() -> tuple[int, int]:
    """(rank, world size) of the job, (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def check_capturable() -> None:
    """Raises where the job's collectives cannot be captured in a CUDA
    graph: a job of more than one rank on gloo (NCCL's can)."""
    if world()[1] > 1 and dist.get_backend() != "nccl":
        raise RuntimeError(
            f"--steps_per_dispatch > 1 on the card captures the train step "
            f"as a CUDA graph, and a {dist.get_backend()} job's collectives "
            f"cannot be captured: run it on NCCL (a card a rank) or with "
            f"--steps_per_dispatch 1")


def create_mesh(data: int = 0, model: int = 1) -> Mesh:
    """The (data, model) layout over every rank of the job; data = 0 puts
    all of them on the data axis. Every rank of the job must call it, in
    the same order as its other groups: each group is made on all ranks."""
    rank, size = world()
    if model < 1 or size % model:
        raise ValueError(f"--mesh_model {model} must divide the job's "
                         f"{size} processes")
    if data == 0:
        data = size // model
    if data * model != size:
        raise ValueError(f"mesh {data} x {model} needs {data * model} "
                         f"processes; the job has {size}")
    mesh = Mesh(data, model, rank)
    if size == 1:
        return mesh
    for d in range(data):
        group = dist.new_group(list(range(d * model, (d + 1) * model)))
        if d == mesh.data_rank and model > 1:
            mesh.model_group = group
    for k in range(model):
        group = dist.new_group(list(range(k, size, model)))
        if k == mesh.model_rank and data > 1:
            mesh.data_group = group
    return mesh


_GLOBAL_MESH: Optional[Mesh] = None


def set_global_mesh(mesh: Optional[Mesh]) -> None:
    """Register the process-wide mesh (the twins set it after create_mesh;
    the correlation, the train step and the loss assembly read it)."""
    global _GLOBAL_MESH
    _GLOBAL_MESH = mesh


def global_mesh() -> Mesh:
    """The registered mesh, or one process alone."""
    return _GLOBAL_MESH if _GLOBAL_MESH is not None else Mesh(1, 1, 0)


# the environment torchrun (torch.distributed.run) gives each process of a
# job
RANK_ENV = "RANK"
WORLD_SIZE_ENV = "WORLD_SIZE"
MASTER_ADDR_ENV = "MASTER_ADDR"
LOCAL_RANK_ENV = "LOCAL_RANK"


def backend_for(device: torch.device) -> str:
    """NCCL on the cards (each rank holds one of its own: the twins size
    their jobs so), gloo on the CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


def env_job() -> bool:
    """True when torchrun (or another launcher) set the environment of a
    job: RANK, WORLD_SIZE and MASTER_ADDR."""
    return (os.environ.get(RANK_ENV) is not None
            and os.environ.get(WORLD_SIZE_ENV) is not None
            and os.environ.get(MASTER_ADDR_ENV) is not None)


def env_local_rank() -> int:
    """The process's index on its host, from torchrun's environment."""
    return int(os.environ.get(LOCAL_RANK_ENV, "0"))


def init_process_group(backend: str, init_method: str, rank: int,
                       world_size: int, timeout_s: int = 900) -> None:
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))


def check_distributed_flags(opt) -> None:
    """Raises unless --distributed comes with its address, host count and
    host index."""
    if not opt.coordinator_address or opt.num_processes < 1 \
            or not 0 <= opt.process_id < opt.num_processes:
        raise ValueError("--distributed needs --coordinator_address "
                         "HOST:PORT, --num_processes and --process_id")


def maybe_init_distributed(opt, device: torch.device, local_rank: int = 0,
                           local_count: int = 1,
                           init_method: str = "") -> bool:
    """Joins the job this process belongs to, if any; returns True when the
    job has more than one process.
    - torchrun's environment: init from it (env://), LOCAL_RANK its card;
    - --distributed: host --process_id of --num_processes at
      tcp://--coordinator_address, this process its local_rank-th of
      local_count workers: global rank process_id * local_count +
      local_rank, so --num_processes keeps the JAX package's meaning of
      hosts;
    - `init_method` (the twins' local workers): rank local_rank of
      local_count.
    The timeout is --dist_timeout_s, the JAX package's straggler bound."""
    timeout = int(getattr(opt, "dist_timeout_s", 900) or 900)
    backend = backend_for(device)
    if env_job():
        init_process_group(backend, "env://", int(os.environ[RANK_ENV]),
                           int(os.environ[WORLD_SIZE_ENV]), timeout)
    elif getattr(opt, "distributed", False):
        check_distributed_flags(opt)
        init_process_group(
            backend, f"tcp://{opt.coordinator_address}",
            opt.process_id * local_count + local_rank,
            opt.num_processes * local_count, timeout)
    elif init_method:
        init_process_group(backend, init_method, local_rank, local_count,
                           timeout)
    return world()[1] > 1


def mean_over_job(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The tensors averaged over every rank of the job, as one flat bucket
    and one all_reduce (the ranks of a model group hold the same values, so
    this is the mean over the data ranks, and every rank ends with the same
    bits); the tensors themselves where the job is one process."""
    size = world()[1]
    if size == 1 or not tensors:
        return list(tensors)
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    dist.all_reduce(flat)
    flat /= size
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view_as(t).to(t.dtype))
        at += t.numel()
    return out


def data_sum(x: torch.Tensor) -> torch.Tensor:
    """x summed over the data ranks (a sum over the global batch of what
    each rank summed over its shard), without a gradient; x where the data
    axis has one rank."""
    mesh = global_mesh()
    if mesh.data_group is None:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, group=mesh.data_group)
    return y


class _DataSum(torch.autograd.Function):
    """all_reduce(sum) over the data group, whose gradient is the data
    group's sum of the ranks' gradients: every rank's loss reads the
    global sum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def data_sum_grad(x: torch.Tensor) -> torch.Tensor:
    """x summed over the data ranks with its gradient (the synchronized
    BatchNorm's moments, nn/norms.py); x where the data axis has one
    rank. The model group is not summed over: its ranks hold the same
    maps."""
    mesh = global_mesh()
    if mesh.data_group is None:
        return x
    return _DataSum.apply(x, mesh.data_group)


def gather_data(x: torch.Tensor) -> torch.Tensor:
    """The global batch of a per-rank tensor: the data ranks' shards of the
    leading dimension, concatenated in data-rank order."""
    mesh = global_mesh()
    if mesh.data_group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.data)]
    dist.all_gather(parts, x.contiguous(), group=mesh.data_group)
    return torch.cat(parts, 0)


def gather_data_objects(obj) -> list:
    """Every data rank's picklable `obj`, in data-rank order (what the
    loader gave each rank: its host arrays and paths)."""
    mesh = global_mesh()
    if mesh.data_group is None:
        return [obj]
    out = [None] * mesh.data
    dist.all_gather_object(out, obj, group=mesh.data_group)
    return out


def broadcast_from_rank0(tensors: Sequence[torch.Tensor]) -> None:
    """Every rank takes rank 0's values of the tensors, in place."""
    if world()[1] == 1:
        return
    for t in tensors:
        dist.broadcast(t.data, src=0)


def barrier() -> None:
    if world()[1] > 1:
        dist.barrier()


def shutdown() -> None:
    """Leaves the job and forgets the mesh."""
    set_global_mesh(None)
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
