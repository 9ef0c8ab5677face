"""Several processes, one device each (the port's counterpart of the JAX
package's data mesh, ``memotr_tpu/parallel/mesh.py``, and of
``jax.distributed``).

Every function reads the default ``torch.distributed`` process group, and
is a no-op (or the identity) when there is none or it holds one process,
so one code path serves both.  ``init_from_env`` starts the group under
``torchrun`` (``main.py --multi-host``); a caller that starts it itself
(``init_process_group``) is taken as it is.  Collectives run on the
tensors' own device: NCCL wants CUDA tensors, gloo takes CPU tensors and,
for ``all_reduce`` and ``broadcast``, CUDA ones.
"""
from __future__ import annotations

import os
from typing import Dict, Iterable, List, Tuple

import torch
import torch.distributed as dist

# what torchrun sets for each process
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT")


def rank_and_world() -> Tuple[int, int]:
    """(this process's rank, the group's size); (0, 1) without a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_main_process() -> bool:
    return rank_and_world()[0] == 0


def init_from_env(device_type: str) -> Tuple[int, int, int]:
    """Starts the default group from torchrun's environment (NCCL for a
    CUDA device, gloo for the CPU) unless one is running; returns (rank,
    world size, local rank).  Raises, naming the variables, outside
    torchrun."""
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"--multi-host needs torchrun's environment "
                           f"({', '.join(missing)} unset): run "
                           f"`torchrun --nproc_per_node <n> -m "
                           f"memotr_tpu_torch.main --multi-host ...`")
    local_rank = int(os.environ["LOCAL_RANK"])
    if not dist.is_initialized():
        if device_type == "cuda":
            torch.cuda.set_device(local_rank)
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                init_method="env://")
    rank, world = rank_and_world()
    return rank, world, local_rank


def barrier() -> None:
    if rank_and_world()[1] > 1:
        dist.barrier()


def all_reduce_sum_(t: torch.Tensor) -> torch.Tensor:
    """Sums ``t`` over the group in place; returns it."""
    if rank_and_world()[1] > 1:
        dist.all_reduce(t)
    return t


def all_reduce_grads_(params: Iterable[torch.nn.Parameter]) -> None:
    """Sums the gradients over the group, one flat bucket a dtype (every
    parameter must have a gradient; ``engine/trainer.py`` fills the
    missing ones with zeros first).  Summed, not averaged: each rank's
    loss is its clips' share of the global loss (the global GT count
    normalizes it), so the sum is the global batch's gradient, which
    JAX's data mesh takes."""
    if rank_and_world()[1] == 1:
        return
    buckets: Dict[torch.dtype, List[torch.Tensor]] = {}
    for p in params:
        buckets.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in buckets.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        start = 0
        for g in grads:
            g.copy_(flat[start:start + g.numel()].view_as(g))
            start += g.numel()


def broadcast_module_(module: torch.nn.Module, src: int = 0) -> None:
    """Every parameter and buffer of ``module`` from rank ``src``."""
    if rank_and_world()[1] == 1:
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src)


def sum_over_ranks(values: Dict[str, Tuple[float, int]]
                   ) -> Dict[str, Tuple[float, int]]:
    """Per name, ``(sum, count)`` summed over the group, over the union of
    the ranks' names (a name a rank lacks counts ``(0, 0)`` there)."""
    if rank_and_world()[1] == 1:
        return dict(values)
    names: List[List[str]] = [[] for _ in range(dist.get_world_size())]
    dist.all_gather_object(names, sorted(values))
    union = sorted(set().union(*names))
    device = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    local = torch.tensor([list(values.get(n, (0.0, 0))) for n in union],
                         dtype=torch.float64, device=device)
    dist.all_reduce(local)
    return {n: (float(s), int(c)) for n, (s, c) in zip(union, local.tolist())}
