"""Process groups for data-parallel training across processes.

Counterpart of ``dualvar_tpu/core/mesh.py``. The JAX package runs one
program over a mesh whose ``data`` axis spans every device and lets XLA
insert the collectives; here each process runs the train step on its own
shard of the global batch (``batch_size`` is per process) and the step
calls the collectives itself:

* every train-mode batch norm normalises with the global batch's
  statistics (``models/layers.py``);
* the contrastive losses take their columns from the all-gathered global
  batch (``all_gather_with_grad``, ``models/ssl/losses.py``);
* MoCo enqueues the all-gathered keys (``models/ssl/moco.py``), and its
  batch-shuffled key pass gathers the key views, takes rank 0's batch
  permutation and averages the key encoder's running statistics over the
  processes;
* the gradient is averaged over the processes before the optimizer step
  (``average_gradients``), the logged metrics too (``mean_over_ranks``).

Launch with torchrun (``python -m torch.distributed.run --nproc_per_node N
-m dualvar_tpu_torch.train.pretrain ...``): ``init_distributed`` reads its
environment and joins the group, over NCCL on the card and gloo on the CPU.
Without that environment it does nothing and the run is one process, with
no collective anywhere. Under a group every collective runs, at a world
size of 1 as well.

``collectives`` counts the collectives this process issued, by kind.
"""

from __future__ import annotations

import collections
import datetime
import os
import warnings

import numpy as np
import torch
import torch.distributed as dist

# torchrun's variables. Any of them set means the process was launched to
# join a group: then all must be valid, and a failed rendezvous raises; it
# never goes on as one of N independent runs writing the same directory.
_LAUNCH_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT")
_RANK_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK")

collectives: collections.Counter = collections.Counter()

# torch 2.13 names all_gather_into_tensor deprecated; the call stays the same
warnings.filterwarnings("ignore", message=".*all_gather_into_tensor.*",
                        category=FutureWarning)


def _launch_env() -> dict[str, str] | None:
    """torchrun's variables that are set, or None when none is."""
    env = {k: os.environ[k] for k in _LAUNCH_VARS if os.environ.get(k)}
    return env or None


def init_distributed(device: str | torch.device = "cuda",
                     init_method: str | None = None,
                     timeout: datetime.timedelta | None = None) -> bool:
    """Join the process group torchrun's environment names; returns whether
    this process is in a group.

    * A group already initialised (an outer caller, or a second trainer call
      in this process) is kept as it is.
    * With none of ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
      ``MASTER_ADDR``, ``MASTER_PORT`` set, nothing happens: one process.
    * Otherwise ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` must be
      integers, with ``MASTER_ADDR`` and ``MASTER_PORT`` for the default
      ``env://`` rendezvous (``init_method`` names another, such as a
      ``file://`` store), or this raises ``ValueError``. A rendezvous that
      fails raises as well.
    * The backend is NCCL for a CUDA ``device`` (after
      ``torch.cuda.set_device(LOCAL_RANK)``) and gloo for the CPU. Without
      NCCL on the card it raises: gloo never stands in for it there.
    """
    if dist.is_available() and dist.is_initialized():
        return True
    env = _launch_env()
    if env is None:
        return False
    need = _RANK_VARS + (() if init_method else ("MASTER_ADDR",
                                                 "MASTER_PORT"))
    missing = [k for k in need if k not in env]
    if missing:
        raise ValueError(
            f"a distributed launch sets {sorted(env)} but not {missing}: "
            "launch with torchrun (python -m torch.distributed.run)")
    try:
        rank_, world, local = (int(env[k]) for k in _RANK_VARS)
        if "MASTER_PORT" in env:
            int(env["MASTER_PORT"])
    except ValueError:
        given = {k: env[k] for k in _RANK_VARS + ("MASTER_PORT",)
                 if k in env}
        raise ValueError(
            f"torchrun's variables must be integers: {given}") from None
    if not 0 <= rank_ < world:
        raise ValueError(f"RANK {rank_} is not in [0, WORLD_SIZE={world})")
    if not dist.is_available():
        raise RuntimeError("torch.distributed is not available in this "
                           "build, and a distributed launch was asked for")
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA run was launched on a machine without "
                               "a CUDA device")
        if not dist.is_nccl_available():
            raise RuntimeError("NCCL is not available: a CUDA run does not "
                               "take gloo in its place")
        torch.cuda.set_device(local)
        backend = "nccl"
        kw = {"device_id": torch.device("cuda", local)}
    else:
        backend, kw = "gloo", {}
    if timeout is not None:
        kw["timeout"] = timeout
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank_, world_size=world, **kw)
    return True


def active() -> bool:
    """Whether this process is in a process group."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def is_main() -> bool:
    """Rank 0, or the one process of a run without a group: the process
    that logs and writes the checkpoints."""
    return rank() == 0


def barrier() -> None:
    if active():
        collectives["barrier"] += 1
        dist.barrier()


def destroy() -> None:
    """Leave the process group, if this process is in one."""
    if active():
        dist.destroy_process_group()


def _comm_device() -> torch.device:
    """Where the backend takes its tensors: the current card under NCCL."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """In-place sum over the ranks."""
    collectives["all_reduce"] += 1
    dist.all_reduce(t)
    return t


def broadcast_(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """In place: ``t`` becomes rank ``src``'s."""
    collectives["broadcast"] += 1
    dist.broadcast(t, src)
    return t


def all_gather(t: torch.Tensor) -> torch.Tensor:
    """``t`` of every rank concatenated along dim 0 in rank order, no
    gradient. Every rank's ``t`` has the same shape."""
    t = t.contiguous()
    out = torch.empty((world_size() * t.shape[0],) + t.shape[1:],
                      dtype=t.dtype, device=t.device)
    collectives["all_gather"] += 1
    dist.all_gather_into_tensor(out, t)
    return out


class _AllGatherWithGrad(torch.autograd.Function):
    """The reference's GatherLayer (``utils/utils.py:321``): forward the
    all-gather; backward the incoming gradient summed over the ranks, then
    this rank's rows. The sum carries the gradient that every rank's loss
    sends to these rows; without it the gradient would be short by the other
    ranks' share."""

    @staticmethod
    def forward(ctx, x):
        ctx.rows = x.shape[0]
        return all_gather(x)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_(g.contiguous().clone())
        start = rank() * ctx.rows
        return g[start:start + ctx.rows]


def all_gather_with_grad(x: torch.Tensor) -> torch.Tensor:
    """``x`` of every rank concatenated along dim 0, with the gradient of
    each rank's rows flowing back to that rank; ``x`` itself without a
    group."""
    if not active():
        return x
    return _AllGatherWithGrad.apply(x)


def gather_concat(*arrays: np.ndarray) -> tuple[np.ndarray, ...]:
    """Host arrays of every rank concatenated along axis 0 in rank order
    (the JAX package's ``_gather_concat``); each array has the same shape on
    every rank, as the padded shards of ``shard_for_process`` give. Without
    a group: the arrays as they are."""
    if not active():
        return arrays
    device = _comm_device()
    out = []
    for a in arrays:
        a = np.ascontiguousarray(a)
        t = all_gather(torch.from_numpy(
            a.astype(np.int64) if a.dtype == np.bool_ else a).to(device))
        g = t.cpu().numpy()
        out.append(g.astype(np.bool_) if a.dtype == np.bool_ else g)
    return tuple(out)


def _by_dtype(tensors):
    groups: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return groups.values()


def sum_tensors_(tensors) -> None:
    """Every tensor replaced by its sum over the ranks, in place: one flat
    all-reduce a dtype. Without a group: nothing."""
    if not active():
        return
    for group in _by_dtype(list(tensors)):
        flat = all_reduce_(torch.cat([t.reshape(-1) for t in group]))
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def average_gradients(params) -> None:
    """Every gradient replaced by its mean over the ranks: one flat
    all-reduce a dtype. Without a group: nothing."""
    if not active():
        return
    grads = [p.grad for p in params if p.grad is not None]
    sum_tensors_(grads)
    torch._foreach_div_(grads, world_size())


def mean_over_ranks(values: dict[str, torch.Tensor]
                    ) -> dict[str, torch.Tensor]:
    """Each scalar averaged over the ranks, in one all-reduce: a mean over
    the local rows, averaged over ranks of equal batches, is the mean over
    the global batch. Without a group: the values as they are."""
    if not active() or not values:
        return values
    stacked = torch.stack([v.detach().reshape(()).to(torch.float64)
                           for v in values.values()])
    all_reduce_(stacked).div_(world_size())
    return {k: s.to(v.dtype) for (k, v), s in zip(values.items(), stacked)}


def sum_over_ranks(values: dict[str, float]) -> dict[str, float]:
    """Host numbers summed over the ranks, in one all-reduce (float64).
    Without a group: the values as they are."""
    if not active():
        return values
    t = all_reduce_(torch.tensor(list(values.values()), dtype=torch.float64,
                                 device=_comm_device()))
    return dict(zip(values, t.tolist()))


def gather_generator_states(generator: torch.Generator
                            ) -> list[torch.Tensor] | None:
    """Every rank's generator state, in rank order; None without a
    group."""
    if not active():
        return None
    g = all_gather(generator.get_state().to(_comm_device())[None]).cpu()
    return list(g.unbind(0))


def assert_replicas_equal(tensors, what: str) -> None:
    """Raise on every rank unless ``tensors`` are bitwise equal to rank 0's
    (parameters and buffers must start the same everywhere). Without a
    group: nothing."""
    if not active():
        return
    device = _comm_device()
    bad = 0
    for group in _by_dtype([t.detach() for t in tensors]):
        mine = torch.cat([t.reshape(-1) for t in group]).to(device)
        ref = broadcast_(mine.clone(), 0)
        bad += int(not torch.equal(mine, ref))
    flag = all_reduce_(torch.tensor([bad], dtype=torch.int64, device=device))
    if int(flag.item()):
        raise RuntimeError(f"{what} differ between ranks")
