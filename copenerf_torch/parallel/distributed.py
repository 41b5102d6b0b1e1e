"""Multi-process execution, one process per GPU (port of
``copenerf_tpu/parallel/distributed.py``).

The JAX package shards rays over a 1-D ``('data',)`` device mesh and lets
GSPMD insert the gradient all-reduce; several hosts join through
``jax.distributed``. The port runs one process per card, launched by
``torchrun``, with the parameters replicated in every process: each rank
computes its share of the global batch's loss, the gradients are summed by
one NCCL all-reduce of a flat bucket, and both Adams then take the same
step on every rank. No DDP wrapper is needed: the train step owns its
backward and its optimizers.

Usage (the same program in every process)::

    torchrun --nproc-per-node N -m copenerf_torch.cli train cfg.yaml

    from copenerf_torch.parallel import distributed as dist
    dist.initialize()          # a no-op without torchrun's variables
    step = build_train_step(rcfg, static, group=dist.process_group())

Files and logs are written where ``is_primary()`` holds (rank 0).
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist


def local_rank() -> int:
    """This process's card on its host (torchrun's ``LOCAL_RANK``; 0
    without it)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def launched_world_size() -> int:
    """The world size torchrun's environment asks for (1 without it), read
    before any process group exists."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def initialize(backend: str | None = None, init_method: str = "env://",
               timeout: float | None = None) -> None:
    """Join the process group that torchrun's environment describes.

    Idempotent. Without ``RANK`` and ``WORLD_SIZE`` in the environment it is
    a no-op (one process, world size 1), like the JAX ``initialize``'s
    single-process no-op. ``backend`` defaults to ``"nccl"`` where CUDA is
    available and ``"gloo"`` on the CPU; an explicit ``"gloo"`` lets the
    tests run ranks on the CPU and the chip smoke share one card between
    two ranks. ``init_method`` is torchrun's ``env://`` unless the caller
    gives another (the tests use a ``file://`` store). ``timeout`` in
    seconds bounds every collective (the backend's default otherwise).

    The card is selected (``torch.cuda.set_device(LOCAL_RANK)``) before the
    group touches CUDA, and NCCL's communicator is made eagerly. NCCL with
    more ranks on a host than cards raises: NCCL refuses two ranks on one
    card, and nothing here turns such a launch into a Gloo one. On a card,
    local rank 0 builds the kernel library while the other ranks wait at
    the barrier, so one ``nvcc`` build serves the host."""
    if dist.is_initialized():
        return
    missing = [k for k in ("RANK", "WORLD_SIZE") if k not in os.environ]
    if len(missing) == 2:
        return
    if missing:
        raise RuntimeError(f"torchrun environment incomplete: {missing} unset")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = local_rank()
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    device_id = None
    if backend == "nccl":
        cards = torch.cuda.device_count()
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        if local_world > cards or local >= cards:
            raise RuntimeError(
                f"NCCL needs one card per rank: {local_world} rank(s) on this "
                f"host (local rank {local}) and {cards} card(s); launch with "
                f"torchrun --nproc-per-node {max(cards, 1)}")
        device_id = torch.device("cuda", local)
    on_card = torch.cuda.is_available() and local < torch.cuda.device_count()
    if on_card:
        torch.cuda.set_device(local)
    kwargs = {} if timeout is None else {
        "timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(backend, init_method=init_method, world_size=world,
                            rank=rank, device_id=device_id, **kwargs)
    if on_card and local == 0:
        from ..ops.kernels import build

        build.load_library()
    barrier()


def barrier() -> None:
    """Every rank meets here (a no-op in one process). Run once at bring-up
    (``initialize`` does): a broken fabric fails before any training is
    queued behind it, and local rank 0's kernel build ends before another
    rank loads the library."""
    if dist.is_initialized():
        dist.barrier()


def process_group():
    """The world group when a process group exists, else None: the train
    step's and the renderer's ``group`` (None is the single-device path)."""
    return dist.group.WORLD if dist.is_initialized() else None


def rank(group=None) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def world_size(group=None) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the process that writes files and logs (rank 0)."""
    return rank() == 0


def broadcast_(tensors, src: int = 0, group=None) -> None:
    """Overwrite ``tensors`` (on this rank's device) with rank ``src``'s,
    in place; a no-op in one process."""
    if not dist.is_initialized():
        return
    for t in tensors:
        dist.broadcast(t, src=src, group=group)


def all_reduce_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over the ranks in place (a no-op in one process)."""
    if dist.is_initialized():
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_reduce_grads_(params, group=None) -> int:
    """Sum the gradients of ``params`` over the ranks, in place, with one
    all-reduce of a flat f32 bucket; returns the bucket's bytes.

    Every parameter must hold a gradient: the bucket's layout must be the
    same on every rank. The sum is deterministic and every rank receives
    the same bytes, so the Adams that follow keep the replicas bitwise
    equal."""
    params = list(params)
    missing = [i for i, p in enumerate(params) if p.grad is None]
    if missing:
        raise ValueError(f"parameters {missing} of the gradient bucket have "
                         "no gradient")
    grads = [p.grad for p in params]
    bucket = torch.cat([g.reshape(-1) for g in grads])
    all_reduce_(bucket, group)
    off = 0
    for g in grads:
        n = g.numel()
        g.copy_(bucket[off:off + n].view_as(g))
        off += n
    return bucket.numel() * bucket.element_size()


def check_replicas(fields, group=None) -> None:
    """Raise unless every rank holds the same parameters, bit for bit (for
    example after ranks loaded different checkpoints or configs): two
    integer checksums of each tensor's bits, compared by one all-reduce
    (MAX of the checksums and of their negation)."""
    if not dist.is_initialized():
        return
    names, sums = [], []
    for name, p in fields.named_parameters():
        bits = p.detach().reshape(-1).contiguous().view(torch.int32).long()
        w = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
        names.append(name)
        sums.append(torch.stack([bits.sum(), (bits * w).sum()]))
    c = torch.stack(sums)
    both = torch.stack([c, -c])
    dist.all_reduce(both, op=dist.ReduceOp.MAX, group=group)
    differ = (both[0] != -both[1]).any(dim=1).nonzero().reshape(-1).tolist()
    if differ:
        raise RuntimeError(
            "the ranks' parameters differ (different configs or "
            f"checkpoints?): {[names[i] for i in differ][:8]}")
