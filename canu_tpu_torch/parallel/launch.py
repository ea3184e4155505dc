"""Multi-process bootstrap and the collectives of the sharded path
(counterpart of canu_tpu.parallel.launch, on torch.distributed).

The reference distributes work by submitting grid job arrays over a
shared filesystem (Grid_*.pm); canu_tpu joins one jax process per host
into a device mesh.  Here one process drives one card: a world of n
ranks plays the role of canu_tpu's mesh of n devices, and the rank and
world size play jax.process_index() and jax.process_count().

init_distributed() wires a process into the world from the launcher's
environment, in canu_tpu's order (canu.pl:294-319's detect-then-
configure probing): explicit arguments, then SLURM (SLURM_NTASKS /
SLURM_PROCID / SLURM_LAUNCH_NODE_IPADDR), then torchrun (WORLD_SIZE /
RANK / MASTER_ADDR / MASTER_PORT / LOCAL_RANK), which takes the place of
the TPU-pod autodetect.  The tensor group is NCCL when the rank's device
is a card and gloo on the CPU unless the caller names one; a gloo side
group carries host scalars and barriers, so a barrier never has to guess
a card.  Every tensor crosses the wire as int32 or int64 (NCCL has no
uint32: the port holds uint32 values in int64 tensors, and to_wire
bit-casts them to int32 and back).  Where the tensor group is gloo and
the tensors live on a card, ``wire`` moves them to the CPU and back
around the collective; the compute stays on the rank's device.

STATS counts each collective's calls, bytes sent by this rank and wall
seconds (host clock, after the card has finished the collective).
"""

from __future__ import annotations

import os
import time
import zlib
from dataclasses import dataclass

import numpy as np
import torch

MASK32 = 0xFFFFFFFF

# per collective: [calls, bytes this rank sent, wall seconds]
STATS: dict[str, list] = {}

# the gloo side group and the tensor group's device, set by init_distributed
_HOST_GROUP = None
_WIRE_DEVICE: torch.device | None = None


@dataclass
class HostShard:
    """This rank's slice of the read set (1-based id range, inclusive-lo,
    exclusive-hi), the job-array partitioning of OverlapMhap.pm:191-296
    as a deterministic function of the rank."""

    process_index: int
    process_count: int
    lo: int
    hi: int

    @property
    def n_local(self) -> int:
        return self.hi - self.lo


def host_read_shard(n_reads: int, process_index: int, process_count: int) -> HostShard:
    """Contiguous 1-based read-id range owned by this rank."""
    per = (n_reads + process_count - 1) // process_count
    lo = 1 + process_index * per
    hi = min(1 + (process_index + 1) * per, n_reads + 1)
    return HostShard(process_index, process_count, lo, max(lo, hi))


def all_host_shards(n_reads: int, process_count: int) -> list[HostShard]:
    return [host_read_shard(n_reads, p, process_count) for p in range(process_count)]


def launcher_env(environ=None) -> tuple[str | None, int | None, int | None, int | None]:
    """(coordinator, world size, rank, local rank) from SLURM's or
    torchrun's environment, SLURM first; all None when neither names a
    world of more than one process."""
    env = os.environ if environ is None else environ
    if int(env.get("SLURM_NTASKS", "1")) > 1:
        local = env.get("SLURM_LOCALID")
        return (env.get("SLURM_LAUNCH_NODE_IPADDR", "") + ":12321", int(env["SLURM_NTASKS"]),
                int(env["SLURM_PROCID"]), int(local) if local is not None else None)
    if int(env.get("WORLD_SIZE", "1")) > 1:
        # env:// reads MASTER_ADDR/MASTER_PORT, and joins the store that
        # torchrun's agent already serves there
        local = env.get("LOCAL_RANK")
        return ("env://", int(env["WORLD_SIZE"]), int(env["RANK"]),
                int(local) if local is not None else None)
    return None, None, None, None


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, backend: str | None = None,
                     device=None) -> tuple[int, int]:
    """Join the process world; returns (rank, world size).

    Single-process (no coordinator given and no launcher environment) it
    does nothing and returns (0, 1); in a process already joined it
    returns its (rank, world).  ``coordinator`` is "host:port" (TCP) or an
    init URL ("tcp://...", "file://..." for a FileStore).  ``device``: the
    rank's device, the card cuda:<local rank> (or rank % cards) unless
    the caller names one or asks for "cpu"; the tensor group is NCCL on
    a card and gloo on the CPU unless ``backend`` names one.
    """
    import torch.distributed as dist

    global _HOST_GROUP, _WIRE_DEVICE
    if joined():
        return rank_world()
    local = None
    if coordinator is None:
        coordinator, num_processes, process_id, local = launcher_env()
    if coordinator is None:
        return 0, 1
    if num_processes is None or process_id is None:
        raise ValueError("init_distributed needs the world size and the rank with a coordinator")
    from ..device import resolve_device

    if device is None:
        n_cards = torch.cuda.device_count()
        dev = resolve_device(f"cuda:{local if local is not None else process_id % max(1, n_cards)}")
    else:
        dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=url, world_size=num_processes,
                            rank=process_id)
    _HOST_GROUP = dist.new_group(backend="gloo") if backend != "gloo" else dist.group.WORLD
    _WIRE_DEVICE = dev if backend == "nccl" else torch.device("cpu")
    return dist.get_rank(), dist.get_world_size()


def shutdown() -> None:
    """Leave the world (a no-op single-process)."""
    import torch.distributed as dist

    global _HOST_GROUP, _WIRE_DEVICE
    if joined():
        dist.destroy_process_group()
    _HOST_GROUP = _WIRE_DEVICE = None


def joined() -> bool:
    """True in a process that has joined a world (of any size)."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def rank_world() -> tuple[int, int]:
    """(rank, world size); (0, 1) outside a world."""
    import torch.distributed as dist

    return (dist.get_rank(), dist.get_world_size()) if joined() else (0, 1)


def backend() -> str | None:
    """The tensor group's backend ("nccl", "gloo"); None outside a world."""
    import torch.distributed as dist

    return dist.get_backend() if joined() else None


def is_distributed() -> bool:
    return rank_world()[1] > 1


def is_writer() -> bool:
    """True on the rank that owns shared-file writes (rank 0, or any
    single-process run).  The reference's equivalent is the grid
    executive: one canu.pl writes stage outputs while job arrays write
    only their own per-job files (Execution.pm:1036-1276)."""
    return rank_world()[0] == 0


def barrier(name: str) -> None:
    """Cross-process sync point on the gloo side group (a no-op
    single-process): every rank must arrive under the same ``name``, else
    it raises on every rank (jax's sync_global_devices checks its name the
    same way), so ranks out of step fail instead of pairing unrelated
    barriers.  The stage runner uses it to make file-existence resume
    coherent: done() is consulted only once every rank has passed the
    previous stage's writes."""
    if not is_distributed():
        return
    t0 = time.perf_counter()
    h = zlib.crc32(name.encode())
    got = host_all_gather(np.asarray([h]))[:, 0]
    _count("barrier", 0, t0)
    if (got != h).any():
        raise RuntimeError(f"barrier {name!r}: the ranks are out of step "
                           f"(name hashes {got.tolist()})")


def writer_value(flag: bool) -> bool:
    """Rank 0's ``flag`` on every rank (``flag`` itself single-process): one
    reading of the shared filesystem that every rank acts on."""
    if not is_distributed():
        return bool(flag)
    return bool(host_all_gather(np.asarray([int(flag)]))[0, 0])


# ---- collectives ------------------------------------------------------------


def _count(name: str, nbytes: int, t0: float) -> None:
    s = STATS.setdefault(name, [0, 0, 0.0])
    s[0] += 1
    s[1] += int(nbytes)
    s[2] += time.perf_counter() - t0


def to_wire(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor of uint32 values -> int32 bit patterns (half the bytes)."""
    return x.to(torch.int32)


def from_wire(x: torch.Tensor) -> torch.Tensor:
    """to_wire's inverse: int32 bit patterns -> int64 uint32 values."""
    return x.to(torch.int64) & MASK32


def wire(t: torch.Tensor) -> torch.Tensor:
    """t on the tensor group's device (the card for NCCL, the CPU for gloo)."""
    return t.to(_WIRE_DEVICE) if t.device != _WIRE_DEVICE else t


def _done(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def all_to_all(send: torch.Tensor) -> torch.Tensor:
    """all_to_all_single over dim 0 of ``send`` in equal splits, one a rank;
    the result on send's device.  Outside a world it returns a copy."""
    import torch.distributed as dist

    if not joined():
        return send.clone()
    t0 = time.perf_counter()
    src = wire(send.contiguous())
    recv = torch.empty_like(src)
    dist.all_to_all_single(recv, src)
    out = recv.to(send.device)
    _done(out)
    _count("all_to_all", send.numel() * send.element_size(), t0)
    return out


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """Equal-shape all-gather: [world * t.shape[0], ...] in rank order
    (``group``'s ranks, the default group's unless given)."""
    import torch.distributed as dist

    if not joined():
        return t.clone()
    t0 = time.perf_counter()
    n = dist.get_world_size(group)
    src = wire(t.contiguous())
    out = torch.empty((n * t.shape[0], *t.shape[1:]), dtype=t.dtype, device=src.device)
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, src, group=group)  # all_gather_into_tensor's newer name, where torch has it
    out = out.to(t.device)
    _done(out)
    _count("all_gather", t.numel() * t.element_size(), t0)
    return out


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    import torch.distributed as dist

    if not joined():
        return t.clone()
    t0 = time.perf_counter()
    src = wire(t.clone())
    dist.all_reduce(src)
    out = src.to(t.device)
    _done(out)
    _count("all_reduce", t.numel() * t.element_size(), t0)
    return out


def ring_shift(t: torch.Tensor) -> torch.Tensor:
    """Send ``t`` to rank (r - 1) % n and return what rank (r + 1) % n
    sent: one step of the ring (canu_tpu's ppermute to the next-lower
    device)."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    r, n = rank_world()
    src = wire(t.contiguous())
    recv = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, (r - 1) % n), dist.P2POp(dist.irecv, recv, (r + 1) % n)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    out = recv.to(t.device)
    _done(out)
    _count("ring_shift", t.numel() * t.element_size(), t0)
    return out


def host_all_gather(x: np.ndarray) -> np.ndarray:
    """Equal-shape all-gather of a small host int64 array on the gloo side
    group: [world, *x.shape] in rank order (a world of one: x[None])."""
    import torch.distributed as dist

    a = np.ascontiguousarray(x, np.int64)
    if not is_distributed():
        return a[None]
    t0 = time.perf_counter()
    t = torch.from_numpy(a)
    out = [torch.empty_like(t) for _ in range(rank_world()[1])]
    dist.all_gather(out, t, group=_HOST_GROUP)
    _count("host_all_gather", a.nbytes, t0)
    return np.stack([o.numpy() for o in out])


def host_max(value: int) -> int:
    """The largest of every rank's ``value``."""
    return int(host_all_gather(np.asarray([value])).max())


def all_gather_rows(rows: torch.Tensor) -> torch.Tensor:
    """All-gather of every rank's rows [m_r, ...] (any m_r), concatenated in
    rank order on rows' device: the counts on the side group, the rows
    padded to the largest count on the tensor group."""
    counts = host_all_gather(np.asarray([rows.shape[0]]))[:, 0]
    cap = int(counts.max(initial=0))
    if cap == 0:
        return rows
    pad = torch.zeros((cap, *rows.shape[1:]), dtype=rows.dtype, device=rows.device)
    pad[: rows.shape[0]] = rows
    got = all_gather(pad).reshape(len(counts), cap, *rows.shape[1:])
    return torch.cat([got[p, : counts[p]] for p in range(len(counts))])
