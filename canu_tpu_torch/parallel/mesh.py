"""Sharding of the overlap pipeline over a world of ranks (counterpart of
canu_tpu.parallel.mesh, on torch.distributed).

canu_tpu replaces the reference's grid-array distribution (the
hash-block x query-block MHAP job matrix, OverlapMhap.pm:191-296, plus
its shared-filesystem shuffle) with a device mesh and XLA collectives.
Here a rank drives one card and the mesh is a DeviceMesh over the world:

  * dim 'r' (data parallel): reads are split across ranks, each rank
    sketches its own read block;
  * dim 'h' (hash range): the H min-hash slots are split, each rank
    computing its slice of every local read's sketch;
  * collectives: all_gather over 'h' assembles full sketches, all_gather
    over 'r' replaces the filesystem all-vs-all.

The k-mer count steps route every k-mer to its owner rank (mix32(kmer)
mod n, fold2(hi, lo) mod n at k > 16) with one all_to_all and count the
owner's hash range with a local sort, so local counts are global
counts.  Each step is a plain function of this rank's tensors: it takes
the rank's rows and returns its owner shard.  A mesh spans the whole
world (a world of one outside init_distributed).
"""

from __future__ import annotations

import torch

from ..ops.hashing import mix32
from ..ops.kmer import INVALID_KMER, extract_kmers_any
from ..ops.minhash import _sketch_kernel, slot_counts
from .launch import all_gather, all_reduce_sum, all_to_all, from_wire, rank_world, to_wire

UINT32_MAX = 0xFFFFFFFF


def _mesh(shape: tuple, names: tuple):
    from torch.distributed.device_mesh import init_device_mesh

    from .launch import backend, joined

    n = 1
    for s in shape:
        n *= s
    if not joined() or rank_world()[1] != n:
        raise ValueError(f"a mesh of {n} ranks needs a world of {n} (init_distributed); "
                         f"this process is in a world of {rank_world()[1]}")
    return init_device_mesh("cuda" if backend() == "nccl" else "cpu", shape,
                            mesh_dim_names=names)


def make_overlap_mesh(n_devices: int | None = None):
    """2-D mesh ('r' reads x 'h' hash range) over the world's n ranks, the
    JAX rule's shape (8 -> 4x2, 4 -> 2x2, odd n -> n x 1)."""
    n = n_devices or rank_world()[1]
    h = 2 if n % 2 == 0 and n >= 2 else 1
    return _mesh((n // h, h), ("r", "h"))


def make_shard_mesh(n_devices: int | None = None):
    """1-D mesh ('s') for shuffle-style stages (k-mer count, store sort)."""
    return _mesh((n_devices or rank_world()[1],), ("s",))


def _world(mesh) -> int:
    """Ranks of a 1-D mesh (the world's unless given); it must be the world."""
    n = rank_world()[1]
    if mesh is not None and mesh.size() != n:
        raise ValueError(f"a 1-D mesh must span the world ({n} ranks), not {mesh.size()}")
    return n


def _local_sketch(words, lengths, seeds, fk, k: int) -> torch.Tensor:
    """Sketch one read block against a slice of hash seeds: int64[B, H_loc]
    (kernel K5 on the card, ops.minhash._sketch_kernel)."""
    return _sketch_kernel(words, lengths, seeds, fk, k)


def _count_matches(SA: torch.Tensor, SB: torch.Tensor, min_matches: int) -> torch.Tensor:
    """Slot agreements int32[Na, Nb] of two sketch blocks (UINT32_MAX slots
    never match): kernel K6's count launch on the card (ops.minhash
    slot_counts)."""
    return slot_counts(SA, SB)


def sharded_overlap_step(mesh, k: int = 16, min_matches: int = 3):
    """The sharded sketch + match step on a 2-D mesh.

    Returns step(words [B, W], lengths [B], seeds [H_loc], fk [F]) ->
    int32[B, N]: this rank's read block (its 'r' coordinate's rows) and
    hash-seed slice (its 'h' coordinate's) in, its rows' slot agreements
    with every read out, the candidate-generation "forward pass".
    """
    gh, gr = mesh.get_group("h"), mesh.get_group("r")
    nh = mesh.size(mesh.mesh_dim_names.index("h"))

    def step(words, lengths, seeds_local, fk):
        sk_h = _local_sketch(words, lengths, seeds_local, fk, k)  # [B, H_loc]
        B, H_loc = sk_h.shape
        g = from_wire(all_gather(to_wire(sk_h), group=gh))  # [nh * B, H_loc]
        sk = g.reshape(nh, B, H_loc).permute(1, 0, 2).reshape(B, nh * H_loc)
        sk_all = from_wire(all_gather(to_wire(sk), group=gr))  # [N, H]
        return _count_matches(sk, sk_all, min_matches)

    return step


def _route(owner: torch.Tensor, n: int, cap: int):
    """Stable bin placement of each element: (order, dest, slot, keep,
    n_dropped) with the elements sorted stably by owner (n = invalid),
    dest/slot their bin and rank in it, keep those with a slot below cap."""
    owner_s, order = torch.sort(owner, stable=True)
    start = torch.searchsorted(owner_s, torch.arange(n + 1, device=owner.device))
    own_i = torch.clamp(owner_s, max=n)
    rank = torch.arange(owner.shape[0], device=owner.device) - start[own_i]
    live = owner_s < n
    keep = live & (rank < cap)
    n_dropped = (live & (rank >= cap)).sum().reshape(1)
    return order, own_i[keep], rank[keep], keep, n_dropped


def sharded_kmer_count_step(mesh=None, k: int = 16, bin_capacity: int = 0):
    """Distributed k-mer counting by hash range (the multi-host meryl).

    step(words [B, W], lengths [B]) -> (kmers int64[n*cap] this rank's
    owner shard, sorted, INVALID-padded; counts int64[n*cap] at run
    starts; hist int64[65] summed over ranks; n_dropped int64[1] summed):
    every local canonical k-mer goes to its owner rank (mix32(kmer) mod
    n) in ONE all_to_all, the collective that replaces the reference's
    disk shuffle (ovStore-style bucketize/sort, SURVEY §2.13(3)), then the
    owner counts its range with a sort.  bin_capacity: send slots per
    destination (0 = max(128, 2 * local k-mers / n)); k-mers beyond it are
    dropped and counted in n_dropped.
    """
    from ..ops.kmer import histogram_device, sort_count

    n = _world(mesh)

    def step(words, lengths):
        canon, _ = extract_kmers_any(words, lengths, k)
        km = canon.reshape(-1)
        cap = bin_capacity or max(128, (2 * km.shape[0]) // n)
        owner = torch.where(km != INVALID_KMER, mix32(km) % n, n)
        order, dest, slot, keep, n_dropped = _route(owner, n, cap)
        send = torch.full((n, cap), INVALID_KMER, dtype=torch.int64, device=km.device)
        send[dest, slot] = km[order][keep]
        recv = from_wire(all_to_all(to_wire(send)))
        mine, counts = sort_count(recv.reshape(-1))
        hist = histogram_device(torch.where(mine != INVALID_KMER, counts, 0), 64)
        return mine, counts, all_reduce_sum(hist), all_reduce_sum(n_dropped)

    return step


def sharded_kmer_count_step2(mesh=None, k: int = 22, bin_capacity: int = 0):
    """Distributed exact two-lane k-mer counting for 16 < k <= 32.

    The same hash-range shuffle as sharded_kmer_count_step, with a k-mer
    in two uint32 lanes (ops.kmer.extract_kmers2): the owner is
    fold2(hi, lo) mod n and both lanes travel in one all_to_all.  The
    obt/utg phases count k=22 (Defaults.pm ovlMerSize), so the multi-host
    meryl covers the two-lane path too.

    step(words, lengths) -> (hi int64[n*cap], lo int64[n*cap], counts,
    hist int64[65] summed, n_dropped int64[1] summed).
    """
    from ..ops.kmer import extract_kmers2, fold2, histogram_device, sort_count2

    n = _world(mesh)

    def step(words, lengths):
        hi, lo, _strand, valid = extract_kmers2(words, lengths, k)
        v = valid.reshape(-1)
        hi = torch.where(v, hi.reshape(-1), INVALID_KMER)
        lo = torch.where(v, lo.reshape(-1), INVALID_KMER)
        cap = bin_capacity or max(128, (2 * hi.shape[0]) // n)
        owner = torch.where(v, fold2(hi, lo) % n, n)
        order, dest, slot, keep, n_dropped = _route(owner, n, cap)
        send = torch.full((n, 2, cap), INVALID_KMER, dtype=torch.int64, device=hi.device)
        send[dest, 0, slot] = hi[order][keep]
        send[dest, 1, slot] = lo[order][keep]
        recv = from_wire(all_to_all(to_wire(send)))
        mh, ml, counts = sort_count2(recv[:, 0, :].reshape(-1), recv[:, 1, :].reshape(-1))
        live = (mh != INVALID_KMER) | (ml != INVALID_KMER)
        hist = histogram_device(torch.where(live, counts, 0), 64)
        return mh, ml, counts, all_reduce_sum(hist), all_reduce_sum(n_dropped)

    return step
