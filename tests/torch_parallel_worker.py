"""One rank of a gloo world on the CPU for tests/test_torch_parallel.py.

    python tests/torch_parallel_worker.py <rank> <world> <init url> <out dir>

Joins the world, runs every function of canu_tpu_torch.parallel on the
small sets of the JAX package's parallel tests, and saves what this rank
got to <out dir>/rank<rank>.npz, which the test holds against canu_tpu's
same function at the same n.  Imports nothing of jax or canu_tpu.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

CPU = torch.device("cpu")


def sets():
    """(read set, store rows) of the JAX package's tests: test_storesort.py's
    sharded-stage smoke reads and its random overlaps."""
    from canu_tpu_torch.io.overlaps_io import random_overlaps
    from canu_tpu_torch.sim.simulate import random_genome, simulate_reads

    g = random_genome(6_000, seed=9)
    rs, _ = simulate_reads(g, coverage=4, mean_len=900, min_len=500, max_len=1400,
                           error_rate=0.04, seed=10, circular=False)
    return rs, random_overlaps(5000, n_reads=400, seed=9)


def step_block(rs, n: int, r: int):
    """This rank's row block of the count steps (parallel.shard_overlap._mesh_rows)."""
    from canu_tpu_torch.parallel.shard_overlap import _mesh_rows
    from canu_tpu_torch.utils.bitpack import n_words

    W = 1 << max(0, int(n_words(rs.max_length) - 1).bit_length())
    return _mesh_rows(rs, n, W, CPU)[:2]


def overlap_step_case():
    """test_parallel.py's sharded overlap step inputs: (words, lengths,
    seeds, fk) of 32 reads, 32 hash seeds."""
    from canu_tpu_torch.ops.hashing import hash_seeds
    from canu_tpu_torch.sim.simulate import random_genome, simulate_reads
    from canu_tpu_torch.utils.bitpack import n_words

    g = random_genome(6000, seed=99)
    rs, _ = simulate_reads(g, coverage=6, mean_len=700, min_len=400, error_rate=0.05, seed=98)
    N = 32
    W = 1 << (n_words(rs.max_length) - 1).bit_length()
    ids = np.arange(1, min(rs.n_reads, N) + 1)
    words, lengths = rs.block_words(ids, W)
    if len(ids) < N:
        words = np.vstack([words, np.zeros((N - len(ids), W), np.uint32)])
        lengths = np.concatenate([lengths, np.zeros(N - len(ids), np.int32)])
    return words, lengths, hash_seeds(32), np.full(1, 0xFFFFFFFF, np.uint32)


def stage_order(rank: int, out_dir: str) -> np.ndarray:
    """A writer-only stage whose done() reads the shared directory late on
    every rank but 0 (after the writer's output has landed), then a
    collective stage: the stage runner must keep the ranks in step, so
    every rank runs the all_gather of the second stage.  Returns its
    result (every rank's id, in rank order)."""
    import time

    from canu_tpu_torch.config import Config
    from canu_tpu_torch.parallel import launch
    from canu_tpu_torch.pipeline.driver import make_ctx, run_stage

    ctx = make_ctx(os.path.join(out_dir, "stages"), "t", Config())
    marker = ctx.path("written")

    def written() -> bool:
        if rank:
            time.sleep(0.5)
        return os.path.exists(marker)

    run_stage(ctx, "write", written, lambda: open(marker, "w").close())
    got: list = []
    run_stage(ctx, "gather", lambda: bool(got),
              lambda: got.append(launch.all_gather(torch.tensor([rank]))), collective=True)
    return got[0].numpy()


def main(rank: int, world: int, url: str, out_dir: str) -> None:
    from canu_tpu_torch.ops import kmer as K
    from canu_tpu_torch.ops import minhash as MH
    from canu_tpu_torch.ops.hashing import u32_tensor
    from canu_tpu_torch.parallel import launch, mesh, shard_overlap as SO, storesort as SS
    from canu_tpu_torch.stores.overlaps import _COLS, OverlapStore, store_digest

    torch.set_num_threads(1)
    got = launch.init_distributed(url, world, rank, device="cpu")
    assert got == (rank, world) and launch.init_distributed() == got, got
    assert launch.backend() == "gloo" and launch.is_writer() == (rank == 0)
    out: dict[str, np.ndarray] = {}
    rs, table = sets()

    # the count steps and the whole-readset count, k=16 (one lane) and 22
    for k in (16, 22):
        words, lengths = step_block(rs, world, rank)
        if k > 16:
            hi, lo, ct, hist, dropped = mesh.sharded_kmer_count_step2(k=k)(words, lengths)
            out["step22_hi"], out["step22_lo"] = hi.numpy(), lo.numpy()
        else:
            km, ct, hist, dropped = mesh.sharded_kmer_count_step(k=k)(words, lengths)
            out["step16_kmers"] = km.numpy()
        out[f"step{k}_counts"], out[f"step{k}_hist"] = ct.numpy(), hist.numpy()
        out[f"step{k}_dropped"] = dropped.numpy()
        kc = SO.sharded_count_readset(rs, k=k, device=CPU)
        out[f"count{k}_unique"], out[f"count{k}_counts"] = kc.unique, kc.counts
        try:
            SO.sharded_count_readset(rs, k=k, bin_capacity=4, device=CPU)
            out[f"count{k}_raised"] = np.zeros(1, bool)
        except RuntimeError as e:
            out[f"count{k}_raised"] = np.array(["dropped k-mers" in str(e)])

    # the ring on the port's sketches (the test runs canu_tpu's ring on them)
    fk = K.frequent_kmers(K.count_readset_device(rs, k=16, block_size=64, device=CPU),
                          distinct_fraction=0.9995)
    sk = MH.build_sketches(rs, k=16, n_hashes=64, frequent=fk, block_size=64, device=CPU)
    pairs = SO.sharded_find_candidates(sk, min_matches=2, device=CPU)
    out["sketches"], out["ring"] = sk, pairs

    # sharded verification: raw rows, the strided full verify, and the
    # range-exchanged store shards merged by rank 0
    out["verify_rows"] = SO.sharded_verify_candidates(rs, pairs[:24], k=16, band=128,
                                                      device=CPU)
    tab = SO.process_sharded_verify(rs, pairs, k=16, chunk=64, device=CPU)
    out["psv_rows"] = np.stack([getattr(tab, c).astype(np.int64) for c in _COLS], 1)
    mine = SO.process_sharded_store_rows(rs, pairs, k=16, chunk=64, device=CPU)
    out["store_rows_mine"] = mine
    np.save(os.path.join(out_dir, f"shard{rank:04d}.npy"), mine)
    launch.barrier("shards")
    if rank == 0:
        shards = [os.path.join(out_dir, f"shard{p:04d}.npy") for p in range(world)]
        OverlapStore.save_from_row_shards(shards, rs.n_reads, os.path.join(out_dir, "st"))
        out["store_digest"] = np.array([store_digest(OverlapStore.load(
            os.path.join(out_dir, "st")))])

    # the store sorts
    rows4 = np.stack([table.a_id, table.b_id, table.a_bgn, table.a_end], axis=1).astype(np.int32)
    flat, shard = SS.make_flat_mesh(), mesh.make_shard_mesh()
    out["mesh_sizes"] = np.array([flat.size(), shard.size()])
    out["sorted"] = SS.distributed_store_sort(rows4, n_reads=400, mesh=flat, device=CPU)
    sym = SO.table_to_sym_rows(table)
    out["exchanged"] = SS.process_range_exchange(sym[rank::world], 400, device=CPU)

    # the 2-D sketch + match step on a world of 4 (2 x 2)
    if world == 4:
        m = mesh.make_overlap_mesh(4)
        ri, hi_ = m.get_coordinate()
        words, lengths, seeds, fkw = overlap_step_case()
        nr, nh = m.size(0), m.size(1)
        B, Hl = len(words) // nr, len(seeds) // nh
        cnt = mesh.sharded_overlap_step(m, k=16, min_matches=2)(
            u32_tensor(words[ri * B : (ri + 1) * B], CPU),
            torch.from_numpy(lengths[ri * B : (ri + 1) * B]),
            u32_tensor(seeds[hi_ * Hl : (hi_ + 1) * Hl], CPU), u32_tensor(fkw, CPU))
        out["overlap_step"] = cnt.numpy()
        out["overlap_step_coord"] = np.array([ri, hi_, nr, nh])

    out["stage_order"] = stage_order(rank, out_dir)
    out["stats_calls"] = np.array([launch.STATS.get(c, [0])[0]
                                   for c in ("all_to_all", "all_gather", "ring_shift")])
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    launch.shutdown()
    print("RANK_OK", rank, flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
