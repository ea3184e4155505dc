"""canu_tpu_torch.parallel against canu_tpu.parallel at the same n.

A module fixture starts gloo worlds of 1, 2 and 4 CPU ranks
(tests/torch_parallel_worker.py, a FileStore in tmp_path, one torch
thread a rank); each rank runs every function of the port's parallel/
on the small sets of tests/test_parallel.py and tests/test_storesort.py
and saves its results, while this process runs canu_tpu's same function
on a mesh of as many of the conftest's virtual CPU devices, and the
port's single-device path.  Every output is an integer: all are held
exactly.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_cases import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
WORLDS = (1, 2, 4)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{n: [rank 0's results, rank 1's, ...]}, loaded on first use; every
    world runs while the tests compute canu_tpu's side."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = {}
    for n in WORLDS:
        d = tmp_path_factory.mktemp(f"world{n}")
        # each rank's output to a file: a rank blocked on a full pipe
        # would stall the collectives of the others
        logs = [open(d / f"rank{r}.log", "w") for r in range(n)]
        procs[n] = (d, [subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "torch_parallel_worker.py"), str(r), str(n),
             f"file://{d}/store", str(d)], env=env, stdout=logs[r],
            stderr=subprocess.STDOUT) for r in range(n)])
        for fh in logs:
            fh.close()  # each rank holds its own copy
    loaded: dict = {}

    def get(n: int) -> list:
        if n not in loaded:
            d, ps = procs[n]
            deadline = time.time() + 300
            for r, p in enumerate(ps):
                try:
                    p.wait(timeout=max(1.0, deadline - time.time()))
                except subprocess.TimeoutExpired:
                    for q in ps:
                        q.kill()
                    pytest.fail(f"world of {n}: a rank timed out")
                assert p.returncode == 0, (d / f"rank{r}.log").read_text()[-3000:]
            loaded[n] = [dict(np.load(d / f"rank{r}.npz")) for r in range(n)]
        return loaded[n]

    yield get
    for _, ps in procs.values():
        for p in ps:
            if p.poll() is None:
                p.kill()
            p.wait()


@pytest.fixture(scope="module")
def jax_sets():
    """canu_tpu's read set and overlaps (the worker's sets, made by canu_tpu)."""
    from canu_tpu.io.overlaps_io import random_overlaps
    from canu_tpu.sim.simulate import random_genome, simulate_reads

    g = random_genome(6_000, seed=9)
    rs, _ = simulate_reads(g, coverage=4, mean_len=900, min_len=500, max_len=1400,
                           error_rate=0.04, seed=10, circular=False)
    return rs, random_overlaps(5000, n_reads=400, seed=9)


def _port_reads():
    from torch_parallel_worker import sets

    return sets()[0]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7])
def test_host_shards_equal_canu_tpu(n):
    from canu_tpu.parallel.launch import all_host_shards as jax_shards

    from canu_tpu_torch.parallel.launch import all_host_shards, host_read_shard

    for n_reads in (0, 1, 10, 1003):
        got = [(s.process_index, s.process_count, s.lo, s.hi, s.n_local)
               for s in all_host_shards(n_reads, n)]
        ref = [(s.process_index, s.process_count, s.lo, s.hi, s.n_local)
               for s in jax_shards(n_reads, n)]
        assert got == ref
    assert host_read_shard(10, n - 1, n).n_local >= 0


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("k", [16, 22])
def test_sharded_count_equals_canu_tpu(worlds, jax_sets, n, k):
    """The count steps' owner shards, histogram and drops, and the whole
    read set's counts, equal canu_tpu's at n shards and the port's
    single-device count; a tiny bin capacity raises in both."""
    from canu_tpu.parallel.mesh import (make_shard_mesh, sharded_kmer_count_step,
                                        sharded_kmer_count_step2)
    from canu_tpu.parallel.shard_overlap import _mesh_rows, sharded_count_readset
    from canu_tpu.utils.bitpack import n_words

    from canu_tpu_torch.ops import kmer as K

    rs, _ = jax_sets
    mesh = make_shard_mesh(n)
    W = 1 << max(0, int(n_words(max(1, rs.max_length)) - 1).bit_length())
    words, lengths, _ = _mesh_rows(rs, mesh, W)
    ranks = worlds(n)
    if k > 16:
        hi, lo, ct, hist, dropped = sharded_kmer_count_step2(mesh, k=k)(words, lengths)
        for r, got in enumerate(ranks):
            np.testing.assert_array_equal(got["step22_hi"], np.asarray(hi)[r])
            np.testing.assert_array_equal(got["step22_lo"], np.asarray(lo)[r])
    else:
        km, ct, hist, dropped = sharded_kmer_count_step(mesh, k=k)(words, lengths)
        for r, got in enumerate(ranks):
            np.testing.assert_array_equal(got["step16_kmers"], np.asarray(km)[r])
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got[f"step{k}_counts"], np.asarray(ct)[r])
        np.testing.assert_array_equal(got[f"step{k}_hist"], np.asarray(hist))
        assert int(got[f"step{k}_dropped"][0]) == int(dropped) == 0
    ref = sharded_count_readset(rs, k=k, mesh=mesh)
    single = K.count_reads(_port_reads(), k=k, block_size=64, device=CPU)
    order = np.argsort(single.unique, kind="stable")
    for got in ranks:
        np.testing.assert_array_equal(got[f"count{k}_unique"], ref.unique)
        np.testing.assert_array_equal(got[f"count{k}_counts"], ref.counts)
        np.testing.assert_array_equal(got[f"count{k}_unique"], single.unique[order])
        np.testing.assert_array_equal(got[f"count{k}_counts"], single.counts[order])
        assert bool(got[f"count{k}_raised"][0])
    with pytest.raises(RuntimeError, match="dropped k-mers"):
        sharded_count_readset(rs, k=k, mesh=mesh, bin_capacity=4)


@pytest.mark.parametrize("n", WORLDS)
def test_ring_candidates_equal_canu_tpu(worlds, jax_sets, n):
    """The ring's candidates equal canu_tpu's ring at n devices on the same
    sketches and the port's block matcher; the sketches equal canu_tpu's."""
    from canu_tpu.ops import kmer as JK
    from canu_tpu.ops import minhash as JMH
    from canu_tpu.parallel.mesh import make_shard_mesh
    from canu_tpu.parallel.shard_overlap import sharded_find_candidates

    from canu_tpu_torch.ops import minhash as MH

    rs, _ = jax_sets
    ranks = worlds(n)
    sk = ranks[0]["sketches"]
    fk = JK.frequent_kmers(JK.count_readset_device(rs, k=16, block_size=64),
                           distinct_fraction=0.9995)
    np.testing.assert_array_equal(
        sk, np.asarray(JMH.build_sketches(rs, k=16, n_hashes=64, frequent=fk, block_size=64)))
    ref = sharded_find_candidates(sk, min_matches=2, mesh=make_shard_mesh(n))
    assert len(ref) > 0
    for got in ranks:
        np.testing.assert_array_equal(got["ring"], ref)
    np.testing.assert_array_equal(
        ranks[0]["ring"], MH.find_candidates(sk, min_matches=2, block_size=64, device=CPU))


@pytest.mark.parametrize("n", WORLDS)
def test_store_sorts_equal_canu_tpu(worlds, jax_sets, n):
    """distributed_store_sort equals canu_tpu's at n devices (and the
    lexsort); the ranks' range-exchanged rows, concatenated, are canu_tpu's
    exchange (its lexsort) of every rank's rows, each rank holding its
    own a_id range."""
    from canu_tpu.parallel.shard_overlap import table_to_sym_rows
    from canu_tpu.parallel.storesort import (distributed_store_sort, make_flat_mesh,
                                             process_range_exchange)

    _, t = jax_sets
    ranks = worlds(n)
    rows = np.stack([t.a_id, t.b_id, t.a_bgn, t.a_end], axis=1).astype(np.int32)
    ref = distributed_store_sort(rows, n_reads=400, mesh=make_flat_mesh(n))
    np.testing.assert_array_equal(ref, rows[np.lexsort((rows[:, 1], rows[:, 0]))])
    for got in ranks:
        np.testing.assert_array_equal(got["sorted"], ref)
    sym = table_to_sym_rows(t)
    cat = np.concatenate([got["exchanged"] for got in ranks])
    np.testing.assert_array_equal(cat, process_range_exchange(sym, 400))
    for r, got in enumerate(ranks):
        dest = ((got["exchanged"][:, 0].astype(np.int64) - 1) * n) // 400
        assert (dest == r).all()


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_verify_equals_canu_tpu(worlds, jax_sets, n):
    """sharded_verify_candidates' raw rows equal canu_tpu's (engine 'xla')
    at n devices, bit for bit."""
    from canu_tpu.parallel.mesh import make_shard_mesh
    from canu_tpu.parallel.shard_overlap import sharded_verify_candidates

    rs, _ = jax_sets
    ranks = worlds(n)
    pairs = ranks[0]["ring"][:24]
    ref = sharded_verify_candidates(rs, pairs, mesh=make_shard_mesh(n), k=16, band=128)
    assert ref.shape == (24, 13)
    for got in ranks:
        np.testing.assert_array_equal(got["verify_rows"], ref)


def _row_set(rows) -> set:
    return {tuple(int(x) for x in r) for r in rows}


@pytest.mark.parametrize("n", WORLDS)
def test_process_sharded_verify_and_store_equal_canu_tpu(worlds, jax_sets, n):
    """process_sharded_verify's table holds canu_tpu's rows on every rank;
    the range-exchanged shards merged by save_from_row_shards give
    canu_tpu's OverlapStore.build of that table, each rank holding fewer
    rows than the whole."""
    from canu_tpu.ops.align import verify_overlaps
    from canu_tpu.stores.overlaps import OverlapStore as JStore

    from canu_tpu_torch.stores.overlaps import store_digest

    rs, _ = jax_sets
    ranks = worlds(n)
    pairs = ranks[0]["ring"]
    tab = verify_overlaps(rs, pairs, k=16, chunk=64)
    assert len(tab) > 0
    ref = _row_set(zip(tab.a_id, tab.b_id, tab.flipped, tab.a_bgn, tab.a_end, tab.b_bgn,
                       tab.b_end, tab.erate_q))
    for got in ranks:
        assert _row_set(got["psv_rows"]) == ref
    assert str(ranks[0]["store_digest"][0]) == store_digest(JStore.build(tab, rs.n_reads))
    if n > 1:
        assert all(len(got["store_rows_mine"]) < 2 * len(tab) for got in ranks)


def test_overlap_step_2x2_equals_canu_tpu(worlds):
    """The 2-D sketch + match step on a world of 4 (2 x 2: rows x hash
    range) gives each rank canu_tpu's counts for its row block."""
    from canu_tpu.parallel.mesh import make_overlap_mesh, sharded_overlap_step

    from torch_parallel_worker import overlap_step_case

    words, lengths, seeds, fk = overlap_step_case()
    mesh = make_overlap_mesh(4)
    assert mesh.shape == {"r": 2, "h": 2}
    ref = np.asarray(sharded_overlap_step(mesh, k=16, min_matches=2)(
        jnp.asarray(words), jnp.asarray(lengths), jnp.asarray(seeds), jnp.asarray(fk)))
    ranks = worlds(4)
    B = len(words) // 2
    assert {tuple(got["overlap_step_coord"]) for got in ranks} == {
        (r, h, 2, 2) for r in range(2) for h in range(2)}
    for got in ranks:
        ri = int(got["overlap_step_coord"][0])
        np.testing.assert_array_equal(got["overlap_step"], ref[ri * B : (ri + 1) * B])
    assert ref.max() > 0


def test_collectives_ran_in_every_world(worlds):
    for n in WORLDS:
        for got in worlds(n):
            assert got["mesh_sizes"].tolist() == [n, n]  # make_flat_mesh, make_shard_mesh
            a2a, gather, ring = (int(x) for x in got["stats_calls"])
            assert a2a > 0 and gather > 0
            assert ring == (n // 2 if n > 1 else 0)


@pytest.mark.parametrize("n", WORLDS)
def test_stage_runner_keeps_ranks_in_step(worlds, n):
    """A rank that reads a writer-only stage's done() after the writer has
    finished still runs the stages in step with the others: the next
    collective stage's all_gather holds every rank's id."""
    for got in worlds(n):
        np.testing.assert_array_equal(got["stage_order"], np.arange(n))


def test_init_distributed_resolves_slurm_then_torchrun(monkeypatch):
    """The launcher precedence of canu_tpu's init_distributed: SLURM's
    variables before torchrun's; a single-process environment joins no
    world."""
    from canu_tpu_torch.parallel import launch

    slurm = {"SLURM_NTASKS": "4", "SLURM_PROCID": "2", "SLURM_LOCALID": "0",
             "SLURM_LAUNCH_NODE_IPADDR": "10.0.0.5"}
    torchrun = {"WORLD_SIZE": "2", "RANK": "1", "LOCAL_RANK": "1", "MASTER_ADDR": "node7",
                "MASTER_PORT": "29511"}
    assert launch.launcher_env(slurm) == ("10.0.0.5:12321", 4, 2, 0)
    assert launch.launcher_env(torchrun) == ("env://", 2, 1, 1)
    assert launch.launcher_env({**torchrun, **slurm}) == ("10.0.0.5:12321", 4, 2, 0)
    assert launch.launcher_env({"SLURM_NTASKS": "1", **torchrun})[1] == 2
    assert launch.launcher_env({"SLURM_NTASKS": "1", "WORLD_SIZE": "1"}) == (None,) * 4
    for key in (*slurm, *torchrun):
        monkeypatch.delenv(key, raising=False)
    assert launch.init_distributed() == (0, 1)
    assert not launch.joined() and launch.is_writer() and not launch.is_distributed()
    launch.barrier("no-op")
