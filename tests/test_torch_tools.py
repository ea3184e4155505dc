"""``python -m canu_tpu_torch.tools`` against ``python -m canu_tpu.tools`` on
the CPU: every one of the 20 subcommands, run in process on the scripted
session of chip_smoke.py's tools phase (tests/torch_cases.py
tools_session) at a 24 kb genome, gives the same exit code, stdout,
stderr and output files (tools_record; the work directory written
<work>).  Exact.

The session's k=22 DB steps (TOOLS_DB22_STEPS) read a DB that kmer-count
saved: canu_tpu's KmerCounts.load casts its exact uint64 k-mers to uint32,
the port's keeps them, so canu_tpu runs those steps with a load that keeps
the saved dtype, its result on the DB it counted.  Tig stores have their
own steps here: tig-dump, tig-display and tig-coverage on a store of
simulated reads' true placements."""

from __future__ import annotations

import os

import numpy as np
import pytest

import canu_tpu.ops.kmer as JK
import canu_tpu.stores.readset as JRS
import canu_tpu.stores.tigs as JT
import canu_tpu_torch.stores.readset as TRS
import canu_tpu_torch.stores.tigs as TT
from canu_tpu.tools.__main__ import main as jmain
from canu_tpu_torch.tools.__main__ import build_parser, main as tmain
from torch_cases import (db22_loaded_as_saved, one_torch_thread,  # noqa: F401
                         run_tools_session, tools_run, tools_session)

GENOME = 24_000
STEPS = [name for name, _ in tools_session("w", GENOME)]


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    """Both packages' records of the whole session, each in its own
    directory."""
    out = {}
    for pkg, main, rs_cls, around, kw in (
            ("jax", jmain, JRS.ReadSet, db22_loaded_as_saved(JK), {}),
            ("torch", tmain, TRS.ReadSet, None, {"device": "cpu"})):
        work = str(tmp_path_factory.mktemp(f"tools_{pkg}"))
        out[pkg] = run_tools_session(work, GENOME, main, rs_cls, around, **kw)[0]
    return out


@pytest.mark.parametrize("step", STEPS)
def test_step_equal(sessions, step):
    assert sessions["torch"][step] == sessions["jax"][step]


def test_session_covers_every_subcommand():
    subs = set(build_parser()._subparsers._group_actions[0].choices)
    used = {argv[0] for _, argv in tools_session("w", GENOME) if argv}
    assert len(subs) == 20
    assert subs - used == {"tig-dump", "tig-display", "tig-coverage"}


def _tig_store(path, T):
    """A tig store (of the tigs module ``T``) of three tigs placed from a
    simulated read set's truth: two contigs and an unassembled tig."""
    from canu_tpu_torch.sim.simulate import random_genome, simulate_reads

    g = random_genome(20_000, seed=61)
    rs, tr = simulate_reads(g, coverage=6, mean_len=2000, min_len=1000, max_len=3000,
                            error_rate=0.02, seed=62, circular=False)
    order = np.argsort(tr.start, kind="stable")
    ts = T.TigStore()
    for tid, sel, cls in ((1, order[: len(order) // 2], T.CLASS_CONTIG),
                          (2, order[len(order) // 2 : -1], T.CLASS_CONTIG),
                          (3, order[-1:], T.CLASS_UNASSEMBLED)):
        b = tr.start[sel].astype(np.int32)
        t = T.Tig(tid, (sel + 1).astype(np.int32), b - b.min(),
                  tr.end[sel].astype(np.int32) - b.min(), tr.strand[sel].astype(bool),
                  tig_class=cls)
        t.consensus = g[b.min() : tr.end[sel].max()]
        ts.add(t)
    ts.save(path, version=1)


@pytest.mark.parametrize("argv", [["sizes"], ["layout", "-o", "OUT"],
                                  ["fasta", "-o", "OUT", "-all"]])
def test_tig_dump_equal(tmp_path, argv):
    got = {}
    for pkg, main, T, kw in (("jax", jmain, JT, {}), ("torch", tmain, TT, {"device": "cpu"})):
        d = tmp_path / pkg
        _tig_store(str(d / "ctg"), T)
        out = str(d / "out.txt")
        rc, text, err = tools_run(main, ["tig-dump", str(d / "ctg")]
                                  + [out if a == "OUT" else a for a in argv], **kw)
        got[pkg] = (rc, text, err, open(out).read() if os.path.exists(out) else None)
    assert got["torch"] == got["jax"]
    assert got["jax"][0] == 0 and (got["jax"][1] or got["jax"][3])


@pytest.mark.parametrize("argv", [["tig-display", "CTG", "2"], ["tig-display", "CTG", "9"],
                                  ["tig-coverage", "CTG"], ["tig-coverage", "CTG", "-all"]])
def test_tig_display_and_coverage_equal(tmp_path, argv):
    got = {}
    for pkg, main, T, kw in (("jax", jmain, JT, {}), ("torch", tmain, TT, {"device": "cpu"})):
        ctg = str(tmp_path / pkg / "ctg")
        _tig_store(ctg, T)
        got[pkg] = tools_run(main, [ctg if a == "CTG" else a for a in argv], **kw)
        got[pkg] = (got[pkg][0], got[pkg][1].replace(ctg, "<ctg>"),
                    got[pkg][2].replace(ctg, "<ctg>"))
    assert got["torch"] == got["jax"]
