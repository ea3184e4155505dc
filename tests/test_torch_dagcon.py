"""The port's tag-chain (dag) consensus against canu_tpu's on the CPU: the
paths of evidence windows (dagcon._paths_many, paths_for_jobs, whatever
the chunk and DP group sizes), the tag extraction, the heaviest-chain DP and
dag_segments; polish_tig(mode="dag") on tests/test_dagcon.py's
two-haplotype pile; correct_reads_blocks(mode="dag") block for block; and
correction_phase with corConsensus=dag and run_pipeline with
cnsConsensus=dag, which run and give what canu_tpu's dag consensus gives
on their own stores.  Exact.

Both packages run at one small geometry (512-base segments, 64 jobs a
chunk, as tests/test_torch_oea_polish.py's); chip_smoke.py's dag phase
holds the real geometry against canu_tpu on the bench correction and an
assembly."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import canu_tpu.ops.consensus as JC
import canu_tpu.ops.dagcon as JD
import canu_tpu.ops.falcon as JF
import canu_tpu.ops.votepile as JV
import canu_tpu.stores.overlaps as JOV
import canu_tpu.stores.readset as JRS
import canu_tpu.stores.tigs as JT
import canu_tpu_torch.ops.consensus as TC
import canu_tpu_torch.ops.dagcon as TD
import canu_tpu_torch.ops.falcon as TF
import canu_tpu_torch.ops.votepile as TV
from canu_tpu_torch.ops.kernels import trace_cuda as TK4
import canu_tpu_torch.stores.readset as TRS
import canu_tpu_torch.stores.tigs as TT
from canu_tpu_torch.io.fastx import write_fasta
from canu_tpu_torch.sim.simulate import mutate_read, random_genome, simulate_reads
from canu_tpu_torch.utils import bitpack
from torch_cases import fasta_records, one_torch_thread  # noqa: F401  (autouse fixture)

SEG = 512
BAND = 256


@pytest.fixture(scope="module", autouse=True)
def small_geometry():
    with pytest.MonkeyPatch.context() as mp:
        for mod in (JF, TF):
            mp.setattr(mod, "VOTE_SEG", SEG)
        for mod in (JC, TC):
            mp.setattr(mod, "_POLISH_SEG", SEG)
        for mod in (JV, TV):
            mp.setattr(mod, "BLOCK_POS_BUDGET", SEG * 16)  # G = 16 segments a block
            mp.setattr(mod, "CHUNK_CELL_BUDGET", SEG * 64)  # 64 jobs a chunk
        yield


def _tiled_pile(genome_a, haps, offsets, step=600, rlen=1500):
    """tests/test_dagcon.py _pile: error-free reads tiled over each
    haplotype, alternating orientation, placed in genome_a coordinates;
    (codes, tig columns)."""
    codes, place = [], []
    for hap, off in zip(haps, offsets):
        s, i = off, 0
        while s + rlen <= len(hap):
            sl = hap[s : s + rlen]
            rev = bool(i % 2)
            codes.append(bitpack.revcomp_codes(sl) if rev else sl.copy())
            place.append((s, s + rlen, rev))
            s += step
            i += 1
    order = np.argsort([p[0] for p in place], kind="stable")
    cols = (np.array([int(i) + 1 for i in order], np.int32),
            np.array([place[i][0] for i in order], np.int32),
            np.array([min(place[i][1], len(genome_a)) for i in order], np.int32),
            np.array([place[i][2] for i in order], bool))
    return codes, cols


@pytest.fixture(scope="module")
def two_haps():
    """tests/test_dagcon.py's haplotypes: hap B carries a 5-base insertion
    at 3000 and SNPs at 2970 and 3040."""
    ga = random_genome(6000, seed=91)
    gb = ga.copy()
    gb[2970] = (gb[2970] + 1) % 4
    gb[3040] = (gb[3040] + 2) % 4
    gb = np.concatenate([gb[:3000], np.array([0, 2, 1, 3, 0], np.uint8), gb[3000:]])
    return ga, gb


@pytest.fixture(scope="module")
def windows():
    """Seeded evidence windows onto 512-base template segments: the
    segments of a 6 kb genome with 2% point errors, the evidence 40 reads
    of the genome at 8-12% error in both orientations, jobs with interior
    and end windows, slack and a zero-span pad; both packages' planes."""
    rng = np.random.default_rng(17)
    g = random_genome(6000, seed=18)
    back = g.copy()
    pos = rng.choice(len(g), size=120, replace=False)
    back[pos] = (back[pos] + 1) % 4
    segs = [back[i : i + SEG] for i in range(0, len(back), SEG)]
    reads, jobs = [], []
    for r in range(40):
        s = int(rng.integers(0, len(g) - 1200))
        n = int(rng.integers(700, 1200))
        flip = bool(r % 2)
        read = mutate_read(g[s : s + n], float(rng.uniform(0.08, 0.12)), rng)
        reads.append(bitpack.revcomp_codes(read) if flip else read)
        for k in range(s // SEG, (s + n - 1) // SEG + 1):
            a, b = max(s, k * SEG), min(s + n, (k + 1) * SEG)
            if b - a < 40:
                continue
            lo = int(round((a - s) * len(read) / n))
            hi = int(round((b - s) * len(read) / n))
            e_lo = max(0, lo - int(rng.integers(0, 60)))
            e_hi = min(len(read), hi + int(rng.integers(0, 60)))
            jobs.append((k, r, a - k * SEG, b - a, e_lo, e_hi - e_lo, flip))
    jobs.append((0, 0, 0, 0, 0, 0, False))
    cols = np.array(jobs, np.int64).T
    vj = dict(t_idx=cols[0].astype(np.int32), e_idx=cols[1].astype(np.int32),
              t_bgn=cols[2].astype(np.int32), t_span=cols[3].astype(np.int32),
              e_lo=cols[4].astype(np.int32), e_span=cols[5].astype(np.int32),
              flipped=cols[6].astype(bool), slot=np.zeros(len(jobs), np.int32))
    trs = TRS.ReadSet.from_codes_list(reads)
    jrs = JRS.ReadSet.from_codes_list(reads)
    tw, tl, _ = TV.segment_codes_plane(segs, SEG, "cpu")
    jw, jl, _ = JV.segment_codes_plane(segs, SEG)
    tew, tel = TV.device_words(trs, "cpu")
    jew, jel = JV.device_words(jrs)
    return {"segs": segs, "jobs": (TV.VoteJobs(**vj), JV.VoteJobs(**vj)),
            "torch": (tw, tl, tew, tel), "jax": (jw, jl, jew, jel)}


def test_paths_many_equal(windows):
    """One chunk of 64 jobs: j_star and the oriented evidence windows."""
    tj, _ = windows["jobs"]
    cols = np.stack([tj.t_idx, tj.e_idx, tj.t_bgn, tj.t_span, tj.e_lo, tj.e_span,
                     tj.flipped.astype(np.int32)]).astype(np.int32)[:, :64]
    got = TD._paths_many(*windows["torch"], torch.from_numpy(cols), BAND, SEG)
    want = JD._paths_many(*windows["jax"], jnp.asarray(cols), BAND, SEG)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.uint8
    assert tuple(got[1].shape) == (64, SEG + max(BAND, SEG // 2))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_paths_for_jobs_equal_whatever_the_chunk_size(windows, monkeypatch):
    tj, jj = windows["jobs"]
    want = JD.paths_for_jobs(*windows["jax"], jj, SEG, BAND)
    assert len(tj) > 64
    for budget in (SEG * 32, SEG * 256):  # 32 and 256 jobs a chunk
        monkeypatch.setattr(TV, "CHUNK_CELL_BUDGET", budget)
        c0 = TD.CHUNKS
        got = TD.paths_for_jobs(*windows["torch"], tj, SEG, BAND)
        assert TD.CHUNKS - c0 == -(-len(tj) // TV.chunk_jobs(SEG))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("per_group", [1, 2])
def test_paths_for_jobs_grouped_equal(windows, per_group, monkeypatch):
    """An odd number of chunks cut into DP groups of per_group chunks (the
    last one smaller): js and e_sub equal canu_tpu's."""
    tj, jj = windows["jobs"]
    want = JD.paths_for_jobs(*windows["jax"], jj, SEG, BAND)
    B = next(b for b in range(32, 64) if -(-len(tj) // b) % 2 == 1 and -(-len(tj) // b) >= 3)
    n_chunks = -(-len(tj) // B)
    monkeypatch.setattr(TV, "CHUNK_CELL_BUDGET", SEG * B)
    monkeypatch.setattr(TV, "GROUP_BYTE_BUDGET",
                        (per_group * B + B - 1) * TK4.scratch_bytes(1, BAND, SEG))
    assert (TV.chunk_jobs(SEG), TV.group_chunks(BAND, SEG, B, torch.device("cpu"))) == (B, per_group)
    c0 = TD.CHUNKS
    calls = []
    real = TD.align_positions_lean
    monkeypatch.setattr(TD, "align_positions_lean",
                        lambda t, *a, **k: calls.append(t.shape[0]) or real(t, *a, **k))
    got = TD.paths_for_jobs(*windows["torch"], tj, SEG, BAND)
    assert TD.CHUNKS - c0 == n_chunks
    assert calls == [min(per_group * B, n_chunks * B - g) for g in range(0, n_chunks * B,
                                                                          per_group * B)]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _tag_sets(windows, mod):
    """Every job's tags by ``mod``'s _job_tags, from canu_tpu's paths."""
    _, jj = windows["jobs"]
    js, es = JD.paths_for_jobs(*windows["jax"], jj, SEG, BAND)
    return [mod._job_tags(int(jj.t_bgn[j]), int(jj.t_span[j]), js[j], es[j], int(jj.e_span[j]))
            for j in range(len(jj))], jj


def test_job_tags_equal(windows):
    got, _ = _tag_sets(windows, TD)
    want, _ = _tag_sets(windows, JD)
    rng = np.random.default_rng(3)
    for _ in range(200):  # random monotone paths: insertions past MAX_DELTA, ends
        t_span = int(rng.integers(0, 40))
        e_span = int(rng.integers(0, 60))
        js = np.sort(rng.integers(0, e_span + 1, t_span + 1)).astype(np.int32)
        if t_span and rng.random() < 0.3:
            js[rng.integers(1, t_span + 1):] += 20
        e_row = rng.integers(0, 4, 80).astype(np.uint8)
        t_bgn = int(rng.integers(0, 5))
        got.append(TD._job_tags(t_bgn, t_span, js, e_row, e_span))
        want.append(JD._job_tags(t_bgn, t_span, js, e_row, e_span))
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("min_cov", [1, 2, 4])
def test_tag_chain_consensus_equal(windows, min_cov):
    """Each segment's heaviest chain from the real pile's tags, and
    from piles of duplicated tags that tie edge for edge."""
    tags, jj = _tag_sets(windows, JD)
    segs = windows["segs"]
    rng = np.random.default_rng(min_cov)
    for si, tmpl in enumerate(segs):
        sets = [tags[j] for j in range(len(jj)) if jj.t_idx[j] == si]
        tie = sets[: 2] * 2 + [sets[-1]] if len(sets) >= 2 else sets
        for ts in (sets, tie, [sets[i] for i in rng.permutation(len(sets))], []):
            got = TD.tag_chain_consensus(tmpl, ts, min_cov=min_cov)
            want = JD.tag_chain_consensus(tmpl, ts, min_cov=min_cov)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
            assert got[2] == want[2]


def test_dag_segments_equal(windows):
    tj, jj = windows["jobs"]
    got = TD.dag_segments(windows["segs"], *windows["torch"], tj, SEG, BAND, 2)
    want = JD.dag_segments(windows["segs"], *windows["jax"], jj, SEG, BAND, 2)
    assert got[1] == want[1] > 0
    assert len(got[0]) == len(want[0]) == len(windows["segs"])
    for g, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("mixed", [False, True])
def test_polish_tig_dag_equal(two_haps, mixed):
    """tests/test_dagcon.py's piles: hap B alone, and hap B ~5x against hap
    A ~3x; one round and up to three."""
    ga, gb = two_haps
    haps, offs = ([gb, gb, ga], [0, 300, 450]) if mixed else ([gb], [0])
    codes, cols = _tiled_pile(ga, haps, offs)
    out = {}
    for pkg, RS, T, C, kw in (("jax", JRS, JT, JC, {}), ("torch", TRS, TT, TC,
                                                       {"device": "cpu"})):
        rs = RS.ReadSet.from_codes_list(codes)
        tig = T.Tig(1, *cols)
        out[pkg] = [np.asarray(C.polish_tig(rs, tig, ga.copy(), band=256, min_cov=2,
                                            rounds=r, mode="dag", **kw)) for r in (1, 3)]
    for g, w in zip(out["torch"], out["jax"]):
        np.testing.assert_array_equal(g, w)
    assert bitpack.codes_to_seq(gb[2700:3300]) in bitpack.codes_to_seq(out["torch"][0])


@pytest.fixture(scope="module")
def raw_fasta(tmp_path_factory):
    """42 reads of a 6 kb genome at 10% error."""
    d = tmp_path_factory.mktemp("dagcor")
    g = random_genome(6000, seed=52)
    rs, _ = simulate_reads(g, coverage=10, mean_len=1500, min_len=1000, max_len=2000,
                           error_rate=0.10, seed=53, circular=False)
    fa = str(d / "reads.fasta")
    write_fasta(fa, ((rs.name(i), rs.get_seq(i)) for i in range(1, rs.n_reads + 1)))
    return fa


def _cfg(**kv):
    from canu_tpu_torch.config import Config

    cfg = Config()
    for k, v in kv.items():
        cfg.set(k, v)
    return cfg


def test_correction_phase_dag_runs_and_equals(raw_fasta, tmp_path):
    """correction_phase with corConsensus=dag runs on the CPU (no raise);
    its blocks equal canu_tpu's correct_reads_blocks(mode="dag") on the
    phase's own gatekeeper and cor stores, block for block, and every
    record is <read>_corrN."""
    from canu_tpu_torch.pipeline import stages
    from canu_tpu_torch.pipeline.driver import make_ctx

    cfg = _cfg(genomeSize=6000, corConsensus="dag", corOutCoverage=4,
               saveReadCorrections="true")
    ctx = make_ctx(str(tmp_path), "t", cfg)
    stages.correction_phase(ctx, [raw_fasta], device="cpu")
    d = tmp_path / "correction"
    got = fasta_records(str(d / "t.correctedReads.fasta.gz"))
    rs = JRS.ReadSet.load(str(d / "t.gkpStore"))
    st = JOV.OverlapStore.load(str(d / "t.ovlStore"))
    want = []
    for bi, items in JF.correct_reads_blocks(
            rs, st, genome_size=6000, out_coverage=4,
            max_evidence_coverage=stages._cor_evidence_budget(ctx, rs),
            min_evidence_length=int(cfg.get("corMinEvidenceLength")),
            band=int(cfg.get("corBandWidth")), min_cov=int(cfg.get("corMinCoverage")),
            qv_weight=bool(cfg.get("qvEvidenceWeight")),
            max_evidence_erate=float(cfg.get("corMaxEvidenceErate")), mode="dag",
            template_filter=str(cfg.get("corFilter"))):
        assert fasta_records(str(d / "blocks" / f"block_{bi:05d}.fasta.gz")) == items
        want += items
    assert got == want and len(got) > 0
    names = {rs.name(i) for i in range(1, rs.n_reads + 1)}
    assert all(n.rsplit("_corr", 1)[0] in names and n.rsplit("_corr", 1)[1].isdigit()
               for n, _ in got)


def test_correct_reads_blocks_dag_equal(raw_fasta):
    """Block for block on canu_tpu's gatekeeper store of the reads with a
    store of their true overlaps; skipping blocks leaves the others
    unchanged."""
    from canu_tpu_torch.stores.overlaps import OverlapStore as TStore
    from canu_tpu_torch.ops.align import OverlapTable

    trs, _ = TRS.ReadSet.from_fastx([raw_fasta])
    jrs, _ = JRS.ReadSet.from_fastx([raw_fasta])
    # overlaps from the names' genome coordinates (simN_start_end_strand)
    meta = [n.split("_") for n in trs.names]
    s = np.array([int(m[1]) for m in meta])
    e = np.array([int(m[2]) for m in meta])
    rev = np.array([m[3] == "-" for m in meta])
    rows = []
    for a in range(len(meta)):
        for b in range(len(meta)):
            lo, hi = max(s[a], s[b]), min(e[a], e[b])
            if a == b or hi - lo < 500:
                continue
            la, lb = int(trs.length[a]), int(trs.length[b])
            ab = (lo - s[a]) * la // (e[a] - s[a])
            ae = (hi - s[a]) * la // (e[a] - s[a])
            bb = (lo - s[b]) * lb // (e[b] - s[b])
            be = (hi - s[b]) * lb // (e[b] - s[b])
            if rev[a]:
                ab, ae = la - ae, la - ab
            if rev[b]:
                bb, be = lb - be, lb - bb
            rows.append((a + 1, b + 1, bool(rev[a] != rev[b]), ab, ae, bb, be, 1000 + a % 7))
    c = list(zip(*rows))
    tab = OverlapTable(a_id=np.array(c[0], np.int32), b_id=np.array(c[1], np.int32),
                       flipped=np.array(c[2], bool), a_bgn=np.array(c[3], np.int32),
                       a_end=np.array(c[4], np.int32), b_bgn=np.array(c[5], np.int32),
                       b_end=np.array(c[6], np.int32), erate_q=np.array(c[7], np.uint16))
    tst = TStore.build(tab, trs.n_reads)
    jst = JOV.OverlapStore(trs.n_reads, **{k: np.asarray(getattr(tst, k)) for k in
                                           ("a_id", "b_id", "flipped", "a_bgn", "a_end",
                                            "b_bgn", "b_end", "erate_q")})
    kw = dict(genome_size=6000, out_coverage=6, max_evidence_coverage=10, band=256,
              min_piece=500, mode="dag")
    want = list(JF.correct_reads_blocks(jrs, jst, **kw))
    got = list(TF.correct_reads_blocks(trs, tst, device="cpu", **kw))
    assert len(want) >= 2 and sum(len(i) for _, i in want) > 0
    assert got == want
    skip = {want[0][0]}
    assert list(TF.correct_reads_blocks(trs, tst, device="cpu", done_blocks=skip, **kw)) == \
        want[1:]


def test_assembly_dag_runs_and_equals(tmp_path):
    """run_pipeline from corrected reads with cnsConsensus=dag runs on the
    CPU (no raise); each contig's consensus equals canu_tpu's dag polish of
    the same tig on the phase's own read store."""
    from canu_tpu_torch.pipeline.driver import run_pipeline

    g = random_genome(10_000, seed=5)
    rs, _ = simulate_reads(g, seed=6, circular=False, coverage=10, mean_len=1500,
                           min_len=1000, max_len=2500, error_rate=0.015)
    fa = str(tmp_path / "reads.fasta")
    write_fasta(fa, ((rs.name(i), rs.get_seq(i)) for i in range(1, rs.n_reads + 1)))
    cfg = _cfg(genomeSize=10_000, enableOEA="false", cnsConsensus="dag",
               obtMhapSensitivity="low", utgMhapSensitivity="low")
    wd = tmp_path / "asm"
    run_pipeline(str(wd), "asm", cfg, corrected_reads=[fa], device="cpu")
    assert (wd / "asm.contigs.fasta").exists()
    d = wd / "unitigging"
    urs = JRS.ReadSet.load(str(d / "asm.gkpStore"))
    v1 = JT.TigStore.load(str(d / "asm.ctgStore"), version=1)
    v2 = TT.TigStore.load(str(d / "asm.ctgStore"), version=2)
    n_polished = 0
    for t1, t2 in zip(v1, v2):
        backbone = JC.quick_mosaic(urs, t1)
        if t1.tig_class == JT.CLASS_CONTIG and t1.n_reads >= 2:
            backbone = JC.polish_tig(urs, t1, backbone, band=int(cfg.get("utgBandWidth")) * 2,
                                     min_cov=int(cfg.get("cnsMinCoverage")),
                                     rounds=int(cfg.get("cnsPolishRounds")),
                                     max_coverage=int(cfg.get("cnsMaxCoverage")), mode="dag")
            n_polished += 1
        np.testing.assert_array_equal(t2.consensus, np.asarray(backbone))
    assert n_polished >= 1
