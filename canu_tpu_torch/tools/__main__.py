"""Dispatcher of the ancillary tools: see the package docstring."""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


# ---- simulate (fastqSimulate) ------------------------------------------------


def cmd_simulate(args: argparse.Namespace) -> int:
    from ..io.fastx import write_fasta
    from ..sim.simulate import random_genome, simulate_reads
    from ..utils.bitpack import codes_to_seq

    repeat_spec = None
    if args.repeat:
        repeat_spec = [tuple(map(int, r.split("x"))) for r in args.repeat]
    g = random_genome(args.genome_size, seed=args.seed, repeat_spec=repeat_spec)
    rs, truth = simulate_reads(
        g, coverage=args.coverage, mean_len=args.mean_len,
        min_len=args.min_len, error_rate=args.error_rate,
        seed=args.seed + 1, circular=args.circular,
    )
    write_fasta(args.out, ((rs.name(i), rs.get_seq(i)) for i in range(1, rs.n_reads + 1)))
    if args.genome_out:
        write_fasta(args.genome_out, [("genome", codes_to_seq(g))])
    if args.truth_out:
        with open(args.truth_out, "w") as fh:
            fh.write("#read_id\tstart\tend\tstrand\n")
            for i in range(rs.n_reads):
                fh.write(
                    f"{i+1}\t{truth.start[i]}\t{truth.end[i]}\t"
                    f"{'-' if truth.strand[i] else '+'}\n"
                )
    print(f"wrote {rs.n_reads} reads ({rs.total_bases} bases) to {args.out}")
    return 0


# ---- sample (fastqSample) ----------------------------------------------------


def cmd_sample(args: argparse.Namespace) -> int:
    from ..io.fastx import read_fastx, write_fasta

    recs = list(read_fastx(args.input))
    total = sum(len(r.seq) for r in recs)
    rng = np.random.default_rng(args.seed)
    if args.coverage is not None:
        if not args.genome_size:
            print("sample: -coverage requires -genomesize", file=sys.stderr)
            return 2
        want = int(args.coverage * args.genome_size)
    else:
        want = int(total * args.fraction)
    if args.longest:
        order = np.argsort([-len(r.seq) for r in recs], kind="stable")
    else:
        order = rng.permutation(len(recs))
    out, acc = [], 0
    for i in order:
        if acc >= want:
            break
        out.append((recs[i].name, recs[i].seq))
        acc += len(recs[i].seq)
    write_fasta(args.out, out)
    print(f"sampled {len(out)}/{len(recs)} reads, {acc}/{total} bases -> {args.out}")
    return 0


# ---- analyze (fastqAnalyze) --------------------------------------------------


def cmd_analyze(args: argparse.Namespace) -> int:
    from ..io.fastx import read_fastx

    lens, gc, n = [], 0, 0
    for r in read_fastx(args.input):
        lens.append(len(r.seq))
        s = r.seq.upper()
        gc += s.count("G") + s.count("C")
        n += s.count("N")
    if not lens:
        print("no reads")
        return 1
    la = np.sort(np.array(lens))[::-1]
    tot = int(la.sum())
    c = np.cumsum(la)
    n50 = int(la[np.searchsorted(c, tot / 2)])
    out = {
        "reads": len(la),
        "bases": tot,
        "min": int(la[-1]),
        "max": int(la[0]),
        "mean": round(tot / len(la), 1),
        "n50": n50,
        "gc": round(gc / max(1, tot - n), 4),
        "n_bases": n,
    }
    print(json.dumps(out))
    return 0


# ---- dump-reads / dump-meta (gatekeeperDump*) --------------------------------


def cmd_dump_reads(args: argparse.Namespace) -> int:
    from ..io.fastx import write_fasta
    from ..stores.readset import ReadSet

    rs = ReadSet.load(args.store)
    lo = args.begin or 1
    hi = min(args.end or rs.n_reads, rs.n_reads)
    write_fasta(
        args.out, ((rs.name(i), rs.get_seq(i)) for i in range(lo, hi + 1))
    )
    print(f"dumped reads {lo}..{hi} -> {args.out}")
    return 0


def cmd_dump_meta(args: argparse.Namespace) -> int:
    from ..stores.readset import ReadSet

    rs = ReadSet.load(args.store)
    hist = rs.length_histogram(args.bin)
    out = {
        "reads": rs.n_reads,
        "bases": rs.total_bases,
        "max_length": rs.max_length,
        "mean_length": round(rs.total_bases / max(1, rs.n_reads), 1),
        f"length_histogram_per_{args.bin}": hist.tolist(),
    }
    print(json.dumps(out))
    return 0


# ---- ov-stats / ov-dump / ov-import (ovStore*) --------------------------------


def cmd_ov_stats(args: argparse.Namespace) -> int:
    from ..stores.overlaps import OverlapStore

    st = OverlapStore.load(args.store)
    per = st.n_overlaps_per_read()
    eh = st.erate_histogram(bins=50, max_erate=0.5)
    out = {
        "overlaps": st.n_overlaps,
        "reads": len(per),
        "reads_with_overlaps": int((per > 0).sum()),
        "overlaps_per_read": {
            "median": float(np.median(per)),
            "mean": round(float(per.mean()), 2),
            "max": int(per.max()) if len(per) else 0,
        },
        "erate": {
            "median": round(float(np.median(st.erate)), 4) if st.n_overlaps else 0,
            "histogram_1pct_bins": eh.tolist(),
        },
    }
    print(json.dumps(out))
    return 0


def cmd_ov_dump(args: argparse.Namespace) -> int:
    from ..io.overlaps_io import write_table_text
    from ..ops.align import OverlapTable
    from ..stores.overlaps import OverlapStore

    st = OverlapStore.load(args.store)
    # store rows are symmetric (each overlap stored A->B and B->A,
    # ovStore convention); dump each once
    m = st.a_id < st.b_id
    t = OverlapTable(
        a_id=st.a_id[m], b_id=st.b_id[m], flipped=st.flipped[m],
        a_bgn=st.a_bgn[m], a_end=st.a_end[m],
        b_bgn=st.b_bgn[m], b_end=st.b_end[m], erate_q=st.erate_q[m],
    )
    n = write_table_text(args.out, t)
    print(f"dumped {n} overlaps -> {args.out}")
    return 0


def cmd_ov_import(args: argparse.Namespace) -> int:
    from ..io.overlaps_io import paf_to_table, random_overlaps, read_table_text
    from ..stores.overlaps import OverlapStore

    if args.random:
        t = random_overlaps(args.random, n_reads=args.nreads, seed=args.seed)
        n_reads = args.nreads
    elif args.paf:
        from ..io.overlaps_io import name_index
        from ..stores.readset import ReadSet

        rs = ReadSet.load(args.readstore)
        t = paf_to_table(args.paf, name_index(rs))
        n_reads = rs.n_reads
    else:
        t = read_table_text(args.input)
        n_reads = args.nreads or (int(max(t.a_id.max(), t.b_id.max())) if len(t) else 0)
    st = OverlapStore.build(t, n_reads)
    st.save(args.store)
    print(f"imported {st.n_overlaps} overlaps -> {args.store}")
    return 0


# ---- kmer-count (meryl) ------------------------------------------------------


def cmd_kmer_count(args: argparse.Namespace) -> int:
    from ..ops import kmer as K
    from ..stores.readset import ReadSet

    rs, _ = ReadSet.from_fastx([args.input])
    kc = K.count_readset_device(rs, k=args.k, block_size=256, device=args.device)
    hist = kc.histogram(args.max_count).copy()
    hist[0] = 0  # device histogram bin 0 counts padding slots
    out = {
        "k": args.k,
        "distinct": int(hist[1:].sum()),
        "total": int((np.arange(len(hist)) * hist).sum()),
        "histogram": hist.tolist(),
    }
    if args.threshold_fraction:
        fk = K.frequent_kmers(kc, distinct_fraction=args.threshold_fraction)
        out["frequent_threshold"] = int(fk.threshold)
        out["frequent_mers"] = int(fk.n)
    if args.db_out:
        # count_readset_device returns a host KmerCounts (no to_host) above
        # the device's instance budget
        kh = kc.to_host() if hasattr(kc, "to_host") else kc
        kh.save(args.db_out)
        out["db"] = args.db_out
    print(json.dumps(out))
    return 0


def cmd_kmer_op(args: argparse.Namespace) -> int:
    """meryl DB algebra over saved databases (meryl-binaryOp.C /
    meryl-unaryOp.C op table: add/sub/min/max/and/or + count filters)."""
    from ..ops.kmer import KmerCounts

    a = KmerCounts.load(args.a)
    if args.op in ("at-least", "at-most"):
        if args.n is None:
            print("kmer-op: -n required for count filters", file=sys.stderr)
            return 1
        r = a.at_least(args.n) if args.op == "at-least" else a.at_most(args.n)
    else:
        if not args.b:
            print(f"kmer-op: {args.op} needs a second DB", file=sys.stderr)
            return 1
        b = KmerCounts.load(args.b)
        r = {
            "add": a.union_sum, "union-min": a.union_min,
            "union-max": a.union_max, "intersect-min": a.intersect_min,
            "intersect-max": a.intersect_max, "intersect-sum": a.intersect_sum,
            "subtract": a.subtract, "difference": a.difference,
        }[args.op](b)
    r.save(args.out)
    print(json.dumps({"op": args.op, "distinct": r.n_distinct,
                      "total": r.n_total, "db": args.out}))
    return 0


# ---- mapMers / maskMers / merTrim / mercy (ancillary k-mer tools) -----------


def _load_seqs_and_db(args):
    from ..ops.kmer import KmerCounts
    from ..stores.readset import ReadSet

    rs, _ = ReadSet.from_fastx([args.fasta], min_read_length=0)
    db = KmerCounts.load(args.db)
    return rs, rs.names, db


def cmd_map_mers(args: argparse.Namespace) -> int:
    """mapMers: map a saved k-mer DB onto sequences (mapMers.C ops)."""
    from ..ops import mermap as MM

    rs, names, db = _load_seqs_and_db(args)
    hi = args.hi if args.hi is not None else 2**62
    if args.mode == "stats":
        for st in MM.map_mers_stats(rs, db, lo=args.lo, hi=hi):
            nm = names[st.read_id - 1] if names else f"seq{st.read_id}"
            print(f"{nm}\t{st.length}\t{st.n_mers}\t{st.n_hits}\t"
                  f"{st.bases_covered}")
    else:  # regions
        canon, valid = MM.positional_kmers(rs, db.k)
        cnt = MM.db_counts_at(canon, db)
        hit = valid & (cnt >= args.lo) & (cnt <= hi)
        for r, iv in enumerate(MM.covered_intervals(rs, hit, db.k)):
            nm = names[r] if names else f"seq{r+1}"
            for b, e in iv:
                print(f"{nm}\t{b}\t{e}")
    return 0


def cmd_mask_mers(args: argparse.Namespace) -> int:
    """maskMers: write the FASTA with DB-covered bases masked to N."""
    from ..io.fastx import write_fasta
    from ..ops import mermap as MM
    from ..utils.bitpack import codes_to_seq

    rs, names, db = _load_seqs_and_db(args)
    canon, valid = MM.positional_kmers(rs, db.k)
    cnt = MM.db_counts_at(canon, db)
    hi = args.hi if args.hi is not None else 2**62
    hit = valid & (cnt >= args.lo) & (cnt <= hi)
    ivs = MM.covered_intervals(rs, hit, db.k)

    def seqs():
        for r in range(rs.n_reads):
            s = np.frombuffer(
                codes_to_seq(rs.get_codes(r + 1)).encode(), np.uint8
            ).copy()
            for b, e in ivs[r]:
                s[int(b):int(e)] = ord("N")
            yield (names[r] if names else f"seq{r+1}"), s.tobytes().decode()

    write_fasta(args.out, seqs())
    n_masked = sum(int((iv[:, 1] - iv[:, 0]).sum()) for iv in ivs)
    print(json.dumps({"sequences": rs.n_reads, "bases_masked": n_masked,
                      "out": args.out}))
    return 0


def cmd_mer_trim(args: argparse.Namespace) -> int:
    """merTrim: per-read clear range from trusted-k-mer coverage."""
    from ..ops import mermap as MM
    from ..ops.kmer import KmerCounts
    from ..stores.readset import ReadSet

    rs, _ = ReadSet.from_fastx([args.fasta], min_read_length=0)
    names = rs.names
    if args.db:
        db = KmerCounts.load(args.db)
    else:
        from ..ops.kmer import count_readset_host

        db = count_readset_host(rs, args.k)
    clear = MM.mer_trim(rs, db, threshold=args.threshold,
                        min_length=args.min_length)
    kept = 0
    for r in range(rs.n_reads):
        nm = names[r] if names else f"read{r+1}"
        b, e = int(clear[r, 0]), int(clear[r, 1])
        print(f"{nm}\t{rs.length[r]}\t{b}\t{e}")
        kept += e - b
    print(f"# kept {kept} of {int(rs.total_bases)} bases "
          f"({kept/max(1,int(rs.total_bases)):.1%})", file=sys.stderr)
    return 0


def cmd_mercy(args: argparse.Namespace) -> int:
    """mercy: read-mer vs assembly-mer QC report."""
    from ..ops import mermap as MM
    from ..ops.kmer import count_readset_host
    from ..stores.readset import ReadSet

    reads, _ = ReadSet.from_fastx([args.reads], min_read_length=0)
    asm, _ = ReadSet.from_fastx([args.assembly], min_read_length=0)
    rdb = count_readset_host(reads, args.k)
    adb = count_readset_host(asm, args.k)
    rep = MM.mercy(rdb, adb, low_count=args.low_count)
    print(rep.summary())
    print(json.dumps({"k": rep.k, "classes": rep.classes,
                      "missing_normal": rep.missing_normal}))
    return 0


# ---- tig-dump / tig-display (tgStoreDump, tgTigDisplay) ----------------------


def cmd_tig_dump(args: argparse.Namespace) -> int:
    from ..io.fastx import write_fasta
    from ..stores.tigs import CLASS_CONTIG, TigStore
    from ..utils.bitpack import codes_to_seq

    ver = args.version or TigStore.latest_version(args.store)
    ts = TigStore.load(args.store, version=ver)
    if args.what == "fasta":
        recs = [
            (f"tig{t.tig_id:08d} len={t.length} reads={t.n_reads}",
             codes_to_seq(t.consensus))
            for t in ts
            if t.consensus is not None and (args.all or t.tig_class == CLASS_CONTIG)
        ]
        write_fasta(args.out or "/dev/stdout", recs)
    elif args.what == "layout":
        fh = open(args.out, "w") if args.out else sys.stdout
        for t in ts:
            for i in range(t.n_reads):
                fh.write(
                    f"tig{t.tig_id:08d}\t{int(t.read_id[i])}\t{int(t.bgn[i])}\t"
                    f"{int(t.end[i])}\t{'-' if t.rev[i] else '+'}\n"
                )
        if args.out:
            fh.close()
    elif args.what == "sizes":
        lens = sorted((t.length for t in ts if t.tig_class == CLASS_CONTIG), reverse=True)
        print(json.dumps({
            "tigs": len(ts), "contigs": len(lens), "total": sum(lens),
            "n50": ts.n50(), "largest": lens[0] if lens else 0,
        }))
    return 0


def cmd_tig_display(args: argparse.Namespace) -> int:
    from ..stores.tigs import TigStore

    ver = args.version or TigStore.latest_version(args.store)
    ts = TigStore.load(args.store, version=ver)
    for t in ts:
        if t.tig_id != args.tig:
            continue
        print(f"tig {t.tig_id}: class={t.tig_class} len={t.length} "
              f"reads={t.n_reads} cov={t.coverage():.1f}")
        for i in range(t.n_reads):
            b, e = int(t.bgn[i]), int(t.end[i])
            print(f"  read {int(t.read_id[i]):>8} {b:>9}-{e:<9} "
                  f"{'<--' if t.rev[i] else '-->'}")
        return 0
    print(f"tig {args.tig} not found", file=sys.stderr)
    return 1


# ---- tig-coverage (tgStoreCoverageStat) --------------------------------------


def cmd_tig_coverage(args: argparse.Namespace) -> int:
    """Per-tig coverage statistics + Myers A-stat (the reference's
    tgStoreCoverageStat, invoked at Consensus.pm:540: depth profile from
    read placements, and the arrival-rate statistic that separates
    unique tigs from collapsed repeats)."""
    import numpy as np

    from ..stores.tigs import CLASS_CONTIG, TigStore

    ver = args.version or TigStore.latest_version(args.store)
    ts = TigStore.load(args.store, version=ver)
    contigs = [t for t in ts if args.all or t.tig_class == CLASS_CONTIG]
    total_reads = sum(t.n_reads for t in contigs)
    total_span = sum(t.length for t in contigs) or 1
    arrival = total_reads / total_span  # global read arrival rate
    rows = []
    for t in contigs:
        L = max(t.length, 1)
        depth = np.zeros(L + 1, np.int64)
        for i in range(t.n_reads):
            depth[int(t.bgn[i]) : int(t.end[i])] += 1
        d = depth[:L]
        # A-stat: log-odds unique vs 2-copy collapsed repeat given the
        # observed read count at the global arrival rate
        astat = arrival * L - t.n_reads * float(np.log(2.0))
        rows.append({
            "tig": t.tig_id,
            "len": t.length,
            "reads": t.n_reads,
            "cov_mean": round(float(d.mean()), 2),
            "cov_median": int(np.median(d)),
            "frac_below3": round(float(np.mean(d < 3)), 4),
            "astat": round(astat, 1),
            "repeat_suspect": bool(astat < float(args.astat_cutoff)),
        })
    print(json.dumps({"arrival_rate": round(arrival, 6), "tigs": rows},
                     indent=None))
    return 0


# ---- best-edges (bogart-analysis role) ---------------------------------------


def cmd_best_edges(args: argparse.Namespace) -> int:
    """Dump per-read best edges + hygiene flags from the best-overlap
    graph (the reference's bogart-analysis scripts, e.g.
    show-false-best-edges-from-mapping.pl, need exactly this table)."""
    from ..graph.best_overlap import BestOverlapGraph
    from ..stores.overlaps import OverlapStore
    from ..stores.readset import ReadSet

    st = OverlapStore.load(args.ovlstore)
    rs = ReadSet.load(args.gkpstore)
    bog = BestOverlapGraph(
        st, rs.length, max_erate=args.max_erate, deviation=args.deviation
    )
    n_susp = int(bog.suspicious.sum())
    n_spur = int(bog.spur.sum())
    n_single = int(bog.singleton.sum())
    fh = open(args.out, "w") if args.out else sys.stdout
    fh.write("#read\tflags\tbest5_to\tbest3_to\tcontained_in\n")
    for r in range(1, st.n_reads + 1):
        flags = []
        if bog.suspicious[r]:
            flags.append("suspicious")
        if bog.spur[r]:
            flags.append("spur")
        if bog.singleton[r]:
            flags.append("singleton")
        fh.write(
            f"{r}\t{','.join(flags) or '-'}\t{int(bog.best.b_id[r, 0])}\t"
            f"{int(bog.best.b_id[r, 1])}\t{int(bog.best.contained_in[r])}\n"
        )
    if args.out:
        fh.close()
    print(json.dumps({
        "reads": st.n_reads, "suspicious": n_susp, "spur": n_spur,
        "singleton": n_single, "error_limit": round(float(bog.error_limit), 4),
    }), file=sys.stderr)
    return 0


# ---- bogus (assembly-vs-truth) -----------------------------------------------


def cmd_bogus(args: argparse.Namespace) -> int:
    from ..io.fastx import read_fastx
    from ..sim.bogus import classify_genome, evaluate_assembly
    from ..utils.bitpack import seq_to_codes

    genome = seq_to_codes(next(iter(read_fastx(args.genome))).seq)
    contigs = [r.seq for r in read_fastx(args.assembly)]
    ev = evaluate_assembly(genome, contigs, k=args.k, circular=args.circular,
                           device=args.device)
    print(ev.summary())
    if args.intervals:
        rept, uniq = classify_genome(genome, k=args.k)
        print(f"REPT intervals: {rept.tolist()}")
        print(f"UNIQ intervals: {len(uniq)} covering "
              f"{int((uniq[:,1]-uniq[:,0]).sum())} bases")
    if args.verbose:
        for p in ev.placements:
            print(f"  contig {p.contig}: c[{p.c_bgn}:{p.c_end}] -> "
                  f"g[{p.g_bgn}:{p.g_end}] {'-' if p.reverse else '+'} "
                  f"anchors={p.n_anchors} identity={p.identity:.4f}")
    return 0 if ev.n_misjoins == 0 else 1


def cmd_options(args: argparse.Namespace) -> int:
    """Parameter registry dump (-options, Defaults.pm:327-348), plus the
    markdown table docs/parameter-reference.md is generated from."""
    from ..config.registry import Config

    c = Config()
    if not args.markdown:
        print(c.print_options())
        return 0
    print("| Parameter | Default | Synopsis |")
    print("|---|---|---|")
    for lk in sorted(c.registry):
        p = c.registry[lk]
        print(f"| `{p.key}` | `{c.values[lk]!r}` | {p.synopsis} |")
    return 0


# ---- dispatcher ---------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="canu_tpu_torch.tools")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("simulate", help="generate a sim genome + noisy reads")
    s.add_argument("-genomesize", dest="genome_size", type=int, required=True)
    s.add_argument("-coverage", type=float, default=25.0)
    s.add_argument("-meanlen", dest="mean_len", type=int, default=8000)
    s.add_argument("-minlen", dest="min_len", type=int, default=1000)
    s.add_argument("-error", dest="error_rate", type=float, default=0.1)
    s.add_argument("-seed", type=int, default=1)
    s.add_argument("-circular", action="store_true")
    s.add_argument("-repeat", action="append",
                   help="LENxCOPIES planted repeat (repeatable)")
    s.add_argument("-o", dest="out", required=True)
    s.add_argument("-genome-out", dest="genome_out")
    s.add_argument("-truth-out", dest="truth_out")
    s.set_defaults(fn=cmd_simulate)

    s = sub.add_parser("sample", help="subsample reads to coverage/fraction")
    s.add_argument("input")
    s.add_argument("-o", dest="out", required=True)
    s.add_argument("-coverage", type=float)
    s.add_argument("-genomesize", dest="genome_size", type=int)
    s.add_argument("-fraction", type=float, default=0.5)
    s.add_argument("-longest", action="store_true")
    s.add_argument("-seed", type=int, default=1)
    s.set_defaults(fn=cmd_sample)

    s = sub.add_parser("analyze", help="read stats (JSON)")
    s.add_argument("input")
    s.set_defaults(fn=cmd_analyze)

    s = sub.add_parser("dump-reads", help="ReadSet store -> FASTA")
    s.add_argument("store")
    s.add_argument("-o", dest="out", required=True)
    s.add_argument("-b", dest="begin", type=int)
    s.add_argument("-e", dest="end", type=int)
    s.set_defaults(fn=cmd_dump_reads)

    s = sub.add_parser("dump-meta", help="ReadSet store stats (JSON)")
    s.add_argument("store")
    s.add_argument("-bin", type=int, default=1000)
    s.set_defaults(fn=cmd_dump_meta)

    s = sub.add_parser("ov-stats", help="overlap store stats (JSON)")
    s.add_argument("store")
    s.set_defaults(fn=cmd_ov_stats)

    s = sub.add_parser("ov-dump", help="overlap store -> text")
    s.add_argument("store")
    s.add_argument("-o", dest="out", required=True)
    s.set_defaults(fn=cmd_ov_dump)

    s = sub.add_parser("ov-import", help="text/PAF/random -> overlap store")
    s.add_argument("-i", dest="input")
    s.add_argument("-paf")
    s.add_argument("-readstore")
    s.add_argument("-random", type=int)
    s.add_argument("-nreads", type=int, default=0)
    s.add_argument("-seed", type=int, default=1)
    s.add_argument("-o", dest="store", required=True)
    s.set_defaults(fn=cmd_ov_import)

    s = sub.add_parser("kmer-count", help="k-mer histogram + threshold (JSON)")
    s.add_argument("input")
    s.add_argument("-k", type=int, default=16)
    s.add_argument("-maxcount", dest="max_count", type=int, default=1000)
    s.add_argument("-threshold-fraction", dest="threshold_fraction", type=float)
    s.add_argument("-o", dest="db_out", help="save counted DB (.npz)")
    s.set_defaults(fn=cmd_kmer_count)

    s = sub.add_parser("kmer-op", help="meryl DB algebra on saved DBs")
    s.add_argument("op", choices=["add", "union-min", "union-max",
                                  "intersect-min", "intersect-max",
                                  "intersect-sum", "subtract", "difference",
                                  "at-least", "at-most"])
    s.add_argument("a")
    s.add_argument("b", nargs="?")
    s.add_argument("-n", type=int, help="threshold for count filters")
    s.add_argument("-o", dest="out", required=True)
    s.set_defaults(fn=cmd_kmer_op)

    s = sub.add_parser("map-mers", help="map a k-mer DB onto sequences "
                       "(mapMers -stats/-regions)")
    s.add_argument("--db", required=True)
    s.add_argument("--fasta", required=True)
    s.add_argument("--mode", choices=("stats", "regions"), default="stats")
    s.add_argument("--lo", type=int, default=1)
    s.add_argument("--hi", type=int, default=None)
    s.set_defaults(fn=cmd_map_mers)

    s = sub.add_parser("mask-mers", help="mask DB-covered bases to N "
                       "(maskMers)")
    s.add_argument("--db", required=True)
    s.add_argument("--fasta", required=True)
    s.add_argument("--out", required=True)
    s.add_argument("--lo", type=int, default=1)
    s.add_argument("--hi", type=int, default=None)
    s.set_defaults(fn=cmd_mask_mers)

    s = sub.add_parser("mer-trim", help="clear ranges from trusted-mer "
                       "coverage (merTrim; trim only)")
    s.add_argument("--fasta", required=True)
    s.add_argument("--db", default=None,
                   help="saved DB (default: count the input at -k)")
    s.add_argument("-k", type=int, default=22)
    s.add_argument("--threshold", type=int, default=2)
    s.add_argument("--min-length", type=int, default=64)
    s.set_defaults(fn=cmd_mer_trim)

    s = sub.add_parser("mercy", help="read-mer vs assembly-mer QC (mercy)")
    s.add_argument("--reads", required=True)
    s.add_argument("--assembly", required=True)
    s.add_argument("-k", type=int, default=22)
    s.add_argument("--low-count", type=int, default=3)
    s.set_defaults(fn=cmd_mercy)

    s = sub.add_parser("tig-dump", help="tig store -> fasta/layout/sizes")
    s.add_argument("store")
    s.add_argument("what", choices=["fasta", "layout", "sizes"])
    s.add_argument("-o", dest="out")
    s.add_argument("-version", type=int)
    s.add_argument("-all", action="store_true", help="include unassembled")
    s.set_defaults(fn=cmd_tig_dump)

    s = sub.add_parser("tig-display", help="print one tig layout")
    s.add_argument("store")
    s.add_argument("tig", type=int)
    s.add_argument("-version", type=int)
    s.set_defaults(fn=cmd_tig_display)

    s = sub.add_parser("tig-coverage",
                       help="per-tig coverage stats + A-stat (tgStoreCoverageStat)")
    s.add_argument("store")
    s.add_argument("-version", type=int)
    s.add_argument("-all", action="store_true", help="include unassembled")
    s.add_argument("-astat-cutoff", dest="astat_cutoff", type=float,
                   default=-5.0, help="A-stat below this marks a repeat suspect")
    s.set_defaults(fn=cmd_tig_coverage)

    s = sub.add_parser("best-edges",
                       help="best-overlap-graph edge/flag dump (bogart-analysis)")
    s.add_argument("ovlstore")
    s.add_argument("gkpstore")
    s.add_argument("-o", dest="out")
    s.add_argument("-max-erate", dest="max_erate", type=float, default=0.12)
    s.add_argument("-deviation", type=float, default=6.0)
    s.set_defaults(fn=cmd_best_edges)

    s = sub.add_parser("options", help="print the parameter registry")
    s.add_argument("-markdown", action="store_true",
                   help="emit the docs/parameter-reference.md table")
    s.set_defaults(fn=cmd_options)

    s = sub.add_parser("bogus", help="evaluate assembly vs truth genome")
    s.add_argument("-genome", required=True)
    s.add_argument("-assembly", required=True)
    s.add_argument("-k", type=int, default=21)
    s.add_argument("-circular", action="store_true")
    s.add_argument("-intervals", action="store_true")
    s.add_argument("-verbose", action="store_true")
    s.set_defaults(fn=cmd_bogus)

    return p


def main(argv: list[str], device=None) -> int:
    """Run one tool; its device work (kmer-count, bogus) runs on ``device``,
    the card unless the caller asks for the CPU."""
    args = build_parser().parse_args(argv)
    args.device = device
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
