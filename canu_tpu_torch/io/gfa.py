"""GFA v1 assembly graph output (counterpart of canu_tpu.io.gfa, the
bogart TigGraph / alignGFA equivalent).

The reference emits unitigs.gfa/contigs.gfa from the tig end-to-end
overlap graph (Canu src/bogart/AS_BAT_TigGraph.C) and later
recomputes edge overlaps against consensus sequences
(Canu src/gfa/alignGFA.C).  Here edges come from verified
overlaps between tig END reads: if the terminal read of tig X dovetails
to a terminal read of tig Y, the tigs are linked with the overlap length
as a <n>M CIGAR.  align_links re-aligns each link between the consensus
sequences with the Myers banded extension on ``device`` (kernel K1 on
CUDA tensors).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..stores.overlaps import OverlapStore
from ..stores.readset import ReadSet
from ..stores.tigs import CLASS_CONTIG, TigStore
from ..utils import bitpack


def _end_reads(tig):
    """(first_read, first_rev, last_read, last_rev) by tig coordinate."""
    i0 = int(np.argmin(tig.bgn))
    i1 = int(np.argmax(tig.end))
    return (
        int(tig.read_id[i0]), bool(tig.rev[i0]),
        int(tig.read_id[i1]), bool(tig.rev[i1]),
    )


def align_links(
    tigs: TigStore,
    links: list[tuple[int, str, int, str, int]],
    max_erate: float = 0.25,
    band: int = 128,
    device=None,
) -> list[tuple[int, str, int, str, int, float]]:
    """Re-align GFA links against consensus sequences (alignGFA equivalent).

    The reference recomputes every L-line's overlap between the FINAL
    consensus sequences with edlib and drops unalignable edges
    (Canu src/gfa/alignGFA.C:170-204).  Here each link's
    suffix-of-A vs prefix-of-B is re-aligned with the Myers banded
    extension in one batch; returns (ta, oa, tb, ob, refined_len, erate)
    for links that align within max_erate.
    """
    from ..ops.myers import banded_extend_myers

    dev = resolve_device(device)
    cns = {t.tig_id: t.consensus for t in tigs}
    rows = []
    for ta, oa, tb, ob, ov in links:
        ca, cb = cns.get(ta), cns.get(tb)
        if ca is None or cb is None or ov <= 0:
            continue
        A = ca if oa == "+" else bitpack.revcomp_codes(ca)
        B = cb if ob == "+" else bitpack.revcomp_codes(cb)
        # anchored at (0,0): the A-suffix must start exactly where the
        # estimated overlap does; the band absorbs +-band/2 estimate error
        ext = min(len(B), ov + band)
        rows.append((ta, oa, tb, ob, ov, A[len(A) - min(len(A), ov):], B[:ext]))
    if not rows:
        return []
    L = max(max(len(r[5]) for r in rows), max(len(r[6]) for r in rows))
    L = ((L + 127) // 128) * 128
    n = len(rows)
    a = np.zeros((n, L), np.uint8)
    b = np.zeros((n, L + band), np.uint8)
    a_len = np.zeros(n, np.int32)
    b_len = np.zeros(n, np.int32)
    for i, r in enumerate(rows):
        a[i, : len(r[5])] = r[5]
        a_len[i] = len(r[5])
        b[i, : len(r[6])] = r[6]
        b_len[i] = len(r[6])
    centers = np.broadcast_to(
        np.arange(L + 1, dtype=np.int32)[None, :], (n, L + 1)
    ).copy()
    e, au, bu = (x.cpu().numpy() for x in banded_extend_myers(
        *(torch.from_numpy(x).to(dev) for x in (a, a_len, b, b_len, centers)), band, L))
    out = []
    for i, (ta, oa, tb, ob, ov, _, _) in enumerate(rows):
        span = (int(au[i]) + int(bu[i])) / 2.0
        er = float(e[i]) / max(1.0, span)
        if span >= min(100, ov) and er <= max_erate:
            out.append((ta, oa, tb, ob, int(round(span)), er))
    return out


def write_gfa(
    path: str | os.PathLike,
    tigs: TigStore,
    readset: ReadSet,
    store: Optional[OverlapStore] = None,
    contigs_only: bool = True,
    verify_edges: bool = False,
    device=None,
) -> int:
    """Write tigs (S lines) + inter-tig overlap links (L lines).

    verify_edges=True re-aligns every link against the consensus
    sequences (align_links) and drops/refines unsupported ones, like the
    reference's alignGFA pass (Consensus.pm:583-640), on ``device``."""
    path = os.fspath(path)
    chosen = [t for t in tigs if (not contigs_only) or t.tig_class == CLASS_CONTIG]
    names: dict[int, str] = {t.tig_id: f"tig{t.tig_id:08d}" for t in chosen}
    # per-read tig-end entries (a read can terminate up to 2 tigs):
    # columnar tables instead of per-row Python loops — the link pass
    # below is ONE store-wide mask + 4 vectorized combination passes
    n_reads = store.n_reads if store is not None else 0
    ent_tig = np.zeros((2, n_reads + 1), np.int64)  # 0 = none
    ent_end = np.zeros((2, n_reads + 1), bool)  # True = tig's 'end' side
    ent_rev = np.zeros((2, n_reads + 1), bool)
    cnt = np.zeros(n_reads + 1, np.int8)
    for t in chosen:
        r0, rev0, r1, rev1 = _end_reads(t)
        ends = [(r0, False, rev0)] + ([(r1, True, rev1)] if r1 != r0 else [])
        for r, is_end, rv in ends:
            if 0 < r <= n_reads and cnt[r] < 2:
                c = cnt[r]
                ent_tig[c, r] = t.tig_id
                ent_end[c, r] = is_end
                ent_rev[c, r] = rv
                cnt[r] += 1

    n = 0
    links: list[tuple[int, str, int, str, int]] = []
    if store is not None and len(store.a_id):
        is_end_read = cnt > 0
        rows = np.flatnonzero(is_end_read[store.a_id] & is_end_read[store.b_id])
        a = store.a_id[rows]
        b = store.b_id[rows]
        ov_len = (store.a_end[rows] - store.a_bgn[rows]).astype(np.int64)
        flip = store.flipped[rows].astype(bool)
        keys = []
        recs = []
        for ia in range(2):
            for ib in range(2):
                ta, tb = ent_tig[ia, a], ent_tig[ib, b]
                ok = (ta > 0) & (tb > 0) & (ta != tb)
                if not ok.any():
                    continue
                # orientation: leaving ta via its end means '+'
                oa = ent_end[ia, a] != ent_rev[ia, a]
                ob = (~ent_end[ib, b]) != (ent_rev[ib, b] ^ flip)
                ka = ta * 2 + oa
                kb = tb * 2 + ob
                klo = np.minimum(ka, kb)
                khi = np.maximum(ka, kb)
                M = 2 * (int(max(names) if names else 0) + 2)
                key = (klo * M + khi) * (int(ov_len.max()) + 1) + ov_len
                keys.append(key[ok])
                recs.append(np.stack(
                    [ta[ok], oa[ok], tb[ok], ob[ok], ov_len[ok]], axis=1))
        if keys:
            key = np.concatenate(keys)
            rec = np.concatenate(recs)
            _, first = np.unique(key, return_index=True)
            for i in np.sort(first):
                ta, oa, tb, ob, ov = rec[i]
                links.append((int(ta), "+" if oa else "-",
                              int(tb), "+" if ob else "-", int(ov)))
    erate_of: dict[tuple, float] = {}
    if verify_edges and links:
        refined = align_links(tigs, links, device=device)
        links = [(ta, oa, tb, ob, ln) for ta, oa, tb, ob, ln, er in refined]
        erate_of = {(ta, oa, tb, ob): er for ta, oa, tb, ob, ln, er in refined}
    with open(path + ".WORKING", "w") as fh:
        fh.write("H\tVN:Z:1.0\n")
        for t in chosen:
            seq = bitpack.codes_to_seq(t.consensus) if t.consensus is not None else "*"
            ln = t.length
            fh.write(f"S\t{names[t.tig_id]}\t{seq}\tLN:i:{ln}\n")
            n += 1
        for ta, oa, tb, ob, ov_len in links:
            er = erate_of.get((ta, oa, tb, ob))
            tag = f"\ter:f:{er:.4f}" if er is not None else ""
            fh.write(f"L\t{names[ta]}\t{oa}\t{names[tb]}\t{ob}\t{ov_len}M{tag}\n")
    os.replace(path + ".WORKING", path)
    return n
