"""Tag-chain (DAG) consensus, the pbdagcon / alignment-graph role
(counterpart of canu_tpu.ops.dagcon, with the same results).

Per-column plurality (votepile._finalize_plurality) calls every column
on its own, which breaks on piles that need consistency across columns:
mixed-haplotype evidence (the call must follow one haplotype's chain) and
insertions longer than the vote format's two slots a column.  The
reference handles these with an alignment graph (Canu src/utgcns/
libpbutgcns/AlnGraphBoost.C) and the alignment-tag chain DP (Canu
src/correction/falconConsensus-alignTag.C): every read contributes a
chain of (column, delta, base) tags, edges between consecutive tags are
counted, and the consensus is the heaviest consistent source-to-sink
path.

The base-level alignment of every evidence window onto its template runs
on the device of the planes with the vote engine's DP
(trace.align_positions_lean: kernel K4 on the card, a group of chunks a
launch); what comes back per job is the evidence position j*(i) of every
template row and the oriented evidence window.  Tag extraction, edge
counting and the heaviest-chain DP are host
numpy, copied from canu_tpu: the DP keeps the first predecessor of the
highest score (a strict ``>``) and the backtrack starts at np.argmax's
first maximum.  cnsConsensus=dag and corConsensus=dag select it; the
plurality engine stays the default.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import votepile
from .trace import align_positions_lean
from .votepile import _gather_window

# deletion pseudo-base in tag space (real bases are 0..3)
DEL_BASE = 4
# max insertion tags kept between two template columns (falcon's
# alignTag delta cap role); longer inserts are truncated — iterative
# repileup absorbs the tail exactly like the plurality path does
MAX_DELTA = 12


# path chunks and jobs run by paths_for_jobs, and host wall seconds of
# paths_for_jobs ("paths": enqueue and fetch, waiting for the device), the
# tag extraction ("tags") and the chain DP ("chain"), summed over calls
# (the chip check reads them, for the correction and the polish alike)
CHUNKS = JOBS = 0
PROFILE: dict = {}

# groups of chunks whose paths may be on the device before the oldest is
# fetched
MAX_INFLIGHT = 8


def _lap(name: str, t0: float) -> None:
    PROFILE[name] = PROFILE.get(name, 0.0) + (time.perf_counter() - t0)


def _paths_many(t_words, t_lengths, e_words, e_lengths,
                cols: torch.Tensor,  # int32[7, B]: t_idx, e_idx, t_bgn, t_span, e_lo, e_span, flipped
                band: int, n_rows: int):
    """Alignment paths of a group of evidence jobs on the planes' device
    (one DP call, one launch of kernel K4 on the card).

    Returns (j_star int32[B, n_rows+1], e_sub uint8[B, W_e]) with W_e =
    n_rows + max(band, n_rows // 2): each template row's evidence position
    and the oriented evidence window it indexes.  votepile._group_paths
    with ends_free; the paths go to the host instead of being folded into
    votes, since the DAG needs each read's chain.
    """
    t_idx, e_idx = cols[0].to(torch.int64), cols[1].to(torch.int64)
    W_e = n_rows + max(band, n_rows // 2)
    t_sub = _gather_window(t_words, t_lengths, t_idx, cols[2], None, n_rows)
    e_sub = _gather_window(e_words, e_lengths, e_idx, cols[4], cols[6] != 0, W_e)
    e_span = torch.clamp(cols[5], max=W_e - 1)
    js, _ = align_positions_lean(t_sub, cols[3], e_sub, e_span, band, n_rows, ends_free=True)
    return js, e_sub


def paths_for_jobs(t_words, t_lengths, e_words, e_lengths, jobs, Lt: int,
                   band: int) -> tuple[np.ndarray, np.ndarray]:
    """Every job through _paths_many; returns host arrays (js int32[n,
    Lt+1], e_sub uint8[n, W_e]).  Chunks of votepile.chunk_jobs(Lt) jobs
    (CHUNK_CELL_BUDGET, sized from the card's memory), the band capped at
    256, votepile.group_chunks of them a DP call, up to MAX_INFLIGHT groups
    enqueued ahead of the fetch, which takes their results in order.  Each
    job's DP is its own, so the results do not depend on the chunk or group
    size."""
    global CHUNKS, JOBS
    t0 = time.perf_counter()
    n = len(jobs)
    n_rows = Lt
    band_c = min(band, 256)
    W_e = n_rows + max(band_c, n_rows // 2)
    js_out = np.zeros((n, n_rows + 1), np.int32)
    es_out = np.zeros((n, W_e), np.uint8)
    if n == 0:
        return js_out, es_out
    B = votepile.chunk_jobs(n_rows)
    k = votepile.group_chunks(band_c, n_rows, B, t_words.device)
    # the vote engine's job columns; the first seven are _paths_many's
    packed_d = torch.from_numpy(votepile.pack_columns(jobs, B)[:, :7]).to(t_words.device)
    C_total = packed_d.shape[0]
    JOBS += n
    pending: list = []

    def drain_one() -> None:
        lo, js_d, es_d = pending.pop(0)
        hi = min(lo + js_d.shape[0], n)
        js_out[lo:hi] = js_d.cpu().numpy()[: hi - lo]
        es_out[lo:hi] = es_d.cpu().numpy()[: hi - lo]

    for c0 in range(0, C_total, k):
        cols = votepile.group_columns(packed_d, c0, k)
        js_d, es_d = _paths_many(t_words, t_lengths, e_words, e_lengths, cols, band_c, n_rows)
        CHUNKS += cols.shape[1] // B
        pending.append((c0 * B, js_d, es_d))
        if len(pending) >= MAX_INFLIGHT:
            drain_one()
    while pending:
        drain_one()
    _lap("paths", t0)
    return js_out, es_out


def _job_tags(
    t_bgn: int, t_span: int, js: np.ndarray, e_row: np.ndarray, e_span: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Tags (pos, delta, base) for one aligned evidence window, in chain
    order.  pos is the template column IN SEGMENT COORDINATES; delta=0
    tags are the base (or DEL_BASE) aligned at pos; delta=k>=1 tags are
    insertion bases between pos and pos+1 (attached to the PRECEDING
    column, matching alignTag convention)."""
    js = js[: t_span + 1].astype(np.int64)
    dj = js[1:] - js[:-1]
    i = np.arange(t_span)
    active = (js[1:] > 0) & (js[:-1] < e_span)
    cols = t_bgn + i
    # base / deletion tags at (col, 0)
    bidx = np.clip(js[1:] - 1, 0, len(e_row) - 1)
    base = np.where(dj >= 1, e_row[bidx], DEL_BASE).astype(np.int64)
    keep_b = active
    pos0, d0, b0 = cols[keep_b], np.zeros(keep_b.sum(), np.int64), base[keep_b]
    # insertion tags: bases e_row[js[i] .. js[i+1]-2] attach to (col-1, k)
    nins = np.clip(dj - 1, 0, MAX_DELTA)
    keep_i = active & (nins > 0) & (cols > t_bgn)  # no preceding tag -> drop
    if keep_i.any():
        cnt = nins[keep_i]
        posI = np.repeat(cols[keep_i] - 1, cnt)
        within = np.arange(cnt.sum()) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        dI = within + 1
        src = np.repeat(js[:-1][keep_i], cnt) + within
        bI = e_row[np.clip(src, 0, len(e_row) - 1)].astype(np.int64)
        pos = np.concatenate([pos0, posI])
        dd = np.concatenate([d0, dI])
        bb = np.concatenate([b0, bI])
    else:
        pos, dd, bb = pos0, d0, b0
    order = np.lexsort((dd, pos))
    return pos[order], dd[order], bb[order]


def tag_chain_consensus(
    template: np.ndarray,
    tag_sets: list[tuple[np.ndarray, np.ndarray, np.ndarray]],
    min_cov: int = 2,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Heaviest-consistent-chain consensus for one segment.

    tag_sets: one (pos, delta, base) triple per evidence read (chain
    order).  Columns whose delta-0 coverage is below min_cov keep the
    template base (and break chains, like the plurality path's
    keep_template columns).  Returns (consensus codes, per-output-base
    evidence coverage, n_edits) — the coverage lets correction-style
    callers split the output at unsupported columns."""
    S = len(template)
    if not tag_sets or S == 0:
        return template.copy(), np.zeros(S, np.int64), 0
    # ---- coverage gate ------------------------------------------------
    cov = np.zeros(S, np.int64)
    for pos, dd, _ in tag_sets:
        at0 = pos[dd == 0]
        np.add.at(cov, at0[(at0 >= 0) & (at0 < S)], 1)
    good = cov >= max(1, min_cov)
    # ---- flatten tags, drop gated columns, count edges per read -------
    D1 = MAX_DELTA + 2
    all_key, all_read = [], []
    for r, (pos, dd, bb) in enumerate(tag_sets):
        ok = (pos >= 0) & (pos < S)
        ok &= good[np.clip(pos, 0, S - 1)]
        if not ok.any():
            continue
        key = (pos[ok] * D1 + dd[ok]) * 5 + bb[ok]
        all_key.append(key)
        all_read.append(np.full(len(key), r, np.int64))
    if not all_key:
        return template.copy(), cov, 0
    keys = np.concatenate(all_key)
    reads = np.concatenate(all_read)
    same = reads[1:] == reads[:-1]
    e_src = keys[:-1][same]
    e_dst = keys[1:][same]
    # only ADJACENT transitions are graph edges: (pos, d) -> (pos, d+1)
    # (insertion chain) or (pos, d) -> (pos+1, 0).  A gated/inactive
    # column must BREAK the read's chain, not be bridged by a spurious
    # edge that would skip its template base entirely.
    sp, sd = e_src // (D1 * 5), (e_src // 5) % D1
    dp_, dd_ = e_dst // (D1 * 5), (e_dst // 5) % D1
    adj = ((dp_ == sp) & (dd_ == sd + 1)) | ((dp_ == sp + 1) & (dd_ == 0))
    e_src, e_dst = e_src[adj], e_dst[adj]
    if len(e_src) == 0:
        return template.copy(), cov, 0
    # ---- unique nodes + edges -----------------------------------------
    nodes = np.unique(keys)
    n_nodes = len(nodes)
    edge_key = e_src * (nodes[-1] + 1) + e_dst  # src always < dst
    uedge, ecnt = np.unique(edge_key, return_counts=True)
    usrc = np.searchsorted(nodes, uedge // (nodes[-1] + 1))
    udst = np.searchsorted(nodes, uedge % (nodes[-1] + 1))
    # ---- heaviest-chain DP over nodes in key order --------------------
    # edges always go key_src < key_dst ((pos, delta) strictly increases
    # along a read's chain), so ascending-key node order is topological.
    order = np.argsort(udst, kind="stable")
    usrc, udst, ecnt = usrc[order], udst[order], ecnt[order]
    bounds = np.searchsorted(udst, np.arange(n_nodes + 1))
    usrc_l, ecnt_l = usrc.tolist(), ecnt.tolist()
    bounds_l = bounds.tolist()
    score_l = [0] * n_nodes
    prev_l = [-1] * n_nodes
    for d in range(n_nodes):
        b0, b1 = bounds_l[d], bounds_l[d + 1]
        best, barg = 0, -1
        for e in range(b0, b1):
            s = score_l[usrc_l[e]] + ecnt_l[e]
            if s > best:
                best, barg = s, usrc_l[e]
        score_l[d] = best
        prev_l[d] = barg
    score = np.asarray(score_l)
    best_prev = np.asarray(prev_l)
    # ---- backtrack from the global best end node ----------------------
    end = int(np.argmax(score))
    if score[end] <= 0:
        return template.copy(), cov, 0
    path = []
    cur = end
    while cur >= 0:
        path.append(cur)
        cur = int(best_prev[cur])
    path.reverse()
    pkeys = nodes[path]
    ppos = pkeys // (D1 * 5)
    pd = (pkeys // 5) % D1
    pbase = pkeys % 5
    # ---- emit: template outside the path's span, chain inside ---------
    # a path starting on an insertion tag contributes bases AFTER column
    # ppos[0]'s own base, so the template prefix must include that column
    lo = int(ppos[0]) + (1 if int(pd[0]) > 0 else 0)
    hi = int(ppos[-1])
    keep = pbase != DEL_BASE
    emit = pbase[keep].astype(np.uint8)
    out = np.concatenate([template[:lo], emit, template[hi + 1 :]])
    out_cov = np.concatenate(
        [cov[:lo], cov[np.clip(ppos[keep], 0, S - 1)], cov[hi + 1 :]]
    )
    n_edits = int(
        np.sum(pd > 0)
        + np.sum(pbase == DEL_BASE)
        + np.sum((pd == 0) & (pbase != DEL_BASE)
                 & (pbase != template[np.clip(ppos, 0, S - 1)]))
    )
    return out, out_cov, n_edits


def segment_consensus(tmpl: np.ndarray, jobs, take, js: np.ndarray, e_sub: np.ndarray,
                      min_cov: int) -> tuple[np.ndarray, np.ndarray, int]:
    """One segment's tag-chain consensus from its evidence jobs ``take``
    (indices into jobs, js and e_sub): tag_chain_consensus's (seg, cov,
    n_edits).  Its host walls go to PROFILE "tags" and "chain"."""
    t0 = time.perf_counter()
    tag_sets = [_job_tags(int(jobs.t_bgn[j]), int(jobs.t_span[j]), js[j], e_sub[j],
                          int(jobs.e_span[j])) for j in take]
    _lap("tags", t0)
    t1 = time.perf_counter()
    out = tag_chain_consensus(tmpl, tag_sets, min_cov=min_cov)
    _lap("chain", t1)
    return out


def dag_segments(
    seg_codes: list[np.ndarray],
    t_words, t_len_d, e_words, e_len_d,
    jobs, Lt: int, band: int, min_cov: int,
) -> tuple[list[np.ndarray], int]:
    """DAG-consensus every segment of a backbone given its evidence jobs
    (VoteJobs with t_idx = segment index, t_bgn/e_lo in segment /
    oriented-evidence coordinates): the paths on the planes' device, the
    per-segment tag-chain DP on the host."""
    js, e_sub = paths_for_jobs(t_words, t_len_d, e_words, e_len_d, jobs, Lt, band)
    n_seg = len(seg_codes)
    per_seg: list[list[int]] = [[] for _ in range(n_seg)]
    for jidx in range(len(jobs)):
        si = int(jobs.t_idx[jidx])
        if 0 <= si < n_seg:
            per_seg[si].append(jidx)
    new_segs: list[np.ndarray] = []
    n_edits = 0
    for si in range(n_seg):
        tmpl = np.asarray(seg_codes[si], np.uint8)
        if not per_seg[si] or len(tmpl) == 0:
            new_segs.append(tmpl)
            continue
        seg, _cov, ed = segment_consensus(tmpl, jobs, per_seg[si], js, e_sub, min_cov)
        new_segs.append(seg)
        n_edits += ed
    return new_segs, n_edits
