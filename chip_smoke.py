"""Run canu_tpu_torch's overlap, correction, trimming and assembly paths,
the dag consensus, the tools, the sharded path and raw reads to contigs
at E. coli scale once on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases (each prints its results; any failure exits non-zero):
  1 device    require CUDA; print the card's name and power limit
  2 build     compile kernels K1, K10 and K11 (csrc/myers_tile.cu), K2/K3
              (csrc/banded_extend.cu), K4 (csrc/vote_dp.cu), K5/K6
              (csrc/minhash.cu), K7/K8 and K12 (csrc/verify.cu) and K9
              (csrc/vote_fold.cu) from this checkout, one nvcc each, in
              parallel
  3 kernel    each kernel against its plain PyTorch loop on the card, bit
              for bit: (a) K1's six outputs on edge cases (every window
              edge of its A, B and shift streams), (b) K1 on 256 real
              extensions sampled from the first verify group of phase 4,
              (c) K2 and K3's three outputs on edge cases at bands 128,
              256 (K2), 640 and 1024 (K3) and on 256 real extensions
              sampled from the first call of each utg drive of phase 7,
              (d) K4's j* and edits against the plain DP on
              tests/torch_cases.py trace_cases at bands 128, 200 and 256,
              ends_free both ways, 256 rows, and on DP_GROUP_CASES: one
              launch each of 300 to 4,096 jobs, 1, 2, 3 and 63
              super-rows, bands 1, 128, 129 and 256, t_len over every
              row, mostly short or uniform, (e) K5's sketch and K6's
              match (ii, jj, c, n_found, and the count launch's slot
              counts) against the plain sketch and match on
              tests/torch_cases.py's edge cases (SKETCH_EDGE_CASES:
              reads of 0, k-1, k and off-word lengths, k 16 and 22, H 1,
              64 and 768, the sentinel table and ~3,000 frequent keys,
              most >= 2^31, holding every key of one read;
              MATCH_EDGE_CASES: self and cross blocks, Na != Nb, an empty
              read's row, max_out above and below n_found;
              MATCH_PAIR_CASES: 1 x 1 to 1,024 x 1, a self block's set
              cells in one tile row, Na past 1,024 and 2,048, Nb past 32
              column tiles, max_out 0), each pair two launches
              (the count and the compact), then on the
              sketch blocks and block pairs phases 4 and 4c ran, the
              first block of phase 15's sketch and block pairs of its
              sketches, (f) K7's ten outputs (the base rows, lengths and
              centres, n_anchor, flipped, the seeds, n_minor) against the
              plain anchor step chunk by chunk, and K8's four against the
              plain syncmer selection, on tests/torch_cases.py's edge
              cases (VERIFY_PRE_EDGE_CASES: groups of 3 chunks with one
              anchor, a tied strand vote, repeated anchor positions,
              duplicate keys, a chain whose centre rounds by the order of
              operations, the padding row, reads against themselves; k 16
              and 22, W 64 and 96, bands 128, 256 and 1024;
              SYNCMER_EDGE_CASES: reads of 0, k-1, k and off-word lengths,
              a repeated motif, a selected k-mer whose key's mix32 is
              UINT32_MAX, pm above and below n_sel; verify_pre_long_case:
              reads of up to 170,851 bases, W 16,384), then on the first
              K7 group and every block of phase 4's index, the first
              group and index
              block of phases 4b, 6 and 7, the first group of 11a's and
              11b's OEA adjust (orient=False), and the first group, every
              16th after it and each index's first block of phases 9, 15
              and 16, (g) K9's votes against the plain fold
              (ops.votepile._fold_chunk, chunk by chunk) on
              tests/torch_cases.py's fold cases (FOLD_CASES: t_bgn's high
              bits, deleted runs over 15 rows and at the last row, dj >= 3,
              paths at 0 and past e_span and W_e, rows past t_span, pad
              jobs, a slot off the block, 64 to 8,192 rows;
              fold_exact_case: 256 jobs voting one column at count 15 and
              the largest weight; FOLD_TILE_CASES: K9's tile edges,
              deleted runs across them, an undeleted run longer
              than a tile, runs past Lt, one slot or interleaved slots,
              pads and off-block slots, Lt below the tile width) and a
              group of 17 chunks at the
              correction's geometry, each one launch into votes already
              holding votes; then on the groups the main path folded:
              the first DP group of phases 10 and 15, and
              phase 16's first RED and first polish group (held_fold)
              3a also holds K10 (the band schedule's shift bits and the
              row-0 planes, from the centres as rows and on their 16-row
              grid, one block or a cluster of blocks an extension) and
              K11 (the end pick, run by K1 after its last row and alone)
              to the plain chain (ops.myers _schedule, _shift_bits,
              _myers_init, _carry_pack; _carry_unpack, _myers_finish) on
              each edge case, K10 alone on tests/torch_cases.py
              myers_schedule_cases (rows, grid, split over 2 and 8
              blocks) and myers_split_case (3 x 200,003 rows) and K11
              alone on myers_finish_cases; then on phase 5's first
              group, phase 9's first group and the judge's launch of
              phase 16
  4 slice     meryl + overlap ("cor") stages on the bench.py read set
              (1,025 reads, 3.64 Mb) in a temporary directory; K1 must
              have launched and the plain loop must not have run on the
              card; the store must be non-empty, symmetric and equal to
              the JAX package's (cor_overlap_reference.json); every K1
              launch of the stage is captured with its inputs
  4b cor256   the same stages at corOvlBandWidth=256 (K2, partial
              overlaps, on reads whose extensions really fail), store
              equal to the JAX package's (the "cor256" entry) and its
              rows against the band-128 store's
  4c frequent the cor and obt meryl + overlap stages on the bench shapes
              with a 1.5 kb repeat of 24 copies (tests/torch_cases.py
              frequent_reads: raw reads for cor, corrected ones for obt,
              each with a palindromic chimeric read), ovsMethod=spill:
              each frequent table must be non-empty, K1, K5 and K6 must
              have launched and the spill build once, no other kernel or
              plain loop on the card; the frequent tables, candidates and
              spilled stores (by store_digest, obt's with the palindromic
              pair's repeated rows) equal the JAX package's
              (frequent_overlap_reference.json,
              scripts/torch_frequent_reference.py)
  4d placed   stage C (place_candidates) on the bench read set's cor
              candidates at k 16 with the frequent table and at k 22
              without one, then verify_overlaps of each placed set: K12
              once a place_candidates call, its rows held bit for bit to
              the plain statistics chunk by chunk (the CPU path's padded
              chunks of 256 pairs), the verify's K7, K8, K10 and K1 with
              the end pick; the candidates, the placed candidates and the
              verified rows against placed_overlap_reference.json
              (scripts/torch_placed_reference.py); K12 timed on the first
              chunk through the chunk entry beside its bound and the plain
              version, and on each whole call beside the chunks' summed
              bound and its own count (pair_stats_design)
  5 timing    warm passes of sketch, match and verify as bench.py times
              them, one more pass under torch.profiler (device busy share
              of each sub-stage; tables in chiprun_out/profile.txt); K1
              with CUDA events on every group the cor stage launched it
              on, and their sum (K1 ms per cor stage), beside its bound;
              the same extensions cut into the launches of 4 chunks
              that MYERS_GROUP 4 made before (lane slices; the first is
              the earlier first group); K1 against the plain loop on the
              phase-3b sample and on the whole first verify group; K5 on
              every block of the pass's sketch and K6 on every block pair
              of its match (CUDA events) beside their bounds and the plain
              versions' times; K7 on phase 4's first verify group and K8
              on every block of its index, beside their bounds and the
              plain versions' times; K10 and K11 on the first verify
              group beside their bounds (K10's on the grid beside the
              row-centre bound) and the plain chain's times, K1 with the
              pick beside K1 and K11 alone
  6 obt       meryl + overlap ("obt", k=22 two-lane k-mers, band 128:
              K1 with partial and palindromic pairs) on the corrected
              read set (1,004 reads, 3.61 Mb, 3% error)
  7 utg       meryl + overlap ("utg") on the same reads at
              utgOvlBandWidth=256 (the INF-walled engine, kernel K2) and
              at 1024 (kernel K3, which carries the bands above K2's 512)
              Phases 6 and 7 each run in a directory of their own with
              every launch count set to 0 first: the path's kernel must
              have launched, no other kernel and no plain loop on the
              card; frequent table, candidates and store must equal the
              JAX package's (corrected_overlap_reference.json)
              Every drive of the INF-walled engine keeps every
              banded_extend call it made (one per group of up to
              MYERS_GROUP chunks)
  8 timing    per drive (cor256 and utg256: K2; utg1024: K3): each
              extension's exit row by the plain recurrence
              (tests/torch_cases.py extend_exit_rows, the whole drive at
              once; the outputs at the exit row must be the end's), the
              kernel bit-equal to it on every call, each call with CUDA
              events and the drive's sum, beside the bounds of every live
              row and of the rows up to the exit rows; the first call's
              first 1,024 extensions (the shape of one call per chunk);
              the whole first call against banded_extend_plain
  9 ecoli     meryl + overlap ("obt", band 128) at the shapes of the JAX
              package's config 2, cut to 3 Mb (ECOLI_OBT_GENOME; phase 16
              runs obt at 4.6 Mb): random_genome(3 Mb, seed=7) at 25x
              (21,506 corrected reads, 75.2 Mb), ovsMethod=spill: the
              host k-mer counter (74.8 M k=22 instances, above the device
              budget of 2^26), the hash-join (above 5,000 reads), K1 and
              the spill store with the native external sort, each counted
              (once each; K1 launched; no other kernel or plain loop on
              the card); frequent table and candidates equal to the JAX
              package's (ecoli_overlap_reference.json); the store's rows
              for two samples of 2,048 candidates (every floor(M/2048)-th,
              and the same from half a stride in) equal to the JAX
              package's store of each sample; the spilled store equal to the in-RAM
              build of the tables the spill got; the store symmetric.
              Prints the stage's sub-walls, K1 on each launch (CUDA
              events) beside its bound, and the device memory peak over
              the verify beside _chunk_staging_bytes x the window
  10 correct  correction_phase (gatekeeper, meryl, overlap "cor", the
              falcon-sense vote engine) from a FASTA of the raw bench
              reads, Config() + genomeSize=300k, in a directory of its own:
              K1 must have launched, K4 once per call of the vote engine's
              DP (a group of chunks; one launch of 4 chunks or more at
              least), and no other kernel, plain loop or plain DP run on the
              card; the gatekeeper store's reads and bases, the cor
              store (cor_overlap_reference.json) and the corrected reads of
              each of the nine blocks (correction_reference.json, by
              digest) must equal the JAX package's; every corrected record
              is <read>_corrN.  Prints the stage walls, the correction's
              parts (selection, DP, windows, vote fold, finalize, fetch,
              decode, the block files' writes, their concatenation and the
              re-read that counts the records), chunks, groups and jobs,
              the vote fold a chunk by CUDA events beside the first
              chunk's bound (FOLD_ROW_OPS), the jobs of each K4
              launch, one chapter's launches and device busy share
              (torch.profiler; table in
              chiprun_out/profile_correct.txt) and the device memory peak
              over the correction.  The vote engine's DP is kernel K4 and
              its fold kernel K9, once per DP group (the JAX package's are
              jitted XLA programs, with no Pallas kernel); its windows are
              PyTorch ops
  11 assemble run_pipeline from a FASTA of simulated corrected reads (the
              bench shapes at 1.5% error), Config() + genomeSize, twice,
              each in a directory of its own with the counts set to 0
              first: trimming (obt gatekeeper, meryl, overlap, trimming),
              then assembly (utg gatekeeper, meryl, overlap, oea: RED on
              the vote engine and OEA's verify, unitig, consensus: the
              plurality polish, outputs: FASTA, layout.tsv, GFA with
              links re-aligned, HTML).  K1 must have launched in the obt
              overlap, the utg overlap, the OEA adjust and, where the GFA
              keeps a link, align_links; K4 once per DP call of RED and the
              polish; no other kernel, plain loop or plain DP on the card.
              11a: random_genome(100 kb, seed=71) with three
              copies of a 9 kb repeat (cut from the bench's 300 kb so the
              JAX package's CPU reference finishes); the trimmed reads,
              utg store, RED corrections, adjusted erates, unitig and
              contig layouts, contigs/unassembled/unitigs FASTA,
              layout.tsv and the GFA's S and L lines must equal
              assembly_reference.json (scripts/torch_assembly_reference.py),
              with >= 2 contigs and their links re-aligned on K1 (none
              survives the polished ends' clipping, in canu_tpu too, so
              write_gfa then keeps test_gfa.py's surviving link on the
              card, K1 in align_links, its page equal to the CPU's).
              11b: the bench genome, nothing cut: >= 1 contig, every GFA
              L-line naming two S-lines, every layout.tsv read in the utg
              store.  In both, the largest contig's length, identity to
              the simulated genome and misjoins (tests/torch_cases.py
              identity_vs_genome: banded extensions at band 512 between
              exact 32-mer anchors every 5 kb, kernel K2) must equal the
              reference's; whether the identity reaches TRUTH_IDENTITY
              is printed, not gated.  Prints the stage walls, RED's and
              the adjust's walls, the vote chunks and DP time (CUDA
              events) of RED and the polish, K1 on each launch of the
              adjust beside its bound, the device memory peak over the
              assembly phase, the contigs, NG50 and identity.  Then
              python -m canu_tpu_torch on 11b's directory must skip every
              stage by resume and exit 0, and -options must list
              genomeSize
  12 dag      the tag-chain consensus (ops/dagcon.py: the paths on the
              vote engine's DP, K4; the chain DP host numpy).
              12a: correction_phase with corConsensus=dag on a copy of
              phase 10's directory without its corrected reads (the
              gatekeeper, meryl and cor overlap stages resume), every
              block; the blocks dag_reference.json covers must equal the
              JAX package's by digest, every record <read>_corrN.  12b:
              run_pipeline with cnsConsensus=dag resumed on a copy of
              11a's directory without the consensus and output stages'
              products: only those two stages may run, and the layouts,
              the contigs/unassembled/unitigs FASTA, layout.tsv and the
              GFA must equal the JAX package's run of 11a with
              cnsConsensus=dag (scripts/torch_dag_reference.py).  K4 once
              per path chunk, K1 in 12b's align_links and no other kernel,
              plain loop or plain DP on the card.  Prints the walls, the
              path chunks, the DP by CUDA events, the host time of the tag
              chains and the device memory peak
  12c vote_dp K4 held bit for bit (j* and edits) to the plain DP on the
              card on DP calls the main path made, each a K4 launch of a
              group of chunks: the first three of phase 10 (falcon, band
              256, 2,048 rows), the first of 11a's RED and of its
              polish, the first of 12b (ends_free=True); the first whole,
              the others on a seeded subset of their jobs that holds each
              chunk's first and last (dp_subset); K4 by CUDA events on
              phase 10's first chunk alone (mean of 10) and on its first
              full group (mean of 5, and its share a chunk), each beside
              its bound (vdp_bound), the whole DP call, the plain DP's one
              run on the group and the E. coli projection of the DP
  13 tools    canu_tpu_torch.tools.main in this process on the scripted
              session of tests/torch_cases.py tools_session (simulate at
              the bench shapes on a 100 kb genome, TOOLS_GENOME, analyze, sample, kmer-count at k=16 and
              k=22, kmer-op's ten ops, map-mers, mask-mers, mer-trim,
              mercy, ov-import of random overlaps, a PAF and a text
              dump, ov-stats, ov-dump, best-edges, dump-reads,
              dump-meta, options, bogus on the genome with 1% point
              errors, a misjoin and a 700-base collapse): every step's
              exit code, stdout, stderr and files must equal
              tools_reference.json (scripts/torch_tools_reference.py;
              the k=22 DB steps against canu_tpu's result on the DB as
              counted).  K1 must launch in bogus (the identity ruler) and
              nowhere else; each launch by CUDA events beside its bound,
              and held bit for bit to the plain loop on every one of its
              rows (k1_held_to_plain: K1's carry at every 4,096th row, the
              plain rows of all segments at once from those carries), its
              end pick too; K10 and K1 with the pick held to the plain
              chain on bogus's extension call (held_myers_ends).
              tig-dump, tig-display and tig-coverage on 11b's tig store,
              and bogus on 11b's contigs, are printed, not gated
  14 grid     the sharded path (canu_tpu_torch.parallel) on the bench read
              set, nothing cut.  14a: a world of one rank over NCCL in
              this process (init_distributed with a FileStore): the cor
              gatekeeper, meryl and overlap stages with
              shardedCompute=true; the hash-range meryl's all_to_all must
              run on NCCL, K1 launch, no other kernel and no plain loop
              run on the card, and the frequent table, candidates and
              store equal cor_overlap_reference.json; the k=22 sharded
              count must equal the single-device counter;
              sharded_verify_candidates (K2, band 128) on every third
              candidate gives the rows 14b holds, held bit for bit to the
              same call with the plain loop in K2's place; K2 alone on
              each of its launches beside extend_bound.  14b: two
              ranks on this one card over gloo (NCCL refuses two ranks on
              one card; one rank a card over NCCL on a machine of several),
              each a process of its own, started after phase 2 built the
              kernels, with jax and canu_tpu blocked as here:
              correction_phase from phase 10's FASTA (gatekeeper on rank 0,
              the hash-range meryl, the ring, a strided half of the verify
              on each rank, the a_id-range exchange into store shards that
              rank 0 merges, correction blocks strided over the ranks):
              the cor frequent table, candidates and store equal the
              reference, rank 0 corrects blocks 0, 2, 4, 6, 8 and rank 1
              blocks 1, 3, 5, 7, every block equal to
              correction_reference.json, every record <read>_corrN, K1
              on each rank and K4 once per DP call, no plain loop or plain
              DP on the card; the cor stages again
              under ovsShardExchange=allgather give the same store;
              sharded_verify_candidates' rows on two ranks equal the
              world of one's, K2 launched.  Each rank prints its stage
              walls, the collectives (calls, bytes, seconds), the DP by
              CUDA events, its launches and its device peak; the card's
              memory in use is sampled by nvidia-smi meanwhile; the
              ranks' logs are in chiprun_out/phase14_rank*.log
  15 ecolicor correction_phase from a FASTA of raw reads at E. coli scale:
              the JAX package's config 2 at 10% error (random_genome(4.6
              Mb, seed=7) at 25x, 32,994 reads, 116.2 Mb), Config() +
              genomeSize with the pacbio read-type profile and the
              resource solver (run_pipeline's configuration of
              -pacbio-raw reads), nothing cut, in a directory of its own
              that phase 16 goes on in, with the counts set to 0 first: the device k-mer counter (116 M k=16
              instances), the hash-join, K1, the store, ~290 blocks of
              the vote engine.  K1 must have launched, K4 once per DP
              call (one launch of 4 chunks or more at least), no K2 or K3
              launch and no plain loop or plain DP on the card; the
              gatekeeper store's reads and bases, the frequent table, the
              whole candidate set, the cor store's rows whose a_id is one
              of 256 sampled templates and those templates' corrected
              reads in the phase's FASTA must equal
              ecoli_correction_reference.json (the JAX package's
              correction of that sample on its restricted store,
              scripts/torch_ecoli_correction_reference.py); K4's first
              DP call held to the plain DP on a subset of its jobs.
              Prints the stage walls, meryl's route, the overlap's
              sub-walls, K1 on each launch beside its bound, the
              correction's parts (phase 10's, and the block files'
              writes, their concatenation and the re-read that counts
              the records), templates, blocks, chunks, DP groups, the
              jobs of each K4 launch, K4's bound summed over the DP calls,
              K9 on every group by CUDA events beside the summed bound,
              K5 over the whole sketch (CUDA events on each launch) beside
              its summed bound, and the device memory peak over meryl, the
              verify and the correction
  16 ecoliasm run_pipeline(raw_reads=[the FASTA]) in phase 15's
              directory, Config() + genomeSize, the counts set to 0
              first: the correction resumes (its log says so, its FASTA is
              untouched), then trimming (obt gatekeeper, meryl on the host
              counter, overlap, trimming) and assembly (utg gatekeeper,
              meryl, overlap, oea: RED and OEA's adjust, unitig,
              consensus: the plurality polish, outputs) at E. coli scale.
              K1 must have launched in the obt and utg overlaps, the
              adjust, align_links (where the GFA has a link) and the judge,
              K4 once per DP call, K9 once per DP group (only in RED and
              the polish), no K2 or K3 launch and no plain loop, plain DP
              or plain fold on the card; RED's and the polish's first DP
              calls held to the plain DP on dp_subset's jobs.  Each stage is held
              to ecoli_assembly_reference.json (the JAX package on the
              CPU, scripts/torch_ecoli_assembly_reference.py) on its own
              input as the card made it: each input's digest first (the
              corrected and trimmed reads, the autoerate gate, RED's
              corrections of every read, the adjusted utg store,
              spec.used), then the obt and utg gatekeepers, frequent
              tables and candidates, a 256-read sample's store rows of
              each, the sampled reads' trimmed records and RED
              corrections, the adjusted erates of the utg sample's rows
              and every unitig and contig layout; without a reference (or
              where an input differs) the inputs go to
              chiprun_out/ecoli_asm/ for that script and the phase fails.
              The judge (sim/bogus.py evaluate_assembly, K1 on the card):
              contigs, NG50, misjoins, identity, genome fraction, printed
              beside canu_tpu's own run on these reads and the 0.999 bar,
              not gated.  Then python -m canu_tpu_torch -pacbio-raw on the
              directory must skip every stage.  Prints the stage walls,
              the overlaps' and oea's sub-walls, meryl's route, each
              step's device memory peak, K1 per drive (obt, utg, adjust,
              align_links, judge) by CUDA events beside its bound, RED's
              and the polish's DP and K9 by CUDA events beside their summed
              bounds, RED's host enqueue of the votes, and each verify's
              profile (ops.align.LAST_PROFILE: pre_s, extend_s, post_s,
              index_s beside dispatch_s)
Every main-path run of phases 4-17 (4, 4b, 4c, 4d, 6, 7, 9, 10, 11, 14a,
14b, 15, 16, 17) must launch K7 and K8 and run neither plain version on
the card; drive_stage drops the read set's cached index first, so that
each drive builds its own.  In each of them K9 launches once per DP group
of the vote engine (none where it does not vote) and the plain fold never
runs on the card, and K10 launches once beside each K1 launch, which runs
K11's end pick after its last row (verify, the OEA adjust, align_links;
the judge's and the tools' bogus too): K11 never launches alone there,
and the plain Myers schedule and segments never run on the card.

Each kernel's bound is the larger of its operations over the card's
32-bit integer rate and its bytes over the memory rate (INT32_OPS_S,
HBM_BYTES_S).  The operations are the least the function needs on this
run's data (K1_*_OPS, INF_*_OPS, VDP_*_OPS; k1_work and extend_bound
count the live rows, shifted rows, rows with b_len in the window and band
cells up to b_len; for K2 and K3 the rows up to each extension's exit
row, after which its outputs are fixed, and the kernels line gives their
bound under that count; vdp_bound the window cells at j <= e_len of the
rows up to t_len, both passes; sketch_bound the kept (window, slot) pairs
and the windows on the read, SKETCH_*_OPS; match_bound the (cell, slot)
pairs a block pair needs, MATCH_*_OPS; pre_bound each pair's three sorts,
n log2 n compares each, and the elements written, VERIFY_PRE_OPS;
syncmer_bound the s-mers and positions on the reads, the selected keys
and their sort, SYNCMER_OPS; fold_bound the live rows of the jobs that
vote, FOLD_ROW_OPS; myers_ends_bound the scheduled rows (and the 16-row
grid's units where the centres come on it) and the columns of the end
pick, K10_*_OPS and K11_*_OPS; pair_stats_bound the on-read k-mer
positions and the chunk's hits, PAIR_*_OPS).  The bytes are each input the kernel needs read once
and each output written once.  The plain loops' own per-row counts
(plain_row_ops) are printed beside, as a second figure.

The line before the last is the JSON kernel record; the last line is
{"ok": true, "device": {...}}.  Imports nothing of jax or canu_tpu.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WARM_PASSES = 3
OUT_DIR = os.path.join(ROOT, "chiprun_out")
OLD_GROUP_LANES = 4 * 2 * 512  # a K1 launch at MYERS_GROUP 4: 4 chunks of 512 pairs, both ways
OLD_EXTEND_LANES = 2 * 512  # a K2/K3 launch of one chunk of 512 pairs, both ways
BENCH_GENOME = 300_000  # bench.py's genome (phases 4-8 and 10)
ECOLI_GENOME = 4_600_000  # the JAX package's config 2 (phases 15, 16)
# phase 9's genome: config 2's shapes at 3 Mb, whose 75 M k=22 instances
# still go to the host counter (above the device budget, 2^26); phase 16
# runs obt at 4.6 Mb
ECOLI_OBT_GENOME = 3_000_000
ECOLI_SAMPLE = 2048  # candidates whose store rows phase 9 holds against the reference
# phase 11: the largest contig's identity to the simulated genome is held
# equal to the JAX package's (assembly_reference.json); the bar that
# tests/test_pipeline.py sets for the raw path is printed beside it, met
# or not (canu_tpu's own 11b contig misses it, ROADMAP §3(f))
TRUTH_IDENTITY = 0.999

# H100 SXM peaks at its 1.98 GHz boost clock and 700 W: 132 SMs x 64 INT32
# lanes (NVIDIA's Hopper white paper), and HBM3 at 3.35 TB/s
INT32_OPS_S = 132 * 64 * 1.98e9
HBM_BYTES_S = 3.35e12

# The least 32-bit integer operations of the kernels' work, the bound's
# count: a two-input operation, a not, a funnel shift, a popcount, a byte
# extract, a conditional move and a fused add-min (Hopper's DPX
# __viaddmin_s32, min(x + y, z)) count one each; loads and stores none.
# K1 (the Myers row of ops.myers._myers_row):
K1_ROW_OPS = 95  # each live row: A char 1, Eq word select 4, the 4-word
#   column update 4 x 16 (edlib's block update; the carries between words
#   ride in 2 funnel shifts a word), sf + 1 1, b_len-in-window test 2,
#   band-centre capture 23 (4 popcounts, 4 add/sub, 1 + 1 for jc and the
#   extent, 2 clamps, 2 multiplies, 3 compares, 2 ands, 4 moves)
K1_SHIFT_OPS = 34  # each row that shifts the band: sf 4, one funnel shift
#   for each of the 24 chained words (VP, VN, 16 Peq), the entering char 5
#   (extract 1, its 4 one-hot bits), o + 1 1
K1_BX_OPS = 21  # each live row with b_len inside the window: the prefix
#   score up to b_len (word index 1, mask 3, word select 2, 2 ands, 2
#   popcounts, 2 add/sub, the whole words below it 5) and the capture
#   (compare 1, 3 moves)
# K2/K3 (the INF-walled row of ops.align.banded_extend_plain):
INF_CELL_OPS = 4  # each band cell up to b_len of a live row: mismatch 1,
#   diagonal + it 1, m = min(up + 1, that) 1 add-min, the closure D =
#   min(left + 1, m) 1 add-min
INF_ROW_OPS = 8  # each live row: its shift 1, b_len-in-band test 2,
#   capture compare 1 and 3 moves, the a_len test 1
# K4 (the vote engine's DP, ops.trace.align_positions_lean_plain's rows),
# each window cell at j <= e_len of a live row (rows 0..t_len):
VDP_FWD_CELL_OPS = 13  # forward: mismatch 1, the diagonal's cost select
#   1, up + 1 - x and diagonal + cost - x 2, their min 1, the closure min 1,
#   + x 1, the INF16 cap 1, the row mask 1; the row minimum 1, and the uint8
#   normalization's subtract 1, clamp 1, INF16 select 1
VDP_BWD_CELL_OPS = 19  # backward: mismatch 1, cost select 1, the two adds
#   2, their min 1, the INF16 cap 1, the closure min 1, - x 1, the cap 1, the
#   keep or boundary select 1; the combine: F's key (the 255 test 1, Fm + Fu
#   1, * Ww + x 1 multiply-add, the BAD select 1), G's key (test 1, * Ww 1,
#   select 1), their sum 1, the row's min 1
# K5 (the MinHash sketch, ops.minhash._sketch_kernel_plain's windows):
SKETCH_HASH_OPS = 10  # each kept (window, slot): the seed xor 1, mix32's
#   three shift-xors 6 and two multiplies 2, the min 1
SKETCH_KEY_OPS = 8  # each window at k <= 16: the rolling forward and
#   reverse k-mers (shift, or, mask) 6, the canonical min 1, the on-read test 1
SKETCH_KEY2_OPS = 35  # each window at 16 < k <= 32: the two-lane roll 12,
#   the 64-bit canonical min 3, the fold's two mix32 16 and its xor 1, the
#   move off UINT32_MAX 2, the on-read test 1
SKETCH_PROBE_OPS = 3  # each probe of the frequent-mer binary search:
#   compare, select, halve; ceil(log2 F) probes and the equality test a window
# K6 (the block matcher, ops.minhash._match_kernel_plain):
MATCH_SLOT_OPS = 2  # each (cell, slot) needed, with SA's slot not
#   UINT32_MAX: the compare 1, the add 1
MATCH_CELL_OPS = 2  # each cell needed: the threshold test 1, the row's count 1
# K7 (verify's anchor-and-inputs step, ops.align._verify_pre_plain's work):
VERIFY_PRE_OPS = 1  # each compare of a pair's three sorts, n log2 n for n
#   entries (the join of both reads' valid syncmers, the median of the
#   hits of the pair's orientation, the posA sort of the inliers), and each
#   element written (the base rows, the centres, the lengths, the pair's
#   five outputs)
# K8 (the syncmer read index, ops.minimizers._syncmer_kernel_plain's work):
SYNCMER_OPS = 16  # each s-mer on the read: the rolling forward and reverse
#   s-mers 6, the canonical min 1, the on-read test 1, mix32 8; besides it
#   each k-mer position on the read k - s window compares, the middle
#   compare and the on-read test; each selected position its key
#   (SKETCH_KEY_OPS, or SKETCH_KEY2_OPS at k > 16) and its mix32 8; the
#   sort of the selected keys n log2 n compares; each element written 1
# K10 (the Myers band schedule and row-0 state, ops.myers._schedule,
# _shift_bits, _myers_init and _carry_pack):
K10_ROW_OPS = 14  # each scheduled row, its centre read as a row: the target's
#   clip 3, the running max 1, t - i 1, the running min 1, lo 1, the suffix max
#   1, hi 1, (lo + hi) >> 1 2, the cap at t0 + i 2, the shift bit's compare 1
K10_GRID_ROW_OPS = 7  # each scheduled row, its centre on the 16-row grid (its
#   unit's t is one): t - i 1, the min with the unit's entering min 1, the max
#   with the max after it 1, their sum 1 and halving 1 (o = d + i), the cap at
#   t0 1, the shift bit's compare 1
K10_GRID_UNIT_OPS = 8  # each 16-row unit of the grid: the target's clip 3, the
#   running max 1, the unit's min and max of t - i (its last and first row) 4
K10_EXT_OPS = 4 * 128 + 43  # each extension: a compare a (Peq base, char), a plane each
# K11 (the end pick, ops.myers._carry_unpack and _myers_finish):
K11_COL_OPS = 6  # each of the A-exhausted row's 128 columns: two bit extracts,
#   the score's add, the column test, the minimum's compare and select
K11_EXT_OPS = 12  # each extension: the pick (compare, 3 selects), two clamps, its sums
# K12 (stage C's pair statistics, ops.minhash._pair_stats_kernel's work):
PAIR_POS_OPS = 12  # each on-read k-mer position besides its key (SKETCH_KEY_OPS or
#   SKETCH_KEY2_OPS): mix32 8, the slot's mask 1, its compare-and-swap 1, the side's
#   max or min 1, 2 pos + strand 1
PAIR_HIT_OPS = 40  # each hit: the vote 2, and in each of its passes (the count and
#   range, up to 4 selects a median, the inliers' pass) the diagonal 3 and its
#   tests 2; besides each hit's frequent-table probes (SKETCH_PROBE_OPS each)
# K9 (the vote fold, ops.votepile._fold_chunk's work), for its bound:
FOLD_ROW_OPS = 25  # each (job, row): the row's step, the live and active
#   tests 4, three character gathers 3, four vote masks 8, the deletion run
#   (new-run test, prefix count, run end, total, clamp) 6, the code's
#   packing 4; and each (job, template column) its 15 channels 1 each


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def frequent_digest(path: str) -> str:
    import numpy as np

    h = hashlib.sha256()
    with np.load(path) as z:
        for n in ("kmers", "fraction", "threshold", "total", "k"):
            h.update(np.ascontiguousarray(z[n]).tobytes())
    return h.hexdigest()


def bench_reads(error_rate: float = 0.10, seed: int = 43):
    """bench.py's read set; error_rate=0.03, seed=44 gives the corrected
    read set of the obt/utg drives."""
    from canu_tpu_torch.sim.simulate import random_genome, simulate_reads

    g = random_genome(BENCH_GENOME, seed=42)
    rs, _ = simulate_reads(g, coverage=12, mean_len=3500, min_len=1500, max_len=7800,
                           error_rate=error_rate, seed=seed)
    return rs


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps runs (after one warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def once_ms(fn):
    """(fn()'s result, its device milliseconds in one run by CUDA events)."""
    import torch

    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


def compare(name: str, ref, got) -> int:
    """Assert the outputs (six of K1, three of K2/K3) bit-equal; returns
    the max |difference| (0)."""
    import torch

    err = 0
    check(len(ref) == len(got), f"{name}: {len(got)} outputs, expected {len(ref)}")
    for field, r, g in zip(("edits", "a_used", "b_used", "p_edits", "p_a", "p_b"), ref, got):
        d = int((r.to(torch.int64) - g.to(torch.int64)).abs().max()) if r.numel() else 0
        check(d == 0, f"{name}: kernel and plain loop differ in {field} (max |diff| {d})")
        err = max(err, d)
    return err


def kernel_cases(dev):
    """K1's edge cases (tests/torch_cases.py, as the kernel tests use
    them): {name: (args on dev, n_rows, keyword arguments)}."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_cases import myers_edge_cases

    return {name: ([torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in args], n, kw)
            for name, (args, n, kw) in myers_edge_cases().items()}


def plain_row_ops() -> dict:
    """Operations per live row and lane of the plain loops' rows (a second
    figure beside the bounds' least counts; not used by them), counted on
    the CPU: every elementwise torch operation of the row on one lane counts
    its elements (an op on the 4 band words counts 4, one on a band of
    cells counts the band), a popcount counts one, and the & 0xFFFFFFFF
    masks and int64 wrap helpers that only emulate 32-bit arithmetic count
    none; views, casts, concatenations and constants are free.  The Myers
    row is ops.myers._myers_segment's per-row work (the row plus its
    entering-char gather); the INF-walled row is banded_extend_plain's,
    the difference between 3 and 2 rows.  Returns {"K1": ops,
    ("K2", band): ops, ...}, ops per live row and lane."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    from canu_tpu_torch.ops import align as AL
    from canu_tpu_torch.ops import myers as MY

    free = {"view", "_unsafe_view", "reshape", "expand", "transpose", "t", "unsqueeze",
            "squeeze", "slice", "select", "permute", "as_strided", "alias", "detach",
            "_to_copy", "clone", "copy_", "cat", "stack", "arange", "full", "full_like",
            "zeros", "zeros_like", "ones", "ones_like", "empty", "empty_like",
            "scalar_tensor", "lift_fresh", "lift_fresh_copy", "split", "unbind", "flip",
            "_local_scalar_dense", "fill_", "resize_"}

    def is_mask(x) -> bool:
        if isinstance(x, torch.Tensor):
            return x.numel() == 1 and int(x) == MY.MASK32
        return x == MY.MASK32

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            if name not in free and not (name.startswith("bitwise_and") and is_mask(args[1])):
                self.n += sum(t.numel() for t in tree_leaves(out) if isinstance(t, torch.Tensor))
            return out

    def count(fn) -> int:
        with Count() as c:
            fn()
        return c.n

    B, n = 8, 64
    g = torch.Generator().manual_seed(0)
    a = torch.randint(0, 4, (B, n), dtype=torch.uint8, generator=g)
    b = torch.randint(0, 4, (B, n + 1024), dtype=torch.uint8, generator=g)
    lens = torch.full((B,), n, dtype=torch.int32)
    centers = torch.arange(n + 1, dtype=torch.int32)[None].expand(B, -1).contiguous()
    s_rows, ent, o0 = MY._myers_prep(lens, centers, 128, n)
    carry = MY._myers_init(b, lens, lens, o0, 128)
    seg_ops = [0, 0]
    real = MY._wrap32, MY._popcount
    MY._wrap32, MY._popcount = (lambda x: x.to(torch.int32)), (lambda x: x & 1)
    try:
        for seg in (1, 2):
            seg_ops[seg - 1] = count(lambda: MY._myers_segment(
                carry, a, b, s_rows[:seg], ent[:seg], lens, lens, 0, 1500, 128, seg))
    finally:
        MY._wrap32, MY._popcount = real
    out = {"K1": (seg_ops[1] - seg_ops[0]) / B}
    for band in (256, 1024):
        r2, r3 = (count(lambda: AL.banded_extend_plain(a, lens, b, lens, centers, band, r))
                  for r in (2, 3))
        out["INF", band] = (r3 - r2) / B
    return out


def bound(ops: float, nbytes: float) -> dict:
    """The least time of a kernel's work on the card: the larger of its
    operations over the 32-bit integer rate and its bytes over the memory
    rate (INT32_OPS_S, HBM_BYTES_S)."""
    t_ops, t_bytes = ops / INT32_OPS_S, nbytes / HBM_BYTES_S
    return {"ops": ops, "bytes": nbytes, "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def k1_call(call):
    """A captured ops.myers._rows_kernel call as kernel K1's inputs, and
    each extension's live rows (one K1 launch of the stage)."""
    import torch

    (planes, a, b, s_bits, a_len, b_len, cap_q, n_run), _ = call
    args = (planes, a, s_bits, b, a_len, b_len, n_run, cap_q)
    live = torch.clamp(a_len.to(torch.int64), 0, n_run)
    return args, live


def k1_lanes(launch, lo: int, hi: int):
    """A K1 launch's inputs and live rows cut to extensions lo:hi: the
    launch a smaller group of the same chunks makes (its lanes stop at
    their own a_len, whatever the launch's n_run)."""
    (planes, a, s_bits, b, a_len, b_len, n_run, cap_q), live = launch
    return ((planes[:, lo:hi].contiguous(), a[lo:hi], s_bits[:, lo:hi].contiguous(), b[lo:hi],
             a_len[lo:hi], b_len[lo:hi], n_run, cap_q), live[lo:hi])


def k1_work(args, live) -> dict:
    """What one K1 launch's data needs: live rows (each extension's rows
    1..min(a_len, n_run)), the live rows that shift the band, and the live
    rows with b_len inside the 128-column window, from o(i) = o0 + the
    shifts of rows 1..i."""
    import torch

    from canu_tpu_torch.ops import myers as MY

    planes, _, s_bits, _, _, b_len, n_run, _ = args
    dev = planes.device
    p_o = (2 + 4) * MY.NW + 1  # the carried window start o, after VP, VN, Peq and sf
    sh = torch.arange(MY.WORD, dtype=torch.int64, device=dev)
    rows = torch.arange(1, n_run + 1, device=dev)[None]
    shifts = bx = 0
    for lo in range(0, planes.shape[1], 2048):
        hi = min(planes.shape[1], lo + 2048)
        w = s_bits[:, lo:hi].T.to(torch.int64)
        on = rows <= live[lo:hi, None]
        bits = ((w[:, :, None] >> sh) & 1).reshape(hi - lo, -1)[:, :n_run] * on
        o = planes[p_o, lo:hi, None].to(torch.int64) + torch.cumsum(bits, dim=1)
        wb = b_len[lo:hi, None].to(torch.int64) - o
        shifts += int(bits.sum())
        bx += int(((wb >= 0) & (wb < MY.NW * MY.WORD) & on).sum())
    return {"live_rows": int(live.sum()), "shift_rows": shifts, "bx_rows": bx}


def k1_bound(args, live, pick: bool = True) -> dict:
    """K1's bound on one launch: K1_ROW_OPS a live row, K1_SHIFT_OPS a
    shifted row, K1_BX_OPS a row with b_len in the window and, with the end
    pick (the main path's launch), K11's operations an extension; bytes =
    the carry in, the carry or (pick) the six results out, a_len and
    b_len, each live row's A char and shift bit (whole 32-bit words), and
    each shift's entering B char."""
    wk = k1_work(args, live)
    planes = args[0]
    B = planes.shape[1]
    out_bytes = 6 * 4 if pick else 4 * planes.shape[0]
    nbytes = B * (4 * planes.shape[0] + out_bytes + 8) + wk["live_rows"] \
        + 4 * int(((live + 31) // 32).sum()) + wk["shift_rows"]
    ops = (K1_ROW_OPS * wk["live_rows"] + K1_SHIFT_OPS * wk["shift_rows"]
           + K1_BX_OPS * wk["bx_rows"] + (K11_COL_OPS * 128 + K11_EXT_OPS) * B * pick)
    return {**bound(ops, nbytes), **wk}


def k1_held_to_plain(name: str, args, seg: int = 4096):
    """One K1 launch held to the plain rows, every one of them: K1 run on
    the launch's inputs to each seg-th row gives its carry there, the
    plain rows of every segment run at once from K1's carry at its start
    (torch_cases.k1_rows_plain), and each segment's end must equal K1's
    carry at the next start, the last the launch's own output; then the
    two finishes (edits, a_used, b_used, the partial captures), and K1's
    own end pick (the launch as the main path makes it) against them.
    Returns (max |diff| (0), the plain rows' ms by CUDA events, the
    segments)."""
    import torch

    from canu_tpu_torch.ops import myers as MY
    from canu_tpu_torch.ops.kernels import myers_cuda as K1

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_cases import k1_rows_plain

    planes, a, s_bits, b, a_len, b_len, n_run, cap_q = args
    T = -(-n_run // seg)
    starts = [planes] + [K1.myers_rows_cuda(planes, a, s_bits[: t * seg // MY.WORD].contiguous(),
                                            b, a_len, b_len, t * seg, cap_q) for t in range(1, T)]
    ends = starts[1:] + [K1.myers_rows_cuda(*args)]
    got, plain_ms = once_ms(lambda: k1_rows_plain(starts, a, s_bits, b, a_len, b_len, n_run,
                                                  cap_q, seg))
    err = 0
    for t in range(T):
        d = int((got[:, t].to(torch.int64) - ends[t].to(torch.int64)).abs().max())
        check(d == 0, f"{name}: K1's carry after row {min((t + 1) * seg, n_run)} differs from "
              f"the plain rows' (max |diff| {d})")
        err = max(err, d)

    def finish(p):
        return MY._myers_finish(MY._carry_unpack(p), a_len, b_len, MY.NW * MY.WORD)

    ref = finish(got[:, -1])
    err = max(err, compare(name, ref, finish(ends[-1])),
              compare(f"{name} (K1 with the end pick)", ref,
                      K1.myers_rows_cuda(*args, pick=True)))
    return err, plain_ms, T


def myers_ends_inputs(args, n_rows: int, kw: dict):
    """banded_extend_myers's arguments as _extend hands them to kernels K10
    and K1: (a, a_len, b, b_len, centers, scheduled rows, n_run, cap_q,
    the centres' stride, the rows they cover)."""
    import torch

    from canu_tpu_torch.ops import myers as MY

    a, a_len, b, b_len, centers = args
    segment = kw.get("segment", MY.SEGMENT)
    seg = min(segment, n_rows) if n_rows else segment
    n_seg = max(1, -(-n_rows // seg))
    max_rows = kw.get("max_rows")
    run_segs = n_seg if max_rows is None else max(1, min(n_seg, -(-int(max_rows) // seg)))
    n_run = run_segs * seg
    if a.shape[1] < n_run:
        a = torch.nn.functional.pad(a, (0, n_run - a.shape[1]))
    stride = kw.get("center_stride", 1)
    return (a.contiguous(), a_len.to(torch.int32).contiguous(), b.contiguous(),
            b_len.to(torch.int32).contiguous(), centers.to(torch.int32), n_seg * seg, n_run,
            int(kw.get("partial_cap_q") or 0), stride,
            n_rows + 1 if stride > 1 else centers.shape[1])


def myers_ends_bound(centers, n_rows: int, n_run: int, stride: int = 1,
                     C: int | None = None) -> tuple[dict, dict, dict]:
    """K10's and K11's bounds on one call, and K10's bound had it read the
    centres as rows.  K10 reads each extension's centres once (the grid's
    values of rows 0..n_rows at stride 16, the rows at stride 1), its 128
    bases at o0, a_len and b_len, and writes the shift bits and 43 planes;
    operations K10_GRID_ROW_OPS a scheduled row and K10_GRID_UNIT_OPS a
    16-row unit on the grid, K10_ROW_OPS a row as rows, K10_EXT_OPS an
    extension.  K11 reads the 16 planes the pick uses, a_len and b_len and
    writes 6 words; K11_COL_OPS a column and K11_EXT_OPS an extension."""
    B = centers.shape[0]
    C = centers.shape[1] * stride if C is None else C
    rest = 128 + 8 + 4 * -(-n_run // 32) + 4 * 43
    rows_read = min(C, n_rows + 1)
    k10_rows = bound(K10_ROW_OPS * B * (n_rows + 1) + K10_EXT_OPS * B, B * (4 * rows_read + rest))
    k10 = k10_rows
    if stride > 1:
        units = min((C - 1) // stride, n_rows // stride) + 1
        k10 = bound((K10_GRID_ROW_OPS * (n_rows + 1) + K10_GRID_UNIT_OPS * (n_rows // stride + 1)
                     + K10_EXT_OPS) * B, B * (4 * units + rest))
    k11 = bound((K11_COL_OPS * 128 + K11_EXT_OPS) * B, B * (16 * 4 + 8 + 6 * 4))
    return k10, k11, k10_rows


def held_myers_ends(name: str, args, n_rows: int, kw: dict, reps: int = 0,
                    k1_reps: int = 0) -> dict:
    """Kernels K10 and K11 on one banded_extend_myers call's inputs, bit for
    bit against their plain versions on the card: K10's shift bits and
    row-0 planes against _schedule, _shift_bits, _myers_init and
    _carry_pack on the centres as rows (expanded from their grid where the
    call hands the grid over); then K1 from K10's planes, and its end pick
    (K1 with the pick, as the main path runs it) and K11 alone on K1's
    planes against _carry_unpack and _myers_finish.  With reps, K10 and K11
    alone timed by CUDA events (mean of reps) beside their bounds (K10's
    also beside its bound had it read rows) and the plain versions' one
    run; with k1_reps, K1 with the pick against K1 then K11, by CUDA events
    (mean of k1_reps).  Returns {"err", and with reps "K10", "K11": {ms,
    plain_ms, bound, ...}}."""
    import torch

    from canu_tpu_torch.ops import myers as MY
    from canu_tpu_torch.ops.kernels import myers_cuda as K1

    a, a_len, b, b_len, centers, rows, n_run, cap_q, stride, C = myers_ends_inputs(
        args, n_rows, kw)
    rows_c = MY.expand_centers(centers, n_rows, stride) if stride > 1 else centers

    def plain10():
        o_all = MY._schedule(b_len, rows_c, 128, rows)
        return (MY._carry_pack(MY._myers_init(b, b_len, a_len, o_all[:, 0].contiguous(), 128)),
                MY._shift_bits(o_all, n_run))

    def k10():
        return K1.myers_prologue_cuda(centers, b, a_len, b_len, rows, n_run,
                                      center_stride=stride, center_rows=C)

    (p_ref, s_ref), plain10_ms = once_ms(plain10)
    planes, s_bits = k10()
    err = 0
    for what, r, g in (("row-0 planes", p_ref, planes), ("shift bits", s_ref, s_bits)):
        d = int((r.to(torch.int64) - g.to(torch.int64)).abs().max()) if r.numel() else 0
        check(d == 0, f"{name}: K10's {what} differ from the plain chain's (max |diff| {d})")
        err = max(err, d)
    del p_ref, s_ref
    fin = K1.myers_rows_cuda(planes, a, s_bits, b, a_len, b_len, n_run, cap_q)
    ref11, plain11_ms = once_ms(lambda: MY._myers_finish(MY._carry_unpack(fin), a_len, b_len,
                                                         128))
    err = max(err, compare(f"{name} (K1 with the end pick)", ref11,
                           K1.myers_rows_cuda(planes, a, s_bits, b, a_len, b_len, n_run, cap_q,
                                              pick=True)),
              compare(f"{name} (K11 alone)", ref11, K1.myers_epilogue_cuda(fin, a_len, b_len)))
    out = {"err": err}
    if reps:
        b10, b11, b10_rows = myers_ends_bound(centers, rows, n_run, stride, C)
        out["K10"] = {"ms": cuda_ms(k10, reps), "plain_ms": plain10_ms, "bound": b10,
                      "bound_rows": b10_rows, "stride": stride}
        out["K11"] = {"ms": cuda_ms(lambda: K1.myers_epilogue_cuda(fin, a_len, b_len), reps),
                      "plain_ms": plain11_ms, "bound": b11}
    if k1_reps:
        out.setdefault("K11", {})
        k1_args = (planes, a, s_bits, b, a_len, b_len, n_run, cap_q)
        out["K11"]["k1_pick_ms"] = cuda_ms(lambda: K1.myers_rows_cuda(*k1_args, pick=True),
                                           k1_reps)
        out["K11"]["k1_then_k11_ms"] = cuda_ms(
            lambda: K1.myers_epilogue_cuda(K1.myers_rows_cuda(*k1_args), a_len, b_len), k1_reps)
    return out


def myers_ends_edge_checks(dev) -> int:
    """Phase 3a: K10 and K11 bit for bit against their plain versions on
    tests/torch_cases.py's cases: each of myers_edge_cases through
    held_myers_ends (K10, then K1 with the end pick, as _extend runs them,
    and K11 alone), with its centres as rows and on their 16-row grid; K10
    alone on myers_schedule_cases (centres narrower and wider than the
    rows, a rise after n_run, lengths 0 and negative, o0 at the end of B,
    int32 limits, one row, 40,000 rows) as rows, on the grid and split
    over clusters of 2 and 8 blocks, and on myers_split_case (3 x 200,003
    rows) as the launch splits it and on one block; K11 alone on
    myers_finish_cases (ties, INF, columns cut off at b_len).  Returns the
    max |difference| (0)."""
    import numpy as np
    import torch

    from canu_tpu_torch.ops import myers as MY
    from canu_tpu_torch.ops.kernels import myers_cuda as K1

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_cases import myers_finish_cases, myers_schedule_cases, myers_split_case

    err = 0
    for name, (args, n_rows, kw) in kernel_cases(dev).items():
        err = max(err, held_myers_ends(f"3a K10/K11 edge case {name}", args, n_rows, kw)["err"])
        grid = args[4][:, ::16].contiguous()
        err = max(err, held_myers_ends(f"3a K10/K11 edge case {name} on the grid",
                                       [*args[:4], grid], n_rows,
                                       {**kw, "center_stride": 16})["err"])

    def held10(label, c, b, a_len, b_len, n_rows, n_run, **opts):
        rows_c = c
        if opts.get("center_stride", 1) > 1:
            rows_c = MY.expand_centers(c, opts["center_rows"] - 1)
        planes, s_bits = K1.myers_prologue_cuda(c, b, a_len, b_len, n_rows, n_run, **opts)
        o_all = MY._schedule(b_len, rows_c, 128, n_rows)
        ref = (MY._carry_pack(MY._myers_init(b, b_len, a_len, o_all[:, 0].contiguous(), 128)),
               MY._shift_bits(o_all, n_run))
        d = max(int((r.to(torch.int64) - g.to(torch.int64)).abs().max()) if r.numel() else 0
                for r, g in zip(ref, (planes, s_bits)))
        check(d == 0, f"3a: K10 differs from the plain chain on {label} (max |diff| {d})")
        return d

    for name, case in myers_schedule_cases().items():
        c, b, a_len, b_len = (torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in case[:4])
        n_rows, n_run = case[4:]
        for split in (None, 2, 8):
            err = max(err, held10(f"schedule case {name}, split {split}", c, b, a_len, b_len,
                                  n_rows, n_run, split=split))
        if c.shape[1] < n_rows + 1:  # the last centre repeats up to row n_rows
            c = torch.cat([c, c[:, -1:].expand(-1, n_rows + 1 - c.shape[1])], dim=1)
        grid = c[:, : n_rows + 1 : 16].contiguous()
        err = max(err, held10(f"schedule case {name} on the grid", grid, b, a_len, b_len,
                              n_rows, n_run, center_stride=16, center_rows=n_rows + 1))
    c, b, a_len, b_len, n_rows, n_run = myers_split_case()
    c, b, a_len, b_len = (torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                          for x in (c, b, a_len, b_len))
    for split in (None, 1):
        err = max(err, held10(f"the split case, split {split}", c, b, a_len, b_len, n_rows,
                              n_run, split=split),
                  held10(f"the split case on the grid, split {split}",
                         c[:, ::16].contiguous(), b, a_len, b_len, n_rows, n_run, split=split,
                         center_stride=16, center_rows=n_rows + 1))
    planes, a_len, b_len = (torch.from_numpy(x).to(dev) for x in myers_finish_cases())
    err = max(err, compare("3a K11 finish cases",
                           MY._myers_finish(MY._carry_unpack(planes), a_len, b_len, 128),
                           K1.myers_epilogue_cuda(planes, a_len, b_len)))
    log(f"[3a kernel] K10 and K1 with the end pick bit-equal to the plain chain on "
        f"{len(kernel_cases(dev))} edge cases, their centres as rows and on the 16-row grid; "
        f"K10 on {len(myers_schedule_cases())} schedule cases (rows, grid, split over 2 and 8 "
        f"blocks) and on 3 x {n_rows + 1:,} rows (split as launched and on one block, rows and "
        f"grid); K11 alone on {planes.shape[1]} end-pick cases")
    return err


def time_k1(launches, reps: int = 5):
    """K1 with CUDA events on each (inputs, live rows) launch, with the end
    pick as the main path launches it: ([ms], [bound])."""
    from canu_tpu_torch.ops.kernels import myers_cuda as K1

    ms, bounds = [], []
    for args, live in launches:
        ms.append(cuda_ms(lambda: K1.myers_rows_cuda(*args, pick=True), reps))
        bounds.append(k1_bound(args, live))
    return ms, bounds


def extend_bound(args, band: int, n_rows: int, exit_rows=None) -> dict:
    """K2/K3's bound on one call: INF_ROW_OPS a live row and INF_CELL_OPS
    a band cell up to b_len of it; bytes = each live row's A char and
    centre, the B chars up to the last live row's band end, a_len, b_len
    and the three outputs.  A live row is one of rows 1..min(a_len,
    n_rows); with exit_rows (int64[B], -1 for none), only rows up to each
    extension's exit row, after which its outputs are fixed
    (torch_cases.extend_exit_rows)."""
    import torch

    from canu_tpu_torch.ops import align as AL

    a, a_len, b, b_len, centers = args
    live = torch.clamp(a_len.to(torch.int64), 0, n_rows)
    if exit_rows is not None:
        live = torch.where(exit_rows >= 0, torch.minimum(live, exit_rows), live)
    o = AL._band_starts(centers, b_len.to(torch.int32), band, n_rows).to(torch.int64)
    b_cols = torch.clamp(torch.gather(o, 1, live[:, None])[:, 0] + band, 0, b.shape[1])
    nbytes = int(live.sum()) * 5 + 4 * a.shape[0] + int(b_cols.sum()) + 20 * a.shape[0]
    on = torch.arange(1, n_rows + 1, device=o.device)[None] <= live[:, None]
    cells = int((torch.clamp(b_len.to(torch.int64)[:, None] - o[:, 1:] + 1, 0, band) * on).sum())
    return {**bound(INF_ROW_OPS * int(live.sum()) + INF_CELL_OPS * cells, nbytes),
            "live_rows": int(live.sum()), "cells": cells}


def keep_call(args, kw):
    """A call's (args, kwargs) with its tensors copied, kept for a later
    comparison."""
    import torch

    return (tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args), dict(kw))


def dp_inputs(call):
    """A captured ops.trace.align_positions_lean call as (t, t_len, e,
    e_len, band, n_rows, ends_free), as the dispatcher hands them to K4."""
    import torch

    (t, t_len, e, e_len, band, n_rows), kw = call
    return (t.contiguous(), t_len.to(torch.int32).contiguous(), e.contiguous(),
            e_len.to(torch.int32).contiguous(), band, n_rows, bool(kw.get("ends_free", False)))


def vdp_bound(call) -> dict:
    """K4's bound on one DP call: VDP_FWD_CELL_OPS + VDP_BWD_CELL_OPS a
    window cell at j <= e_len of a live row (rows 0..min(t_len, n_rows));
    bytes = each live row's forward row (Ww bytes and its int32 minimum)
    written and read back, the template characters of the live rows, the
    evidence up to e_len, t_len and e_len, j* and the edits."""
    t, t_len, e, e_len, band, n_rows, _ = dp_inputs(call)
    return vdp_bound_of(t_len, e_len, e.shape[1], band, n_rows)


def dp_lens(args) -> tuple:
    """What vdp_bound_of needs of a DP call's (t, t_len, e, e_len, band,
    n_rows), kept without a host sync: copies of t_len and e_len, the
    evidence columns, band and n_rows."""
    return (args[1].clone(), args[3].clone(), args[2].shape[1], args[4], args[5])


def vdp_bound_of(t_len, e_len, e_cols: int, band: int, n_rows: int) -> dict:
    """vdp_bound from a DP call's t_len, e_len, evidence columns, band and
    n_rows (dp_lens)."""
    import torch

    from canu_tpu_torch.ops import trace as TT

    t_len, e_len = t_len.to(torch.int32), e_len.to(torch.int32)
    B = t_len.shape[0]
    Ww = band + TT.SMAX * TT.SROW
    A = TT._anchors(t_len, e_len, band, n_rows).to(torch.int64)
    ri = torch.arange(n_rows + 1, device=t_len.device)
    frame = torch.clamp(ri - 1, min=0) // TT.SROW
    tl = torch.clamp(t_len.to(torch.int64), 0, n_rows)
    el = e_len.to(torch.int64)
    live = ri[None] <= tl[:, None]
    cells = int((torch.clamp(el[:, None] - A[:, frame] + 1, 0, Ww) * live).sum())
    n_live = int(live.sum())
    nbytes = (2 * n_live * (Ww + 4) + int(tl.sum()) + int(torch.clamp(el, 0, e_cols).sum())
              + 8 * B + 4 * B * (n_rows + 2))
    return {**bound((VDP_FWD_CELL_OPS + VDP_BWD_CELL_OPS) * cells, nbytes),
            "live_rows": n_live, "cells": cells}


# a DP call of more jobs than this is held to the plain DP on a subset of them
HELD_JOBS = 256


def dp_subset(B: int, chunk: int, n: int = HELD_JOBS, seed: int = 11):
    """The jobs of a DP call of B jobs in chunks of `chunk` that held_dp
    runs the plain DP on: each chunk's first and last job, and seeded
    random others up to n in all (sorted)."""
    import numpy as np

    ends = sorted({x for c0 in range(0, B, chunk) for x in (c0, min(c0 + chunk, B) - 1)})
    rest = np.setdiff1d(np.arange(B), ends)
    pick = np.random.default_rng(seed).permutation(rest)[: max(0, n - len(ends))]
    return np.sort(np.concatenate([np.asarray(ends, np.int64), pick.astype(np.int64)]))


def held_dp(name: str, call, chunk: int | None = None):
    """A DP call through ops.trace.align_positions_lean (K4 on the card, one
    launch for all its jobs) and the plain version on the same inputs, j*
    and edits bit for bit: (max |diff| (0), the plain version's ms by CUDA
    events, the jobs held).  Given `chunk` and more than HELD_JOBS jobs,
    the plain version runs on dp_subset's jobs only, held against K4's rows
    of them from the full launch."""
    import torch

    from canu_tpu_torch.ops import trace as TT

    args, kw = call
    got = TT.align_positions_lean(*args, **kw)
    B = args[0].shape[0]
    idx = None
    if chunk is not None and B > HELD_JOBS:
        idx = torch.from_numpy(dp_subset(B, chunk)).to(args[0].device)
        got = tuple(g[idx] for g in got)
        args = tuple(a[idx] for a in args[:4]) + tuple(args[4:])
    ref, plain_ms = once_ms(lambda: TT.align_positions_lean_plain(*args, **kw))
    err = 0
    for field, r, g in zip(("j_star", "edits"), ref, got):
        check(r.shape == g.shape and r.dtype == g.dtype,
              f"{name}: K4's {field} is {g.dtype}{tuple(g.shape)}, the plain DP's "
              f"{r.dtype}{tuple(r.shape)}")
        d = int((r.long() - g.long()).abs().max()) if r.numel() else 0
        check(d == 0, f"{name}: K4 and the plain DP differ in {field} (max |diff| {d})")
        err = max(err, d)
    return err, plain_ms, (B if idx is None else len(idx))


def capture_calls(module, name: str, first_only: bool = False):
    """Wrap module.<name> so each call's (args, kwargs) (or the first
    call's) are kept in the returned list; the caller restores the
    original afterwards."""
    real = getattr(module, name)
    seen: list = []

    def wrapper(*args, **kw):
        if not (first_only and seen):
            seen.append((args, kw))
        return real(*args, **kw)

    setattr(module, name, wrapper)
    return real, seen


def run_pass(rs, fk, dev, step):
    """bench.py's overlap pass: sketch -> block match -> verify.  Each
    sub-stage runs as step(name, fn), which returns fn()'s result."""
    from canu_tpu_torch.ops import align as AL
    from canu_tpu_torch.ops import minhash as MH

    sk = step("sketch", lambda: MH.build_sketches(rs, k=16, n_hashes=512, frequent=fk,
                                                  block_size=128, device=dev))
    pairs = step("match", lambda: MH.find_candidates(sk, min_matches=2, block_size=1024,
                                                     device=dev))
    ov = step("verify", lambda: AL.verify_overlaps(rs, pairs, band=128, max_erate=0.35,
                                                   min_overlap=500, chunk=512, min_shared=4,
                                                   device=dev))
    return ov, pairs


def timed(walls: dict):
    """run_pass step that records each sub-stage's wall seconds."""
    import torch

    def step(name, fn):
        t = time.time()
        out = fn()
        torch.cuda.synchronize()
        walls[name] = time.time() - t
        return out

    return step


def profiled(busy: dict, tables: list):
    """run_pass step that runs each sub-stage under torch.profiler and
    records (wall s, device busy s): the sum of the CUDA kernels' time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def step(name, fn):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            t = time.time()
            out = fn()
            torch.cuda.synchronize()
            wall = time.time() - t
        ev = p.key_averages()
        dev_us = sum(e.self_device_time_total for e in ev
                     if getattr(getattr(e, "device_type", None), "name", "") == "CUDA")
        busy[name] = (wall, dev_us / 1e6)
        tables.append(f"== {name}: wall {wall:.3f} s under the profiler, device busy "
                      f"{dev_us / 1e6:.3f} s\n"
                      + ev.table(sort_by="self_device_time_total", row_limit=20))
        return out

    return step


def reset_counts() -> None:
    """Set every kernel's launch count, the plain loops', the plain DP's, the
    plain sketch's, match's, anchor step's, syncmer selection's and fold's
    CUDA counts, the vote engine's DP groups, the read index builds and the
    calls of the host k-mer counter, the hash-join and the spill build to
    0."""
    from canu_tpu_torch.ops import align as AL
    from canu_tpu_torch.ops import kmer as KM
    from canu_tpu_torch.ops import minhash as MH
    from canu_tpu_torch.ops import minimizers as MZ
    from canu_tpu_torch.ops import myers as MY
    from canu_tpu_torch.ops import trace as TT
    from canu_tpu_torch.ops import votepile as VP
    from canu_tpu_torch.ops.kernels import extend_cuda as EX
    from canu_tpu_torch.ops.kernels import minhash_cuda as MK
    from canu_tpu_torch.ops.kernels import myers_cuda as K1
    from canu_tpu_torch.ops.kernels import trace_cuda as K4
    from canu_tpu_torch.ops.kernels import verify_cuda as VC
    from canu_tpu_torch.ops.kernels import votepile_cuda as K9
    from canu_tpu_torch.stores import overlaps as OV

    K9.LAUNCHES = VP.PLAIN_CUDA_FOLDS = VP.GROUPS = 0
    K1.LAUNCHES = EX.WARP_LAUNCHES = EX.BLOCK_LAUNCHES = K4.LAUNCHES = K4.JOBS_LAUNCHED = 0
    K1.PROLOGUE_LAUNCHES = K1.EPILOGUE_LAUNCHES = K1.PICK_LAUNCHES = 0
    MK.SKETCH_LAUNCHES = MK.MATCH_LAUNCHES = MK.COMPACT_LAUNCHES = 0
    VC.PRE_LAUNCHES = VC.SYNCMER_LAUNCHES = VC.PAIR_STATS_LAUNCHES = 0
    MY.PLAIN_CUDA_SEGMENTS = MY.PLAIN_CUDA_SCHEDULES = AL.PLAIN_CUDA_ROWS = 0
    TT.PLAIN_CUDA_CALLS = 0
    MH.PLAIN_CUDA_SKETCHES = MH.PLAIN_CUDA_MATCHES = MH.PLAIN_CUDA_PAIR_STATS = 0
    AL.PLAIN_CUDA_PRE = MZ.PLAIN_CUDA_SYNCMER = MZ.INDEX_BUILDS = 0
    KM.HOST_COUNTS = MH.JOIN_CALLS = OV.SPILL_BUILDS = 0


def read_counts() -> dict:
    from canu_tpu_torch.ops import align as AL
    from canu_tpu_torch.ops import kmer as KM
    from canu_tpu_torch.ops import minhash as MH
    from canu_tpu_torch.ops import minimizers as MZ
    from canu_tpu_torch.ops import myers as MY
    from canu_tpu_torch.ops import trace as TT
    from canu_tpu_torch.ops import votepile as VP
    from canu_tpu_torch.ops.kernels import extend_cuda as EX
    from canu_tpu_torch.ops.kernels import minhash_cuda as MK
    from canu_tpu_torch.ops.kernels import myers_cuda as K1
    from canu_tpu_torch.ops.kernels import trace_cuda as K4
    from canu_tpu_torch.ops.kernels import verify_cuda as VC
    from canu_tpu_torch.ops.kernels import votepile_cuda as K9
    from canu_tpu_torch.stores import overlaps as OV

    return {"K1": K1.LAUNCHES, "K10": K1.PROLOGUE_LAUNCHES, "K11": K1.EPILOGUE_LAUNCHES,
            "K11_pick": K1.PICK_LAUNCHES,
            "K12": VC.PAIR_STATS_LAUNCHES, "K2": EX.WARP_LAUNCHES, "K3": EX.BLOCK_LAUNCHES,
            "K4": K4.LAUNCHES, "K5": MK.SKETCH_LAUNCHES, "K6": MK.MATCH_LAUNCHES,
            "K6_compact": MK.COMPACT_LAUNCHES, "K7": VC.PRE_LAUNCHES,
            "K8": VC.SYNCMER_LAUNCHES, "K9": K9.LAUNCHES, "vote_groups": VP.GROUPS,
            "plain_fold": VP.PLAIN_CUDA_FOLDS, "plain_myers_segments": MY.PLAIN_CUDA_SEGMENTS,
            "plain_schedule": MY.PLAIN_CUDA_SCHEDULES,
            "plain_pair_stats": MH.PLAIN_CUDA_PAIR_STATS,
            "plain_extend_rows": AL.PLAIN_CUDA_ROWS, "plain_dp": TT.PLAIN_CUDA_CALLS,
            "plain_sketch": MH.PLAIN_CUDA_SKETCHES, "plain_match": MH.PLAIN_CUDA_MATCHES,
            "plain_pre": AL.PLAIN_CUDA_PRE, "plain_syncmer": MZ.PLAIN_CUDA_SYNCMER,
            "index_builds": MZ.INDEX_BUILDS, "host_kmer_counts": KM.HOST_COUNTS,
            "join_calls": MH.JOIN_CALLS,
            "spill_builds": OV.SPILL_BUILDS}


def no_plain(counts: dict) -> bool:
    """No plain loop (Myers segment, INF-walled row), no plain Myers
    schedule, row-0 state or end pick, no plain DP, no plain sketch, match,
    anchor step, syncmer selection, fold or pair statistics ran on the
    card."""
    return (counts["plain_myers_segments"] == counts["plain_schedule"]
            == counts["plain_extend_rows"] == counts["plain_dp"] == counts["plain_sketch"]
            == counts["plain_match"] == counts["plain_pre"] == counts["plain_syncmer"]
            == counts["plain_fold"] == counts["plain_pair_stats"] == 0)


def check_minhash(phase: str, counts: dict, match: bool) -> None:
    """Kernel K5 sketched the phase's overlap stages; kernel K6 matched
    where the block matcher or the sharded ring ran (match), never where
    the hash-join did; each K6 call of find_candidates compacted (the
    ring's count launches do not)."""
    check(counts["K5"] > 0, f"{phase}: kernel K5 never launched during the overlap")
    if match:
        check(counts["K6"] > 0, f"{phase}: kernel K6 never launched during the overlap")
    else:
        check(counts["K6"] == 0, f"{phase}: kernel K6 launched though the hash-join matched")
    check(counts["K6_compact"] <= counts["K6"], f"{phase}: more K6 compact launches than counts")


def check_dp(phase: str, counts: dict, dp_calls: int) -> None:
    """Kernel K4 launched once per call of the vote engine's DP, which ran."""
    check(dp_calls > 0, f"{phase}: the vote engine's DP never ran")
    check(counts["K4"] == dp_calls, f"{phase}: kernel K4 launched {counts['K4']} times for "
          f"{dp_calls} DP calls")


def check_fold(phase: str, counts: dict) -> None:
    """The vote engine folded (a phase that votes): kernel K9 launched
    exactly once per DP group of pile_votes, the plain fold never on the
    card."""
    check(counts["vote_groups"] > 0, f"{phase}: the vote engine folded no DP group")
    check(counts["K9"] == counts["vote_groups"], f"{phase}: kernel K9 launched {counts['K9']} "
          f"times for {counts['vote_groups']} DP groups")
    check(counts["plain_fold"] == 0, f"{phase}: the plain fold ran on the card")


def check_store(phase: str, st, prof: dict, fdig: str, ref: dict) -> None:
    """The store is symmetric and equals the JAX package's reference entry."""
    import numpy as np

    from canu_tpu_torch.stores.overlaps import store_digest

    check(len(st) > 0, f"{phase}: empty overlap store")
    fwd = set(zip(np.asarray(st.a_id).tolist(), np.asarray(st.b_id).tolist()))
    check(fwd == {(b, a) for a, b in fwd}, f"{phase}: overlap store is not symmetric")
    sdig = store_digest(st)
    log(f"[{phase}] store rows {len(st)} (reference {ref['rows']}); candidates "
        f"{prof.get('n_candidates')} (reference {ref['n_candidates']})")
    log(f"[{phase}] store sha256 {sdig}; frequent sha256 {fdig}")
    check(fdig == ref["frequent_sha256"], f"{phase}: frequent-mer table differs from the JAX package's")
    check(prof.get("n_candidates") == ref["n_candidates"], f"{phase}: candidate count differs")
    check(len(st) == ref["rows"] and sdig == ref["store_sha256"],
          f"{phase}: overlap store differs from the JAX package's")
    log(f"[{phase}] store equals the JAX package's row for row")


def sketch_bound(words, lengths, seeds, fk, k: int) -> dict:
    """Kernel K5's bound on one block: SKETCH_HASH_OPS a kept (window,
    slot), the key (SKETCH_KEY_OPS or SKETCH_KEY2_OPS) and the frequent-mer
    search a window on the read; its bytes each input read once (the words
    as the int64 they are passed in) and the output written once."""
    import math

    import torch

    from canu_tpu_torch.ops.kmer import INVALID_KMER, extract_kmers_any

    canon, _ = extract_kmers_any(words, lengths, k)
    valid = canon != INVALID_KMER
    F, H = fk.shape[0], seeds.shape[0]
    kept = valid & (fk[torch.clamp(torch.searchsorted(fk, canon), max=F - 1)] != canon)
    n_win, n_kept = int(valid.sum()), int(kept.sum())
    key = SKETCH_KEY_OPS if k <= 16 else SKETCH_KEY2_OPS
    probes = math.ceil(math.log2(F)) if F > 1 else 0
    ops = n_kept * H * SKETCH_HASH_OPS + n_win * (key + SKETCH_PROBE_OPS * probes + 1)
    B, W = words.shape
    out = bound(ops, 8 * B * W + 4 * B + 8 * H + 8 * F + 8 * B * H)
    out.update(windows=n_win, kept=n_kept)
    return out


def match_bound(SA, SB, self_block: bool, max_out: int) -> dict:
    """Kernel K6's bound on one block pair: MATCH_SLOT_OPS a (cell, slot)
    needed with SA's slot not UINT32_MAX (a self block needs the cells i <
    j only), MATCH_CELL_OPS a cell; its bytes SA and SB read once (once for
    a self block) and the max_out-long ii, jj and c written once."""
    import torch

    Na, H = SA.shape
    Nb = SB.shape[0]
    valid = (SA != 0xFFFFFFFF).sum(dim=1).to(torch.int64)
    rows = torch.arange(Na, dtype=torch.int64, device=SA.device)
    cols = torch.clamp(Nb - 1 - rows, min=0) if self_block else torch.full_like(rows, Nb)
    ops = MATCH_SLOT_OPS * int((valid * cols).sum()) + MATCH_CELL_OPS * int(cols.sum())
    return bound(ops, 8 * Na * H + (0 if self_block else 8 * Nb * H) + 20 * max_out + 8)


def sum_bounds(bounds: list) -> dict:
    """The bound of several launches' work together."""
    return bound(sum(b["ops"] for b in bounds), sum(b["bytes"] for b in bounds))


def held_sketch(name: str, args) -> int:
    """Kernel K5 bit for bit against the plain sketch on one block's
    (words, lengths, seeds, fk, k) on the card; returns the max |difference|
    (0)."""
    import torch

    from canu_tpu_torch.ops import minhash as MH

    ref = MH._sketch_kernel_plain(*args)
    got = MH._sketch_kernel(*args)
    torch.cuda.synchronize()
    check(got.shape == ref.shape and got.dtype == ref.dtype,
          f"{name}: K5 gave {tuple(got.shape)} {got.dtype}, the plain sketch {tuple(ref.shape)}")
    d = int((got - ref).abs().max()) if ref.numel() else 0
    check(d == 0, f"{name}: kernel K5 and the plain sketch differ (max |diff| {d})")
    return d


def held_match(name: str, SA, SB, min_matches: int, self_block: bool, max_out: int) -> tuple:
    """Kernel K6 (both launches, and its count launch alone) bit for bit
    against the plain match on one block pair on the card, a pair exactly
    two launches (the count and the compact); returns (max |difference|
    (0), n_found)."""
    import torch

    from canu_tpu_torch.ops import minhash as MH
    from canu_tpu_torch.ops.kernels import minhash_cuda as MK

    ref = MH._match_kernel_plain(SA, SB, min_matches, self_block, max_out)
    l0 = (MK.MATCH_LAUNCHES, MK.COMPACT_LAUNCHES)
    got = MH._match_kernel(SA, SB, min_matches, self_block, max_out)
    l1 = (MK.MATCH_LAUNCHES, MK.COMPACT_LAUNCHES)
    cnt = (MH._slot_counts_plain(SA, SB), MH.slot_counts(SA, SB))
    check(l1 == (l0[0] + 1, l0[1] + 1) and MK.MATCH_LAUNCHES == l1[0] + 1
          and MK.COMPACT_LAUNCHES == l1[1],
          f"{name}: K6 took {l1[0] - l0[0]} count and {l1[1] - l0[1]} compact launches for a "
          f"block pair, {MK.MATCH_LAUNCHES - l1[0]} for the count alone")
    torch.cuda.synchronize()
    err = 0
    for field, r, g in zip(("ii", "jj", "c", "n_found", "cnt"), (*ref, cnt[0]), (*got, cnt[1])):
        check(g.shape == r.shape and g.dtype == r.dtype,
              f"{name}: K6's {field} is {tuple(g.shape)} {g.dtype}, the plain match's "
              f"{tuple(r.shape)} {r.dtype}")
        d = int((g.to(torch.int64) - r.to(torch.int64)).abs().max()) if r.numel() else 0
        check(d == 0, f"{name}: kernel K6 and the plain match differ in {field} (max |diff| {d})")
        err = max(err, d)
    return err, int(ref[3])


def minhash_edge_checks(dev) -> int:
    """Phase 3e's edge cases (tests/torch_cases.py SKETCH_EDGE_CASES,
    MATCH_EDGE_CASES, MATCH_PAIR_CASES): K5 and K6 bit for bit against the
    plain versions; returns the max |difference| (0)."""
    import torch

    from canu_tpu_torch.ops.hashing import u32_tensor
    from torch_cases import (MATCH_EDGE_CASES, MATCH_PAIR_CASES, SKETCH_EDGE_CASES,
                             match_edge_case, match_pair_case, sketch_edge_case)

    err = 0
    for case in SKETCH_EDGE_CASES:
        words, lengths, seeds, table, k = sketch_edge_case(*case)
        args = (u32_tensor(words, dev), torch.from_numpy(lengths).to(dev), u32_tensor(seeds, dev),
                u32_tensor(table, dev), k)
        err = max(err, held_sketch(f"3e K5 k={k} H={len(seeds)} {case[2]}", args))
    log(f"[3e kernel] K5 bit-equal to the plain sketch on {len(SKETCH_EDGE_CASES)} edge blocks "
        "(reads of 0, k-1, k, 17, 33, 55, 90, 100, 127 and 128 bases; k 16 and 22; H 1, 64, "
        "768; the sentinel table and ~3,000 frequent keys, most >= 2^31, holding every key of "
        "one read)")
    for Na, Nb, H, mm, self_block, max_out in MATCH_EDGE_CASES:
        SA, SB = (u32_tensor(x, dev) for x in match_edge_case(Na, Nb, H))
        e, n = held_match(f"3e K6 {Na} x {Nb}", SA, SA if self_block else SB, mm, self_block,
                          max_out)
        err = max(err, e)
        log(f"[3e kernel] K6 bit-equal to the plain match on {Na} x {Nb} x {H} slots "
            f"({'self' if self_block else 'cross'} block, min_matches {mm}, an empty read's "
            f"row): n_found {n}, max_out {max_out}")
    found = []
    for name in MATCH_PAIR_CASES:
        SA, SB, mm, self_block, max_out = match_pair_case(name)
        e, n = held_match(f"3e K6 {name}", u32_tensor(SA, dev), u32_tensor(SB, dev), mm,
                          self_block, max_out)
        err, found = max(err, e), found + [f"{name}: {n}"]
    log(f"[3e kernel] K6 bit-equal to the plain match on {len(MATCH_PAIR_CASES)} block pairs, "
        f"two launches each (n_found {'; '.join(found)})")
    return err


def held_minhash_calls(phase: str, sketch_calls: list, match_calls: list) -> int:
    """Phase 3e on real blocks: K5 and K6 bit for bit against the plain
    versions on captured _sketch_kernel and _match_kernel calls ((args,
    kwargs) on the card); returns the max |difference| (0)."""
    err, found = 0, []
    for i, (args, _kw) in enumerate(sketch_calls):
        err = max(err, held_sketch(f"3e {phase} sketch block {i}", args))
    for i, (args, _kw) in enumerate(match_calls):
        e, n = held_match(f"3e {phase} block pair {i}", *args)
        err, found = max(err, e), found + [n]
    log(f"[3e kernel] {phase}: K5 bit-equal to the plain sketch on {len(sketch_calls)} blocks "
        f"({', '.join(f'{a[0].shape[0]} reads x {a[0].shape[1]} words, H {a[2].shape[0]}, '
                      f'F {a[3].shape[0]}, k {a[4]}' for a, _ in sketch_calls[:2])}"
        f"{', ...' if len(sketch_calls) > 2 else ''}); K6 on {len(match_calls)} block pairs "
        f"(n_found {found})")
    return err


def minhash_timing(rs, fk, dev, card: str) -> dict:
    """Phase 5: K5 on every block of the bench pass's sketch (k=16, H=512,
    128 reads a block) and K6 on every block pair of its match (1,024 reads
    a block, min_matches 2), each by CUDA events (the mean of 5 after a
    warm-up) beside its bound and the plain version's time (one run), held
    bit for bit to it on the way; their sums are the pass's."""
    from canu_tpu_torch.ops import minhash as MH
    from canu_tpu_torch.ops.hashing import hash_seeds, u32_tensor
    from canu_tpu_torch.ops.kmer import block_tensors, length_bucketed_blocks

    seeds = u32_tensor(hash_seeds(512), dev)
    fkt = u32_tensor(MH._fk_array(fk), dev)
    sk_args = [(*block_tensors(rs, ids, W, dev), seeds, fkt, 16)
               for ids, W in length_bucketed_blocks(rs, 128)]
    err = 0
    k5 = {"ms": [], "plain_ms": [], "bounds": []}
    for a in sk_args:
        k5["ms"].append(cuda_ms(lambda a=a: MH._sketch_kernel(*a), 5))
        k5["plain_ms"].append(once_ms(lambda a=a: MH._sketch_kernel_plain(*a))[1])
        k5["bounds"].append(sketch_bound(*a))
        err = max(err, held_sketch("5 K5 bench block", a))
    sk = MH.build_sketches(rs, k=16, n_hashes=512, frequent=fk, block_size=128, device=dev)
    S = u32_tensor(sk, dev)
    N, bs, max_out = len(sk), 1024, 1 << 17
    pairs = [(S[a : a + bs], S[b : b + bs], 2, a == b, max_out)
             for a in range(0, N, bs) for b in range(a, N, bs)]
    k6 = {"ms": [], "plain_ms": [], "bounds": []}
    for a in pairs:
        k6["ms"].append(cuda_ms(lambda a=a: MH._match_kernel(*a), 5))
        k6["plain_ms"].append(once_ms(lambda a=a: MH._match_kernel_plain(*a))[1])
        k6["bounds"].append(match_bound(a[0], a[1], a[3], max_out))
        err = max(err, held_match("5 K6 bench block pair", *a)[0])
    for name, r, what in (("K5", k5, f"{len(sk_args)} blocks of the sketch"),
                          ("K6", k6, f"{len(pairs)} block pairs of the match")):
        r["bound"] = b = sum_bounds(r["bounds"])
        r["sum_ms"], r["plain_sum_ms"] = sum(r["ms"]), sum(r["plain_ms"])
        log(f"[5 timing] {card}: {name} on the {what} (CUDA events, mean of 5): "
            f"{r['sum_ms']:.3f} ms ({', '.join(f'{x:.3f}' for x in r['ms'])}); bound "
            f"{b['bound_ms']:.3f} ms ({b['ops']:.3e} operations, {b['bytes']:.3e} bytes; bound "
            f"by {b['bound_by']}; {100 * b['bound_ms'] / r['sum_ms']:.1f}% of it); plain "
            f"{r['plain_sum_ms']:.1f} ms, bit-equal")
    k5["windows"] = sum(b["windows"] for b in k5["bounds"])
    k5["kept"] = sum(b["kept"] for b in k5["bounds"])
    return {"K5": k5, "K6": k6, "err": err}


PRE_ARGS = ("index", "a_idx", "b_idx", "flipped", "k", "band", "n_rows", "orient", "chunk")
PRE_FIELDS = ("a", "a_len", "b", "b_len", "centers", "n_anchor", "flipped", "seedA", "seedB",
              "n_minor")


class KeptCalls(list):
    """The kept _verify_pre calls (by argument name), and for the bound and
    the times: .events, the CUDA events around every call (kept or not),
    .kept_at, the index into .events of each kept call, .flipped, the
    orientation K7 gave each kept call."""

    def __init__(self):
        super().__init__()
        self.events, self.kept_at, self.flipped = [], [], []


def capture_pre(every: int = 0, when=None):
    """Wrap ops.align._verify_pre so that its first call, and with every=n
    each n-th call after it, is kept by argument name (only the calls where
    when() holds, if given), and every such call is timed by CUDA events;
    returns (the original, the kept calls).  The caller restores the
    original."""
    import torch

    from canu_tpu_torch.ops import align as AL

    real = AL._verify_pre
    seen = KeptCalls()
    n = [0]

    def wrapper(*args, **kw):
        if when is not None and not when():
            return real(*args, **kw)
        keep = n[0] == 0 or (every and n[0] % every == 0)
        n[0] += 1
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = real(*args, **kw)
        ev[1].record()
        if keep:
            seen.append({"orient": False, "chunk": None, **dict(zip(PRE_ARGS, args)), **kw})
            seen.kept_at.append(len(seen.events))
            seen.flipped.append(out[2])
        seen.events.append(ev)
        return out

    AL._verify_pre = wrapper
    return real, seen


class KeptIndex(list):
    """The kept length buckets of the index builds (held_index_block's
    inputs), and .builds: each build's one K8 launch (CUDA events, its n_sel
    plane, the arrays of its bound, with keep_args its arguments) and the
    build's host seconds (host_s: packing, uploads and the launch; K8 runs
    after it returns, on the stream)."""

    def __init__(self):
        super().__init__()
        self.builds = []


def capture_syncmer(all_blocks: bool = False, keep_args: bool = False):
    """Wrap ops.minimizers.build_read_index and verify_cuda.syncmer_index so
    that each build's K8 launch is timed by CUDA events and writes an n_sel
    plane (for its bound), and the first length bucket of each build (every
    bucket, with all_blocks) is kept: the index's rows of it and the
    bucket's block inputs (words, lengths, k, pm) for the plain selection.
    Returns (the originals, the kept buckets with .builds).  The caller
    restores them with restore_syncmer."""
    import numpy as np
    import torch

    from canu_tpu_torch.ops import minimizers as MZ
    from canu_tpu_torch.ops.kernels import verify_cuda as VC
    from canu_tpu_torch.ops.kmer import block_tensors, length_bucketed_blocks

    real = (MZ.build_read_index, VC.syncmer_index)
    kept = KeptIndex()

    def launch(words, lengths, rows, wbs, min_wb, k, s, t, mker, mpos, mstr, n_sel=None):
        if n_sel is None:
            n_sel = torch.full((words.shape[0],), -1, dtype=torch.int32, device=words.device)
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        real[1](words, lengths, rows, wbs, min_wb, k, s, t, mker, mpos, mstr, n_sel)
        ev[1].record()
        b = {"events": ev, "n_sel": n_sel, "rows": rows, "wbs": wbs, "lengths": lengths,
             "k": k, "s": s, "pm": mker.shape[1], "n": int(rows.shape[0])}
        if keep_args:
            b["args"] = (words, lengths, rows, wbs, min_wb, k, s, t, mker, mpos, mstr)
        kept.builds.append(b)

    def build(readset, k=16, pm=None, block_size=128, device=None):
        n0 = len(kept.builds)
        t0 = time.perf_counter()
        idx = real[0](readset, k=k, pm=pm, block_size=block_size, device=device)
        host_s = time.perf_counter() - t0
        b = kept.builds[-1] if len(kept.builds) > n0 else None
        if b is not None:
            b["host_s"] = host_s
        blocks = list(length_bucketed_blocks(readset, block_size))
        for ids, Wb in (blocks if all_blocks else blocks[:1]):
            rows = torch.from_numpy(ids.astype(np.int64) - 1).to(idx.mker.device)
            words, lengths = block_tensors(readset, ids, Wb, idx.mker.device)
            kept.append({"planes": (idx.mker[rows].clone(), idx.mpos[rows].clone(),
                                    idx.mstr[rows].clone()),
                         "n_sel": b["n_sel"][rows].clone() if b is not None else None,
                         "block": (words, lengths, k, idx.pm)})
        return idx

    MZ.build_read_index, VC.syncmer_index = build, launch
    return real, kept


def restore_syncmer(real) -> None:
    from canu_tpu_torch.ops import minimizers as MZ
    from canu_tpu_torch.ops.kernels import verify_cuda as VC

    MZ.build_read_index, VC.syncmer_index = real


def held_pre(name: str, d: dict) -> int:
    """Kernel K7 bit for bit against the plain anchor step on a kept
    _verify_pre call, on the card; returns the max |difference| (0)."""
    import torch

    from canu_tpu_torch.ops import align as AL

    got = AL._verify_pre(**d)
    ref = AL._verify_pre_plain(**d)
    torch.cuda.synchronize()
    err = 0
    for field, r, g in zip(PRE_FIELDS, (*ref[0], *ref[1:]), (*got[0], *got[1:])):
        check(g.shape == r.shape and g.dtype == r.dtype,
              f"{name}: K7's {field} is {tuple(g.shape)} {g.dtype}, the plain step's "
              f"{tuple(r.shape)} {r.dtype}")
        dd = int((g.to(torch.int64) - r.to(torch.int64)).abs().max()) if r.numel() else 0
        check(dd == 0, f"{name}: kernel K7 and the plain anchor step differ in {field} "
              f"(max |diff| {dd})")
        err = max(err, dd)
    return err


def held_syncmer(name: str, args) -> int:
    """Kernel K8 bit for bit against the plain syncmer selection on one
    block's (words, lengths, k, pm) on the card; returns the max
    |difference| (0)."""
    import torch

    from canu_tpu_torch.ops import minimizers as MZ

    got = MZ._syncmer_kernel(*args)
    ref = MZ._syncmer_kernel_plain(*args)
    torch.cuda.synchronize()
    err = 0
    for field, r, g in zip(("mker", "mpos", "mstr", "n_sel"), ref, got):
        check(g.shape == r.shape and g.dtype == r.dtype,
              f"{name}: K8's {field} is {tuple(g.shape)} {g.dtype}, the plain selection's "
              f"{tuple(r.shape)} {r.dtype}")
        dd = int((g.to(torch.int64) - r.to(torch.int64)).abs().max()) if r.numel() else 0
        check(dd == 0, f"{name}: kernel K8 and the plain selection differ in {field} "
              f"(max |diff| {dd})")
        err = max(err, dd)
    return err


def held_index_block(name: str, kept: dict) -> int:
    """The rows a one-launch index build (K8) gave one length bucket, bit
    for bit against the plain syncmer selection on that bucket's block (and
    n_sel where the build wrote it); returns the max |difference| (0)."""
    import torch

    from canu_tpu_torch.ops import minimizers as MZ

    ref = MZ._syncmer_kernel_plain(*kept["block"])
    torch.cuda.synchronize()
    got = list(kept["planes"]) + ([kept["n_sel"]] if kept["n_sel"] is not None else [])
    err = 0
    for field, r, g in zip(("mker", "mpos", "mstr", "n_sel"), ref, got):
        check(g.shape == r.shape and g.dtype == r.dtype,
              f"{name}: K8's {field} is {tuple(g.shape)} {g.dtype}, the plain selection's "
              f"{tuple(r.shape)} {r.dtype}")
        dd = int((g.to(torch.int64) - r.to(torch.int64)).abs().max()) if r.numel() else 0
        check(dd == 0, f"{name}: kernel K8 and the plain selection differ in {field} "
              f"(max |diff| {dd})")
        err = max(err, dd)
    return err


def held_verify_calls(phase: str, pre_calls: list, sync_blocks: list) -> int:
    """Phase 3f on a run's kept calls: K7 on each kept _verify_pre group and
    K8's rows of each kept length bucket of an index build, bit for bit
    against the plain versions; returns the max |difference| (0)."""
    err = 0
    for i, d in enumerate(pre_calls):
        err = max(err, held_pre(f"3f {phase} K7 group {i}", d))
    for i, kept in enumerate(sync_blocks):
        err = max(err, held_index_block(f"3f {phase} K8 bucket {i}", kept))
    log(f"[3f kernel] {phase}: K7 bit-equal to the plain anchor step on {len(pre_calls)} groups ("
        + ", ".join(f"{d['a_idx'].shape[0]} pairs, k {d['k']}, band {d['band']}, "
                    f"{'orient' if d['orient'] else 'given flipped'}" for d in pre_calls[:2])
        + f"{', ...' if len(pre_calls) > 2 else ''}); K8's one-launch index bit-equal to the "
        f"plain selection on {len(sync_blocks)} length buckets ("
        + ", ".join(f"{b['block'][0].shape[0]} reads x {b['block'][0].shape[1]} words, k "
                    f"{b['block'][2]}, pm {b['block'][3]}" for b in sync_blocks[:2])
        + f"{', ...' if len(sync_blocks) > 2 else ''})")
    return err


def verify_edge_checks(dev) -> int:
    """Phase 3f's edge cases (tests/torch_cases.py VERIFY_PRE_EDGE_CASES,
    SYNCMER_EDGE_CASES, verify_pre_long_case): K7 and K8 bit for bit
    against the plain versions; returns the max |difference| (0)."""
    import torch

    from canu_tpu_torch.convert import read_index_from_numpy
    from canu_tpu_torch.ops.hashing import u32_tensor
    from canu_tpu_torch.ops.kernels import verify_cuda as VC

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_cases import (LONG_READ_W, SYNCMER_EDGE_CASES, VERIFY_PRE_CHUNK,
                             VERIFY_PRE_EDGE_CASES, VERIFY_PRE_ODD_CASES, VERIFY_PRE_SIZE_CHUNK,
                             bucket_reads,
                             syncmer_cut_case, syncmer_edge_case, verify_pre_edge_case,
                             verify_pre_long_case, verify_pre_size_case)

    def pre_call(case, k, band, orient, chunk):
        pl, a, b, fl, n_rows = case
        index = read_index_from_numpy(pl["words"], pl["length"], pl["mker"], pl["mpos"],
                                      pl["mstr"], pl["n_reads"], k, pl["pm"], device=dev)
        return {"index": index, "a_idx": torch.from_numpy(a).to(dev),
                "b_idx": torch.from_numpy(b).to(dev), "flipped": torch.from_numpy(fl).to(dev),
                "k": k, "band": band, "n_rows": n_rows, "orient": orient, "chunk": chunk}

    err = 0
    for k, W, band, orient in VERIFY_PRE_EDGE_CASES:
        d = pre_call(verify_pre_edge_case(k, W, band, orient), k, band, orient, VERIFY_PRE_CHUNK)
        err = max(err, held_pre(f"3f K7 edge case k={k} W={W} band {band}", d))
    for k, W, band, orient, n_rows in VERIFY_PRE_ODD_CASES:
        pl, a, b, fl, _ = verify_pre_edge_case(k, W, band, orient)
        d = pre_call((pl, a, b, fl, n_rows), k, band, orient, VERIFY_PRE_CHUNK)
        err = max(err, held_pre(f"3f K7 edge case k={k} W={W} band {band}, {n_rows} rows", d))
    long_case = verify_pre_long_case()
    for band, orient in ((128, True), (1024, False)):
        d = pre_call(long_case, 16, band, orient, 4)
        err = max(err, held_pre(f"3f K7 reads above 131,072 bases, band {band}", d))
    pl = long_case[0]
    err = max(err, held_syncmer("3f K8 reads above 131,072 bases",
                                (u32_tensor(pl["words"], dev),
                                 torch.from_numpy(pl["length"]).to(dev), 16, pl["pm"])))
    log(f"[3f kernel] K7 and K8 bit-equal to the plain versions on reads of up to "
        f"{int(pl['length'].max())} bases (W {LONG_READ_W}, n_rows {16 * LONG_READ_W}: 3 chunks "
        "of 4 pairs, band 128 with the strand vote and band 1024 with the given flips; the "
        "index block of those reads)")
    log(f"[3f kernel] K7 bit-equal to the plain anchor step on {len(VERIFY_PRE_EDGE_CASES)} edge "
        f"groups of 3 chunks of {VERIFY_PRE_CHUNK} pairs (one anchor, a tied strand vote, "
        "repeated anchor positions, duplicate keys, the padding row, a read against itself; "
        "k 16 and 22, W 64 and 96, bands 128, 256 and 1024, orient and given flipped)")
    for k, W, pm in SYNCMER_EDGE_CASES:
        words, lengths = syncmer_edge_case(k, W, pm)
        args = (u32_tensor(words, dev), torch.from_numpy(lengths).to(dev), k, pm)
        err = max(err, held_syncmer(f"3f K8 edge block k={k} W={W} pm {pm}", args))
    log(f"[3f kernel] K8 bit-equal to the plain selection on {len(SYNCMER_EDGE_CASES)} edge blocks "
        "(reads of 0, k-1, k and off-word lengths, a repeated motif, a selected k-mer whose "
        "key's mix32 is UINT32_MAX; k 16 and 22; pm above and below n_sel)")
    # K7 at its sorts' edge sizes, K8 at its cut at pm and over length
    # buckets of different widths in one launch
    size_case = verify_pre_size_case()
    for orient, band in ((True, 128), (False, 256)):
        d = pre_call(size_case, 16, band, orient, VERIFY_PRE_SIZE_CHUNK)
        err = max(err, held_pre(f"3f K7 size cases, band {band}", d))
    for k in (16, 22):
        words, lengths, pm = syncmer_cut_case(k)
        err = max(err, held_syncmer(f"3f K8 cut at pm {pm}, k={k}",
                                    (u32_tensor(words, dev), torch.from_numpy(lengths).to(dev),
                                     k, pm)))
    from canu_tpu_torch.ops import minimizers as MZ
    from canu_tpu_torch.sim import simulate as SIM
    from canu_tpu_torch.stores.readset import ReadSet

    codes = bucket_reads(SIM)
    brs = ReadSet.from_codes_list(codes, [f"r{i}" for i in range(len(codes))])
    for k in (16, 22):
        real, kept = capture_syncmer(all_blocks=True)
        try:
            l0 = VC.SYNCMER_LAUNCHES
            MZ.build_read_index(brs, k=k, block_size=4, device=dev)
            check(VC.SYNCMER_LAUNCHES == l0 + 1,
                  f"3f: an index build launched K8 {VC.SYNCMER_LAUNCHES - l0} times")
        finally:
            restore_syncmer(real)
        for i, b in enumerate(kept):
            err = max(err, held_index_block(f"3f K8 bucket read set k={k}, bucket {i}", b))
    log("[3f kernel] K7 bit-equal to the plain anchor step on joins of 1, 2, 2,048 and 4,096 "
        "valid entries, 4,096 of one key and a read with itself (Pm 2,048; the strand vote at "
        "band 128, the given flips at 256); K8 bit-equal where reads select pm - 1, pm, pm + 1 "
        "and 2 pm keys with equal keys across the cut (k 16 and 22), and its one launch for an "
        f"index of {brs.n_reads} reads in buckets of 8 to 1,024 words bit-equal to the plain "
        "selection bucket by bucket")
    return err


def pre_bound(d: dict, flipped) -> dict:
    """Kernel K7's bound on one call: VERIFY_PRE_OPS a compare of each
    pair's three sorts (the join of its reads' valid syncmers, the median
    of the hits of its orientation -- `flipped`, K7's -- and the posA sort
    of its inliers; n log2 n each) and an element written; its bytes the
    distinct index rows the pairs read, each once, the pairs' rows and
    orientation, and the outputs written once."""
    import torch

    from canu_tpu_torch.ops.kmer import INVALID_KMER
    from canu_tpu_torch.ops.kmerjoin import masked_median, pair_matches

    index, a, b, k = d["index"], d["a_idx"], d["b_idx"], d["k"]
    n, n_rows, band = a.shape[0], d["n_rows"], d["band"]
    mkA, mkB = index.mker[a], index.mker[b]
    vA, vB = mkA != INVALID_KMER, mkB != INVALID_KMER
    hit, pA, pB, agree = pair_matches(mkA, vA, index.mstr[a], index.mpos[a], mkB, vB,
                                      index.mstr[b], index.mpos[b])
    lenA, lenB = index.length[a], index.length[b]
    pBm = torch.where(flipped[:, None], lenB[:, None] - k - pB, pB)
    h2 = hit & (agree != flipped[:, None])
    diag = pA - pBm
    med = masked_median(diag, h2)
    tol = torch.clamp((torch.minimum(lenA, lenB).to(torch.float32) * 0.30).to(torch.int32),
                      min=100)
    n_in = (h2 & ((diag - med[:, None]).abs() <= tol[:, None])).sum(1).double()

    def nlogn(x):
        return float((x * torch.log2(torch.clamp(x, min=1))).sum())

    cw = n_rows // 16 + 1 if d.get("center_stride", 1) == 16 else n_rows + 1  # centres a row
    written = 2 * n * (n_rows + (n_rows + band) + cw + 2) + 5 * n
    ops = VERIFY_PRE_OPS * (nlogn((vA.sum(1) + vB.sum(1)).double()) + nlogn(h2.sum(1).double())
                            + nlogn(n_in) + written)
    rows = int(torch.unique(torch.cat([a, b])).numel())
    W, Pm = index.words.shape[1], index.mker.shape[1]
    nbytes = (rows * (8 * W + 4 + 16 * Pm) + 17 * n
              + 2 * n * (n_rows + (n_rows + band) + 4 * cw + 8) + 17 * n)
    out = bound(ops, nbytes)
    out.update(pairs=n, distinct_rows=rows)
    return out


def syncmer_bound(args, n_sel) -> dict:
    """Kernel K8's bound on one block: SYNCMER_OPS an s-mer on the read,
    k - s + 2 a k-mer position on the read, a selected position's key and
    mix32, the sort of the selected keys (n_sel, K8's, n log2 n) and an
    element written; its bytes the words (as the int64 they are passed in)
    and lengths read once and the outputs written once."""
    import torch

    from canu_tpu_torch.ops.minimizers import syncmer_params

    words, lengths, k, pm = args
    B, W = words.shape
    s, _t = syncmer_params(k)
    lens = lengths.to(torch.int64)
    n_smer = int(torch.clamp(lens - s + 1, min=0).sum())
    n_pos = int(torch.clamp(lens - k + 1, min=0).sum())
    sel = n_sel.double()
    key = SKETCH_KEY_OPS if k <= 16 else SKETCH_KEY2_OPS
    ops = (SYNCMER_OPS * n_smer + (k - s + 2) * n_pos + (key + 8) * float(sel.sum())
           + float((sel * torch.log2(torch.clamp(sel, min=1))).sum()) + (3 * pm + 1) * B)
    return bound(ops, 8 * B * W + 4 * B + 16 * B * pm + 4 * B)


def index_bound(b: dict) -> dict:
    """Kernel K8's bound on one index build's launch (capture_syncmer's
    record): syncmer_bound's count over every read at its bucket's width,
    with the n_sel the launch wrote; its bytes each read's words (int64) at
    that width, its length, row and width read once, its pm slots and n_sel
    written once."""
    import torch

    from canu_tpu_torch.ops.minimizers import syncmer_params

    k, pm, n = b["k"], b["pm"], b["n"]
    s, _t = syncmer_params(k)
    rows = b["rows"].to(torch.int64)
    lens = b["lengths"][rows].to(torch.int64)
    sel = b["n_sel"][rows].double()
    n_smer = int(torch.clamp(lens - s + 1, min=0).sum())
    n_pos = int(torch.clamp(lens - k + 1, min=0).sum())
    key = SKETCH_KEY_OPS if k <= 16 else SKETCH_KEY2_OPS
    ops = (SYNCMER_OPS * n_smer + (k - s + 2) * n_pos + (key + 8) * float(sel.sum())
           + float((sel * torch.log2(torch.clamp(sel, min=1))).sum()) + (3 * pm + 1) * n)
    return bound(ops, 8 * float(b["wbs"].to(torch.int64).sum()) + 12 * n + 16 * n * pm + 4 * n)


def verify_timing(pre_call: dict, sync_kept, card: str) -> dict:
    """Phase 5: K7 on phase 4's first verify group and K8's one launch of
    phase 4's index build by CUDA events, beside their bounds and the plain
    versions' times (one run each; the plain selection bucket by bucket)."""
    import torch

    from canu_tpu_torch.ops import align as AL
    from canu_tpu_torch.ops import minimizers as MZ
    from canu_tpu_torch.ops.kernels import verify_cuda as VC

    d = pre_call
    ms = cuda_ms(lambda: AL._verify_pre(**d), 10)
    got = AL._verify_pre(**d)
    bd = pre_bound(d, got[2])
    bd_rows = pre_bound({**d, "center_stride": 1}, got[2])
    del got
    _, plain_ms = once_ms(lambda: AL._verify_pre_plain(**d))
    n = d["a_idx"].shape[0]
    log(f"[5 timing] {card}: K7 on phase 4's first verify group ({n} pairs, "
        f"{n // (d['chunk'] or n)} chunks, {d['n_rows']} rows, band {d['band']}): {ms:.3f} ms "
        f"(mean of 10); bound {bd['bound_ms']:.3f} ms ({bd['ops']:.3e} operations, "
        f"{bd['bytes']:.3e} bytes, {bd['distinct_rows']} index rows; bound by {bd['bound_by']}; "
        f"{100 * bd['bound_ms'] / ms:.1f}% of it); the plain step chunk by chunk "
        f"{plain_ms:.1f} ms; "
        f"centres at stride {d.get('center_stride', 1)}: as rows the bound would be "
        f"{bd_rows['bound_ms']:.3f} ms ({bd_rows['bytes']:.3e} bytes, "
        f"{100 * bd_rows['bound_ms'] / ms:.1f}% of this K7's time)")
    (b,) = sync_kept.builds
    args = b["args"]
    planes = [x.clone() for x in args[8:11]]
    k8_ms = cuda_ms(lambda: VC.syncmer_index(*args[:8], *planes), 5)
    k8b = index_bound(b)
    k8_plain = sum(once_ms(lambda: MZ._syncmer_kernel_plain(*kb["block"]))[1] for kb in sync_kept)
    log(f"[5 timing] {card}: K8 on phase 4's index, one launch of {b['n']} reads in "
        f"{len(sync_kept)} length buckets: {k8_ms:.3f} ms (mean of 5; the build's own launch "
        f"{b['events'][0].elapsed_time(b['events'][1]):.3f} ms); bound {k8b['bound_ms']:.3f} ms "
        f"({k8b['ops']:.3e} operations, {k8b['bytes']:.3e} bytes; bound by {k8b['bound_by']}; "
        f"{100 * k8b['bound_ms'] / k8_ms:.1f}% of it); the plain selection bucket by bucket "
        f"{k8_plain:.1f} ms")
    res = VC.resources(d["index"].mker.shape[1], b["pm"])
    log(f"[5 timing] {card}: resources at Pm {d['index'].mker.shape[1]}: K7 {res['K7']}, K8 "
        f"{res['K8']} (cudaOccupancyMaxActiveBlocksPerMultiprocessor, cudaFuncGetAttributes)")
    return {"K7": {"ms": ms, "plain_ms": plain_ms, "bound": bd, "bound_rows": bd_rows},
            "K8": {"ms": k8_ms, "launch_ms": b["events"][0].elapsed_time(b["events"][1]),
                   "plain_ms": k8_plain, "bound": k8b, "reads": b["n"],
                   "buckets": len(sync_kept)},
            "resources": res}


def verify_kernel_split(phase: str, card: str, pre_kept, sync_kept) -> dict:
    """A drive's K7 and K8 by CUDA events (capture_pre's and
    capture_syncmer's records): K7 over every group (its pre_device_s) and
    over the kept groups beside their summed bound; K8 per index build
    beside its bound, and each build's host seconds (index_s's host part)
    beside its K8 milliseconds.  Call after a synchronize."""
    k7_all = sum(e0.elapsed_time(e1) for e0, e1 in pre_kept.events)
    k7_kept = sum(pre_kept.events[i][0].elapsed_time(pre_kept.events[i][1])
                  for i in pre_kept.kept_at)
    k7b = sum_bounds([pre_bound(d, f) for d, f in zip(pre_kept, pre_kept.flipped)])
    builds = []
    for b in sync_kept.builds:
        bd = index_bound(b)
        builds.append({"reads": b["n"], "k": b["k"], "pm": b["pm"],
                       "k8_ms": b["events"][0].elapsed_time(b["events"][1]),
                       "host_s": b.get("host_s"), "bound": bd})
    k8_ms = sum(x["k8_ms"] for x in builds)
    k8b = sum_bounds([x["bound"] for x in builds]) if builds else bound(0, 0)
    log(f"[{phase} verify] {card}: K7 {k7_all:.3f} ms over {len(pre_kept.events)} groups "
        f"(pre_device_s {k7_all / 1e3:.4f}); its {len(pre_kept)} kept groups {k7_kept:.3f} ms "
        f"against a summed bound of {k7b['bound_ms']:.3f} ms ({k7b['bytes']:.3e} bytes; "
        f"{100 * k7b['bound_ms'] / max(k7_kept, 1e-9):.1f}% of it)")
    log(f"[{phase} verify] {card}: K8 {k8_ms:.3f} ms in {len(builds)} launches, one per index "
        f"build (" + ", ".join(f"{x['reads']} reads k {x['k']}: {x['k8_ms']:.3f} ms, bound "
                               f"{x['bound']['bound_ms']:.3f} ms, the build's host part "
                               f"{x['host_s'] or 0:.3f} s" for x in builds)
        + f"); summed bound {k8b['bound_ms']:.3f} ms ({k8b['ops']:.3e} operations, "
        f"{k8b['bytes']:.3e} bytes; bound by {k8b['bound_by']}; "
        f"{100 * k8b['bound_ms'] / max(k8_ms, 1e-9):.1f}% of it)")
    return {"k7_ms": k7_all, "k7_groups": len(pre_kept.events), "k7_kept_ms": k7_kept,
            "k7_kept_bound": k7b, "k8_ms": k8_ms, "k8_bound": k8b, "builds": builds}


def verify_profiles(where):
    """Wrap ops.align.verify_overlaps so that each call's profile
    (LAST_PROFILE) is kept with where[0] at the call; returns (the
    original, the kept (where, profile) pairs).  The caller restores it."""
    from canu_tpu_torch.ops import align as AL

    real = AL.verify_overlaps
    seen: list = []

    def wrapper(*args, **kw):
        out = real(*args, **kw)
        seen.append((where[0], dict(AL.LAST_PROFILE)))
        return out

    AL.verify_overlaps = wrapper
    return real, seen


FREQUENT_TAGS = ("cor", "obt")


def frequent_drive(dev, card: str) -> dict:
    """Phase 4c: the cor and obt meryl + overlap stages on the frequent-mer
    read sets (tests/torch_cases.py frequent_reads: the bench shapes with a
    1.5 kb repeat of 24 copies, raw reads for cor and corrected ones for
    obt, each plus a palindromic chimeric read), Config()
    + genomeSize=300k + ovsMethod=spill, each in a directory of its own
    with the counts set to 0 just before and read just after.  Each frequent
    table must be non-empty; K1, K5 and K6 must have launched, the spill
    build once, no other kernel and no plain loop on the card; each stage's
    frequent table, candidates and spilled store (store_digest) equal the
    JAX package's (frequent_overlap_reference.json), and obt's store holds
    the palindromic pair's repeated rows.  Returns each stage's record, and
    the first and last sketch blocks and every block pair for phase 3e."""
    import numpy as np
    import torch

    from canu_tpu_torch.config import Config
    from canu_tpu_torch.ops import minhash as MH
    from canu_tpu_torch.pipeline import stages
    from canu_tpu_torch.pipeline.driver import make_ctx
    from canu_tpu_torch.sim import simulate
    from canu_tpu_torch.stores.overlaps import store_digest
    from canu_tpu_torch.stores.readset import ReadSet
    from torch_cases import candidates_digest, frequent_reads

    with open(os.path.join(ROOT, "canu_tpu_torch", "frequent_overlap_reference.json")) as fh:
        ref = json.load(fh)
    t_phase = time.time()
    out: dict = {"sketch_calls": [], "match_calls": []}
    for tag in FREQUENT_TAGS:
        r = ref[tag]
        t = time.time()
        rs = frequent_reads(simulate, ReadSet, tag)
        log(f"[4c frequent] {tag} read set: {rs.n_reads} reads, {rs.total_bases} bases "
            f"({r['reads']}), a 1.5 kb repeat of 24 copies and a palindromic chimeric read "
            f"(simulated in {time.time() - t:.1f} s)")
        check(rs.n_reads == r["n_reads"] and rs.total_bases == r["total_bases"],
              f"4c {tag}: the read set differs from the reference's")
        cfg = Config()
        cfg.set("genomeSize", "300k")
        cfg.set("ovsMethod", "spill")
        work = tempfile.mkdtemp(prefix=f"chip_smoke_freq_{tag}_")
        ctx = make_ctx(work, "freq", cfg)
        k = int(cfg.get(f"{tag}MerSize"))
        real_sk, sk_calls = capture_calls(MH, "_sketch_kernel")
        real_mt, mt_calls = capture_calls(MH, "_match_kernel")
        real_fc, seen = capture_results(MH, "find_candidates")
        try:
            reset_counts()
            t = time.time()
            fk = stages.meryl(ctx, tag, rs, device=dev)
            t_meryl = time.time() - t
            st = stages.overlap(ctx, tag, rs, fk, device=dev)
            torch.cuda.synchronize()
            t_stage = time.time() - t
            counts = read_counts()
        finally:
            MH._sketch_kernel, MH._match_kernel, MH.find_candidates = real_sk, real_mt, real_fc
        with open(ctx.path("freq.stage-times.jsonl")) as fh:
            sub = [json.loads(ln) for ln in fh if f'"{tag}-overlap.sub"' in ln][-1]["sub_walls_s"]
        d = os.path.join(work, stages.TAG_DIR[tag])
        fdig = frequent_digest(os.path.join(d, f"freq.ms{k}.frequent.npz"))
        check(len(seen) == 1, f"4c {tag}: the stage called find_candidates {len(seen)} times")
        pairs = seen[0]
        cdig = candidates_digest(pairs)
        ids = np.stack([np.asarray(st.a_id), np.asarray(st.b_id)], axis=1)
        repeated = int(len(ids) - len(np.unique(ids, axis=0)))
        sdig = store_digest(st)
        log(f"[4c frequent] {card}: {tag} k={k}: meryl {t_meryl:.2f} s, meryl+overlap "
            f"{t_stage:.2f} s; overlap sub-walls {sub}; launch counts {counts}")
        log(f"[4c frequent] {tag}: {fk.n} frequent mers at threshold {fk.threshold} "
            f"(reference {r['frequent_n']}), sha256 {fdig}; {len(pairs)} candidates (reference "
            f"{r['n_candidates']}), sha256 {cdig}; spilled store {len(st)} rows (reference "
            f"{r['rows']}), {repeated} rows of a repeated pair (reference {r['repeated_rows']}), "
            f"sha256 {sdig}")
        check(fk.n > 0, f"4c {tag}: the frequent-mer table is empty")
        check(fk.n == r["frequent_n"] and fdig == r["frequent_sha256"],
              f"4c {tag}: the frequent-mer table differs from the JAX package's")
        check(len(pairs) == r["n_candidates"] and cdig == r["candidates_sha256"],
              f"4c {tag}: the candidates differ from the JAX package's")
        check(len(st) == r["rows"] and sdig == r["store_sha256"],
              f"4c {tag}: the spilled store differs from the JAX package's")
        check(repeated == r["repeated_rows"] and (repeated > 0 or tag != "obt"),
              f"4c {tag}: {repeated} rows of repeated pairs (palindromic), reference "
              f"{r['repeated_rows']}")
        check(counts["spill_builds"] == 1, f"4c {tag}: the store was not built by the spill")
        check(counts["K1"] > 0, f"4c {tag}: kernel K1 never launched during the stage")
        check(counts["K2"] == counts["K3"] == counts["K4"] == 0,
              f"4c {tag}: kernel K2, K3 or K4 launched off its path")
        check(no_plain(counts), f"4c {tag}: a plain loop ran on the card during the stage")
        check_minhash(f"4c {tag}", counts, match=True)
        out[tag] = {"meryl_s": t_meryl, "stage_s": t_stage, "sub_walls_s": sub,
                    "frequent_n": fk.n, "n_candidates": len(pairs), "rows": len(st),
                    "repeated_rows": repeated, "launches": counts}
        out["sketch_calls"] += [sk_calls[0], sk_calls[-1]]
        out["match_calls"] += mt_calls
    log(f"[4c frequent] phase wall {time.time() - t_phase:.1f} s")
    out["phase_s"] = time.time() - t_phase
    return out


def drive_stage(phase: str, tag: str, band: int, rs, dev, ref: dict, kernel: str):
    """meryl + overlap for `tag` at {tag}OvlBandWidth=band on the read set
    rs, in a directory of its own, with the launch counts set to 0
    just before and read just after.  Only `kernel` may have launched and
    no plain loop may have run on the card; the store must equal `ref`.
    The read set's cached device index is dropped first, so that the run
    builds its own (K8), as a run in a process of its own does.  Returns
    (stage record, every banded_extend call's (args, kwargs), the store,
    the first _verify_pre call and index block (phase 3f))."""
    import torch

    from canu_tpu_torch.config import Config
    from canu_tpu_torch.ops import align as AL
    from canu_tpu_torch.pipeline import stages
    from canu_tpu_torch.pipeline.driver import make_ctx
    from canu_tpu_torch.stores.readset import drop_device_caches

    work = tempfile.mkdtemp(prefix=f"chip_smoke_{tag}{band}_")
    cfg = Config()
    cfg.set("genomeSize", "300k")
    cfg.set(f"{tag}OvlBandWidth", band)
    ctx = make_ctx(work, "bench", cfg)
    k = int(cfg.get(f"{tag}MerSize"))
    real_extend, calls = capture_calls(AL, "banded_extend")
    real_pre, pre_calls = capture_pre()
    real_sy, sy_blocks = capture_syncmer()
    try:
        drop_device_caches()
        reset_counts()
        t = time.time()
        fk = stages.meryl(ctx, tag, rs, device=dev)
        t_meryl = time.time() - t
        st = stages.overlap(ctx, tag, rs, fk, device=dev)
        torch.cuda.synchronize()
        t_stage = time.time() - t
        counts = read_counts()
    finally:
        AL.banded_extend, AL._verify_pre = real_extend, real_pre
        restore_syncmer(real_sy)
    prof = dict(AL.LAST_PROFILE)
    with open(ctx.path("bench.stage-times.jsonl")) as fh:
        sub = [json.loads(ln) for ln in fh if f'"{tag}-overlap.sub"' in ln][-1]["sub_walls_s"]
    log(f"[{phase}] {tag} k={k} band {band}: meryl {t_meryl:.2f} s; meryl+overlap "
        f"{t_stage:.2f} s; overlap sub-walls {sub}; verify profile {prof}")
    log(f"[{phase}] launch counts {counts}")
    for name in ("K1", "K2", "K3", "K4"):
        if name == kernel:
            check(counts[name] > 0, f"{phase}: kernel {name} never launched during the stage")
        else:
            check(counts[name] == 0, f"{phase}: kernel {name} launched off its path")
    check(no_plain(counts),
          f"{phase}: a plain loop ran on the card during the stage")
    check_minhash(phase, counts, match=True)
    fdig = frequent_digest(os.path.join(work, stages.TAG_DIR[tag], f"bench.ms{k}.frequent.npz"))
    check_store(phase, st, prof, fdig, ref)
    rec = {"meryl_s": t_meryl, "stage_s": t_stage, "sub_walls_s": sub, "verify_profile": prof,
           "rows": len(st), "launches": counts}
    return rec, calls, st, (pre_calls, sy_blocks)


def extend_edge_cases(band: int, dev):
    """The INF-walled extension's edge cases (tests/torch_cases.py, as the
    kernel tests use them): canu_tpu's x8 test pairs plus INF-range
    failures, o(0) > 0, empty A/B."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_cases import edge_cases as cases

    args, n_rows = cases(band)
    return [torch.from_numpy(x).to(dev) for x in args], n_rows


def extend_kernel(band: int):
    """(name, wrapper) of the kernel that ops.align.banded_extend launches
    at this band: K2 up to 512, K3 above."""
    from canu_tpu_torch.ops.kernels import extend_cuda as EX

    if band in EX.WARP_BANDS:
        return "K2", EX.banded_extend_warp
    return "K3", EX.banded_extend_block


def check_extend_kernels(name: str, args, band: int, n_rows: int) -> int:
    """The band's kernel (K2 or K3) against the plain loop, bit for bit."""
    from canu_tpu_torch.ops import align as AL

    kname, fn = extend_kernel(band)
    return compare(f"{name} {kname}", AL.banded_extend_plain(*args, band, n_rows),
                   fn(*args, band, n_rows))


def extend_drive(name: str, calls, card: str, reps: int = 3) -> dict:
    """The band's kernel on every banded_extend call of one drive.

    Runs torch_cases.extend_exit_rows (banded_extend_plain's recurrence,
    every extension of the drive at once) for each extension's exit row
    and outputs; checks that no live row's smallest cell fell below the
    row before's, that the captures at the exit row are the outputs, and
    that the kernel gives those outputs on every call.  Then times each
    call with CUDA events beside its bound under both row counts (every
    live row; rows up to the exit row), the drive's sums, the first
    call's lanes 0..OLD_EXTEND_LANES (the shape of one call per chunk),
    and the whole first call against banded_extend_plain."""
    import torch

    from canu_tpu_torch.ops import align as AL

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_cases import extend_exit_rows

    band, n_rows = calls[0][0][5:7]
    check(all(c[0][5:7] == (band, n_rows) for c in calls), f"{name}: calls differ in band or rows")
    kname, fn = extend_kernel(band)
    sizes = [c[0][0].shape[0] for c in calls]
    t = time.time()
    cat = [torch.cat([c[0][k] for c in calls]) for k in range(5)]
    exit_rows, at_exit, final, fell = extend_exit_rows(*cat, band, n_rows)
    del cat
    check(not bool(fell.any()), f"{name}: a live row's smallest cell fell below the row before's")
    ex = exit_rows >= 0
    for f, x, y in zip(("edits", "a_used", "b_used"), at_exit, final):
        check(torch.equal(x[ex], y[ex]), f"{name}: {f} at the exit row differs from the end's")
    live = torch.clamp(torch.cat([c[0][1] for c in calls]).to(torch.int64), 0, n_rows)
    after = int((live - exit_rows)[ex].sum())
    log(f"[8 exit] {name}: {int(ex.sum())} of {len(ex)} extensions have an exit row; the rows "
        f"after it are {after} of {int(live.sum())} live rows ({100 * after / max(1, int(live.sum())):.1f}%)"
        f"; outputs at the exit row equal the end's; plain recurrence {time.time() - t:.1f} s")
    per_call, lo = [], 0
    for ci, (call, B) in enumerate(zip(calls, sizes)):
        args = call[0][:5]
        sl = slice(lo, lo + B)
        lo += B
        compare(f"{name} call {ci + 1} {kname}", tuple(f[sl] for f in final),
                fn(*args, band, n_rows))
        ms = cuda_ms(lambda: fn(*args, band, n_rows), reps)
        full, bx = extend_bound(args, band, n_rows), extend_bound(args, band, n_rows, exit_rows[sl])
        per_call.append({"B": B, "ms": ms, "bound": full, "bound_exit": bx})
        log(f"[8 timing] {card}: {name} {kname} call {ci + 1}/{len(calls)}: {B} extensions: "
            f"{ms:.3f} ms; bound {full['bound_ms']:.4f} ms every live row "
            f"({100 * full['bound_ms'] / ms:.1f}%), {bx['bound_ms']:.4f} ms to the exit rows "
            f"({100 * bx['bound_ms'] / ms:.1f}%)")
    tot = sum(c["ms"] for c in per_call)
    tb = sum(c["bound"]["bound_ms"] for c in per_call)
    tx = sum(c["bound_exit"]["bound_ms"] for c in per_call)
    log(f"[8 timing] {card}: {kname} ms per {name} drive ({len(calls)} launches): {tot:.3f} ms; "
        f"bound {tb:.4f} ms every live row ({100 * tb / tot:.1f}%), {tx:.4f} ms to the exit "
        f"rows ({100 * tx / tot:.1f}%)")
    # the first call's lanes at the shape of one call per chunk
    args0 = calls[0][0][:5]
    n_old = min(OLD_EXTEND_LANES, sizes[0])
    old = tuple(x[:n_old] for x in args0)
    old_ms = cuda_ms(lambda: fn(*old, band, n_rows), 10)
    ob = extend_bound(old, band, n_rows)
    obx = extend_bound(old, band, n_rows, exit_rows[:n_old])
    log(f"[8 timing] {card}: {name} {kname} on the first call's first {n_old} extensions: "
        f"{old_ms:.3f} ms; bound {ob['bound_ms']:.4f} ms every live row "
        f"({100 * ob['bound_ms'] / old_ms:.1f}%), {obx['bound_ms']:.4f} ms to the exit rows "
        f"({100 * obx['bound_ms'] / old_ms:.1f}%)")
    ref, plain_ms = once_ms(lambda: AL.banded_extend_plain(*args0, band, n_rows))
    err = compare(f"{name} first call {kname}", ref, fn(*args0, band, n_rows))
    first = per_call[0]
    log(f"[8 timing] {card}: {name} first call ({sizes[0]} extensions, band {band}, "
        f"{min(n_rows, int(args0[1].max()))} rows): {kname} {first['ms']:.3f} ms vs plain loop "
        f"{plain_ms:.1f} ms, bit-equal")
    return {"kernel": kname, "band": band, "n_rows": n_rows, "calls": per_call,
            "ms_per_drive": tot, "bound_ms_per_drive": tb, "bound_exit_ms_per_drive": tx,
            "exit_rows": int(ex.sum()), "rows_after_exit": after, "live_rows": int(live.sum()),
            "old_shape": {"B": n_old, "ms": old_ms, "bound": ob, "bound_exit": obx},
            "first_ms": first["ms"], "plain_ms": plain_ms, "err": err,
            "first_bound_exit": first["bound_exit"]}


PLACED_KS = ((16, True), (22, False))  # stage C's k, and whether it takes the frequent table


def pair_stats_bound(args) -> dict:
    """K12's bound on one chunk (ops.minhash._pair_stats_kernel's arguments):
    bytes = the words each pair's reads need (ceil(len / 16) int64 words a
    read, as stored), the lengths, the frequent table and the seven
    outputs; operations = each on-read k-mer position's key
    (SKETCH_KEY_OPS, or SKETCH_KEY2_OPS at k > 16) and PAIR_POS_OPS, each
    hit PAIR_HIT_OPS and its frequent-table probes, the hits counted by
    the plain join (ops.kmerjoin.pair_matches) on this chunk."""
    import math

    import torch

    from canu_tpu_torch.ops import kmer as KM
    from canu_tpu_torch.ops.kmerjoin import pair_matches

    wA, lA, wB, lB, fk, k = args
    canonA, strandA = KM.extract_kmers_any(wA, lA, k)
    canonB, strandB = KM.extract_kmers_any(wB, lB, k)
    idx = torch.clamp(torch.searchsorted(fk, canonB), max=fk.shape[0] - 1)
    validB = (canonB != KM.INVALID_KMER) & (fk[idx] != canonB)
    pos = torch.arange(canonA.shape[1], dtype=torch.int32, device=wA.device)
    pos = pos[None, :].expand(canonA.shape)
    hits = int(pair_matches(canonA, canonA != KM.INVALID_KMER, strandA, pos, canonB, validB,
                            strandB, pos)[0].sum())
    lens = torch.cat([lA, lB]).to(torch.int64)
    positions = int(torch.clamp(lens - k + 1, min=0).sum())
    words = int(((lens + 15) // 16).sum())
    probe = SKETCH_PROBE_OPS * (math.ceil(math.log2(max(2, fk.shape[0]))) + 1)
    key = SKETCH_KEY_OPS if k <= 16 else SKETCH_KEY2_OPS
    C = wA.shape[0]
    return {**bound((key + PAIR_POS_OPS) * positions + (PAIR_HIT_OPS + probe) * hits,
                    8 * words + 8 * C + 8 * fk.shape[0] + 7 * 4 * C),
            "positions": positions, "hits": hits}


def pair_stats_design(lenA, lenB, k: int, hits: int, n_fk: int) -> dict:
    """K12's own count of its work on pairs of reads of lengths lenA, lenB
    (numpy) with `hits` hits in all, from its plan (verify_cuda
    .pair_stats_plan): rounds a pair; k-mers built (both reads' every round);
    table inserts (A's positions) and probes (B's), each in one round;
    slots cleared (every slot once, then each round's scan clears what it
    reads); shared-memory bytes (12 a slot cleared or scanned, 8 an insert's
    compare-and-swap and max, 8 a probe's read and min, 8 a hit written and
    read in each of its 6 passes); its operations (the key and PAIR_POS_OPS
    a k-mer built, 3 a slot scanned, each hit's PAIR_HIT_OPS and probes) and
    the bound they set."""
    import math

    import numpy as np

    from canu_tpu_torch.ops.kernels import verify_cuda as VC

    pl = VC.pair_stats_plan(lenA, lenB, k)
    R, S, nA, nB = pl["rounds"], pl["slots"], pl["nA"], pl["nB"]
    kmers = int((R * (nA + nB)).sum())
    slots = int((S * (1 + R)).sum())
    inserts, probes = int(nA[R > 0].sum()), int(nB[R > 0].sum())
    smem = 12 * slots + 8 * (inserts + probes) + 8 * 7 * hits
    key = SKETCH_KEY_OPS if k <= 16 else SKETCH_KEY2_OPS
    probe = SKETCH_PROBE_OPS * (math.ceil(math.log2(max(2, n_fk))) + 1)
    ops = (key + PAIR_POS_OPS) * kmers + 3 * slots + (PAIR_HIT_OPS + probe) * hits
    n = int((R > 0).sum())
    return {"pairs": len(R), "pairs_with_rounds": n, "rounds": int(R.sum()),
            "rounds_max": int(R.max()) if len(R) else 0,
            "inserts_a_round": inserts / max(1, int(R.sum())),
            "probes_a_round": probes / max(1, int(R.sum())), "kmers": kmers,
            "inserts": inserts, "probes": probes, "slots": slots, "smem_bytes": smem,
            "room": int(pl["room"].sum()), **{f"design_{n_}": v for n_, v in bound(
                ops, smem).items()}}


def placed_pairs(dev, fk):
    """Phase 4d's inputs: the bench read set and its cor candidates (the
    cor stage's sketch preset and block matcher on the card, phase 4's
    frequent table), held to placed_overlap_reference.json's."""
    from canu_tpu_torch.config import Config
    from canu_tpu_torch.ops import minhash as MH

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_cases import candidates_digest, readset_digest

    with open(os.path.join(ROOT, "canu_tpu_torch", "placed_overlap_reference.json")) as fh:
        ref = json.load(fh)
    rs = bench_reads()
    check(readset_digest(rs) == ref["reads_sha256"], "4d placed: the read set differs")
    cfg = Config()
    cfg.set("genomeSize", BENCH_GENOME)
    n_hashes, min_matches = cfg.sketch_preset("cor", rs.total_bases / BENCH_GENOME)
    sk = MH.build_sketches(rs, k=int(cfg.get("corMerSize")), n_hashes=n_hashes, frequent=fk,
                           block_size=int(cfg.get("mhapBlockSize")), device=dev)
    pairs = MH.find_candidates(sk, min_matches=min_matches, block_size=1024, device=dev)
    del sk
    log(f"[4d placed] {len(pairs)} candidates (H {n_hashes}, min_matches {min_matches}; "
        f"reference {ref['n_candidates']})")
    check(len(pairs) == ref["n_candidates"] and candidates_digest(pairs) == ref[
        "candidates_sha256"], "4d placed: the candidates differ from the JAX package's")
    return rs, pairs[:, :2], ref


def placed_chunks(rs, pairs, fk, k: int, dev, chunk: int = 256) -> list:
    """Each chunk of the CPU path's place_candidates as _pair_stats_kernel's
    arguments on dev (ops.minhash.chunk_block: W the chunk's own, padded to
    `chunk` pairs)."""
    import torch

    from canu_tpu_torch.ops import minhash as MH
    from canu_tpu_torch.ops.hashing import u32_tensor

    out = []
    for s in range(0, len(pairs), chunk):
        wa, la, wb, lb = MH.chunk_block(rs, pairs[s : s + chunk], chunk)
        out.append((u32_tensor(wa, dev), torch.from_numpy(la).to(dev), u32_tensor(wb, dev),
                    torch.from_numpy(lb).to(dev), fk, k))
    return out


def time_pair_stats_call(call, reps: int = 5) -> float:
    """K12's device milliseconds on a captured call of
    ops.minhash._pair_stats_rows (its arguments), the kernel alone: the
    device hit list sized once, then CUDA events over reps launches."""
    from canu_tpu_torch.ops.kernels import verify_cuda as VC

    words, lengths, a_idx, b_idx, fk, k = call
    lists = VC.rows_hit_lists(lengths, a_idx, b_idx, k)
    return cuda_ms(lambda: VC.launch_rows(words, lengths, a_idx, b_idx, fk, k, lists), reps)


def placed_drive(dev, card: str, fk) -> dict:
    """Phase 4d: stage C, place_candidates, on the bench read set's cor
    candidates (placed_pairs), at k 16 with phase 4's frequent table and at
    k 22 without one, each then verified (verify_overlaps, band 128), on a
    read set of its own (so the verify builds its index), the counts set to
    0 just before and read just after.  K12 must launch once a
    place_candidates call, the verify K7, K8, K10 and K1 with the end pick,
    and no plain version on the card.  Holds the candidates, the placed
    candidates and the verified rows against placed_overlap_reference.json
    (canu_tpu on the CPU, scripts/torch_placed_reference.py); each call's
    rows, chunk by chunk, bit for bit against the plain statistics on the
    chunk's padded arrays (the CPU path's); K10 and K1 with the pick on the
    verify's first extension group (held_myers_ends).  Times K12 through
    the chunk entry on the first k 16 chunk beside its bound and the plain
    version, and each whole call by CUDA events beside the chunks' summed
    bound and K12's own count (pair_stats_design)."""
    import numpy as np
    import torch

    from canu_tpu_torch.ops import align as AL
    from canu_tpu_torch.ops import minhash as MH
    from canu_tpu_torch.ops import myers as MY
    from canu_tpu_torch.ops.kernels import verify_cuda as VC
    from canu_tpu_torch.stores.overlaps import store_digest

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_cases import placed_digest

    t_phase = time.time()
    rs, pairs, ref = placed_pairs(dev, fk)
    n_chunks = -(-len(pairs) // 256)
    out: dict = {"n_candidates": len(pairs), "chunks": n_chunks, "runs": {}}
    kept: dict = {}
    real = MH._pair_stats_rows
    real_ext, ext4d = capture_calls(MY, "banded_extend_myers", first_only=True)
    try:
        reset_counts()
        t = time.time()
        for k, with_fk in PLACED_KS:
            _, kept[k] = capture_calls(MH, "_pair_stats_rows")
            l0 = VC.PAIR_STATS_LAUNCHES
            t0 = time.time()
            placed = MH.place_candidates(rs, pairs, k=k, frequent=fk if with_fk else None,
                                         device=dev)
            t_place = time.time() - t0
            MH._pair_stats_rows = real
            table = AL.verify_overlaps(rs, placed, band=128, device=dev)
            out["runs"][k] = {"placed": len(placed), "placed_sha256": placed_digest(placed),
                              "rows": len(table.a_id), "rows_sha256": store_digest(table),
                              "k12": VC.PAIR_STATS_LAUNCHES - l0, "place_s": t_place,
                              "verify_s": time.time() - t0 - t_place}
        torch.cuda.synchronize()
        t_run = time.time() - t
        counts = read_counts()
    finally:
        MH._pair_stats_rows, MY.banded_extend_myers = real, real_ext
    log(f"[4d placed] {card}: place_candidates + verify_overlaps at k 16 and 22 in "
        f"{t_run:.2f} s; launch counts {counts}")
    for k, r in out["runs"].items():
        want = ref[f"k{k}"]
        log(f"[4d placed] k {k}: {r['placed']} placed (reference {want['placed']}) in "
            f"{r['place_s']:.3f} s (place_s), {r['k12']} K12 launch; {r['rows']} verified rows "
            f"(reference {want['rows']}) in {r['verify_s']:.2f} s")
        check(r["k12"] == 1 == len(kept[k]),
              f"4d placed: k {k}: {r['k12']} K12 launches for one place_candidates call")
        check(r["placed"] == want["placed"] and r["placed_sha256"] == want["placed_sha256"],
              f"4d placed: k {k}: the placed candidates differ from the JAX package's")
        check(r["rows"] == want["rows"] and r["rows_sha256"] == want["rows_sha256"],
              f"4d placed: k {k}: the verified rows differ from the JAX package's")
    check(counts["K12"] == 2, f"4d placed: {counts['K12']} K12 launches, not one a call")
    check(counts["K10"] == counts["K11_pick"] == counts["K1"] > 0 and counts["K11"] == 0,
          f"4d placed: K10 {counts['K10']}, K1 {counts['K1']} ({counts['K11_pick']} with the "
          f"end pick), K11 alone {counts['K11']}")
    check(counts["K2"] == counts["K3"] == counts["K4"] == 0 and no_plain(counts),
          f"4d placed: another kernel or a plain version ran on the card: {counts}")
    check(len(ext4d) == 1, "4d placed: the verify never called banded_extend_myers")
    (e_args, e_kw), = ext4d
    err_ends = held_myers_ends("4d first group", e_args[:5], e_args[6], e_kw)["err"]
    del ext4d
    log(f"[4d kernel] K10 and K1 with the end pick bit-equal to the plain chain on the placed "
        f"verify's first group ({e_args[0].shape[0]} extensions x {e_args[6]} rows, centres at "
        f"stride {e_kw.get('center_stride', 1)})")

    # each call's rows held to the plain statistics chunk by chunk; the
    # chunk entry on every chunk; the rounds each pair took against the plan
    err = 0
    calls: dict = {}
    for k, ((call, _kw),) in kept.items():
        rows = real(*call)
        chunks = placed_chunks(rs, pairs, call[4], k, dev)
        parts = []
        for i, args in enumerate(chunks):
            C = min(256, len(pairs) - 256 * i)
            ref_c = MH._pair_stats_kernel(*args)
            got = VC.pair_stats(*args)
            d = 0
            for r, g_call, g_chunk in zip(ref_c, rows[:, 256 * i : 256 * i + C], got):
                r = r.to(torch.int64)
                d = max(d, int((r[:C] - g_call.to(torch.int64)).abs().max()),
                        int((r - g_chunk.to(torch.int64)).abs().max()))
            check(d == 0, f"4d placed: k {k} chunk {i}: K12 differs from the plain statistics "
                  f"(max |diff| {d})")
            err = max(err, d)
            parts.append(pair_stats_bound(args))
        rounds = torch.full((len(pairs),), -1, dtype=torch.int32, device=dev)
        VC.pair_stats_rows(*call, rounds=rounds)
        la, lb = (rs.length[pairs[:, j] - 1] for j in (0, 1))
        plan_rounds = VC.pair_stats_plan(la, lb, k)["rounds"]
        took = rounds.cpu().numpy()
        # a round with more keys than 3/4 of the table is taken again over
        # half its range (retries: rounds past the plan, not a fault)
        check(bool((took >= plan_rounds).all()) and np.array_equal(took == 0, plan_rounds == 0),
              f"4d placed: k {k}: K12 took fewer rounds than its plan, or rounds a pair "
              f"without a position")
        retried = {"pairs": int((took > plan_rounds).sum()),
                   "rounds": int((took - plan_rounds).sum())}
        bd = {**sum_bounds(parts),
              **{n: sum(p[n] for p in parts) for n in ("positions", "hits")}}
        design = pair_stats_design(la, lb, k, bd["hits"], call[4].shape[0])
        ms_call = time_pair_stats_call(call)
        calls[k] = {"ms": ms_call, "bound": bd, "design": design, "chunks": len(chunks),
                    "retried": retried, "first_chunk": chunks[0] if k == 16 else None}
        log(f"[4d kernel] {card}: k {k}: the call's {len(pairs)} pairs in one K12 launch: "
            f"{ms_call:.3f} ms (CUDA events, mean of 5); the {len(chunks)} chunks' summed "
            f"bound {bd['bound_ms']:.4f} ms ({bd['ops']:.3e} operations, {bd['bytes']:.3e} "
            f"bytes, {bd['positions']} k-mer positions, {bd['hits']} hits; bound by "
            f"{bd['bound_by']}; {100 * bd['bound_ms'] / ms_call:.1f}% of it); K12's own count: "
            f"{design['rounds']} rounds over {design['pairs_with_rounds']} pairs (at most "
            f"{design['rounds_max']}), {design['inserts_a_round']:.0f} inserts and "
            f"{design['probes_a_round']:.0f} probes a round, {design['kmers']} k-mers built, "
            f"{design['slots']} slots, {design['smem_bytes']:.3e} shared bytes, "
            f"{design['room']} hit-list entries in device memory, {retried['rounds']} rounds "
            f"retried in {retried['pairs']} pairs; its bound "
            f"{design['design_bound_ms']:.4f} ms ({100 * design['design_bound_ms'] / ms_call:.1f}"
            f"% of it)")
    args = calls[16].pop("first_chunk")
    calls[22].pop("first_chunk")
    _, plain_ms = once_ms(lambda: MH._pair_stats_kernel(*args))
    ms = cuda_ms(lambda: VC.pair_stats(*args), 10)
    bd = pair_stats_bound(args)
    res = VC.pair_stats_resources()
    log(f"[4d kernel] {card}: K12 bit-equal to the plain statistics on all {n_chunks} + "
        f"{n_chunks} chunks, through the call and the chunk entry; the first k 16 chunk "
        f"({args[0].shape[0]} pairs x {args[0].shape[1]} words, {bd['positions']} k-mer "
        f"positions, {bd['hits']} hits) through the chunk entry: K12 {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms; bound {bd['bound_ms']:.4f} ms ({bd['ops']:.3e} operations, "
        f"{bd['bytes']:.3e} bytes; bound by {bd['bound_by']}; {100 * bd['bound_ms'] / ms:.1f}% "
        f"of it); plan {VC.K12_THREADS} threads, {VC.K12_SLOTS} slots, {VC.K12_HITS} shared "
        f"hits: {res}")
    del kept
    out.update(err=err, myers_ends_err=err_ends, ms=ms, plain_ms=plain_ms, bound=bd,
               calls=calls, resources=res, launches=counts, run_s=t_run,
               phase_s=time.time() - t_phase)
    log(f"[4d placed] phase wall {out['phase_s']:.1f} s")
    return out


def ecoli_reads(error_rate: float = 0.03, genome: int = ECOLI_GENOME):
    """The E. coli-scale read set (the JAX package's config 2,
    scripts/scale_run.py: 4.6 Mb at 25x): corrected reads at 3% error
    (phase 9, at ECOLI_OBT_GENOME), raw reads at 10% (phase 15)."""
    from canu_tpu_torch.sim.simulate import random_genome, simulate_reads

    g = random_genome(genome, seed=7)
    rs, _ = simulate_reads(g, coverage=25, mean_len=3500, min_len=1500, max_len=7800,
                           error_rate=error_rate, seed=8)
    return rs


def cuda_timed(real, events: list):
    """real, with a pair of CUDA events recorded around each call into
    events."""
    import torch

    def call(*args, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = real(*args, **kw)
        e1.record()
        events.append((e0, e1))
        return out

    return call


def k1_metered(real, k1: dict, dev):
    """A stand-in for K1.myers_rows_cuda that times each launch with CUDA
    events and computes its bound after it (k1_bound; the seconds that
    takes go into k1["bound_s"]).  The bound's own temporaries stay out of
    the verify's memory peak: the peak up to each launch goes into
    k1["peak"] and the device's peak count is reset after the bound."""
    import torch

    def call(*args, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = real(*args, **kw)
        e1.record()
        k1["events"].append((e0, e1))
        k1["peak"] = max(k1["peak"], torch.cuda.max_memory_allocated(dev))
        t0 = time.time()
        k1["bounds"].append(k1_bound(args, torch.clamp(args[4].to(torch.int64), 0, args[6]),
                                     kw.get("pick", False)))
        k1["bound_s"] += time.time() - t0
        torch.cuda.reset_peak_memory_stats(dev)
        return out

    return call


def verify_metered(real, k1: dict, mem: dict, dev):
    """A stand-in for ops.align.verify_overlaps that reads the device memory
    at the outer call's start (mem["start"]) and its peak (mem["peak"],
    with k1_metered's k1["peak"]); the palindromic pass recurses."""
    import torch

    depth = [0]

    def call(*args, **kw):
        if depth[0] == 0:
            torch.cuda.synchronize()
            mem["start"] = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            k1["peak"] = 0
        depth[0] += 1
        try:
            return real(*args, **kw)
        finally:
            depth[0] -= 1
            if depth[0] == 0:
                mem["peak"] = max(k1["peak"], torch.cuda.max_memory_allocated(dev))

    return call


def k1_drive_line(phase: str, card: str, k1: dict) -> tuple:
    """Log K1 on every launch of a drive (CUDA events) beside its bound;
    returns (ms of each launch, the bounds, the drive's bound in ms)."""
    k1_ms = [e0.elapsed_time(e1) for e0, e1 in k1["events"]]
    bd = k1["bounds"]
    tb = sum(x["bound_ms"] for x in bd)
    log(f"[{phase} timing] {card}: K1 per drive: {len(k1_ms)} launches, {sum(k1_ms):.3f} ms "
        f"(first {k1_ms[0]:.3f} ms, largest {max(k1_ms):.3f} ms); bound {tb:.3f} ms "
        f"({100 * tb / sum(k1_ms):.1f}% of it; {sum(x['ops'] for x in bd):.3e} operations, "
        f"{sum(x['bytes'] for x in bd):.3e} bytes, {sum(x['live_rows'] for x in bd)} live rows; "
        f"computed after each launch, {k1['bound_s']:.2f} s of the verify wall)")
    return k1_ms, bd, tb


def ecoli_drive(dev, card: str) -> dict:
    """Phase 9: obt meryl + overlap on the E. coli-scale read set with
    ovsMethod=spill, in a directory of its own, the counts set to 0 just
    before and read just after.  The path must run the host k-mer counter,
    the hash-join and the spill build once each and K1, and no other kernel
    or plain loop on the card.  Holds the frequent table and candidates
    against ecoli_overlap_reference.json, the store's rows for a sample of
    2,048 candidates against the JAX package's store of that sample, the
    spilled store against the in-RAM build of the tables the spill got, and
    the store's symmetry.  Times K1 on each launch with CUDA events (its
    bound computed after the launch, as in phase 5), and reads the device
    memory peak over the verify beside _chunk_staging_bytes times the
    window _verify_window chose."""
    import numpy as np
    import torch

    from canu_tpu_torch.config import Config
    from canu_tpu_torch.ops import align as AL
    from canu_tpu_torch.ops import kmer as KM
    from canu_tpu_torch.ops import minhash as MH
    from canu_tpu_torch.ops import myers as MY
    from canu_tpu_torch.ops.kernels import myers_cuda as K1
    from canu_tpu_torch.pipeline import stages
    from canu_tpu_torch.pipeline.driver import make_ctx
    from canu_tpu_torch.stores import overlaps as OV

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_cases import candidate_sample, store_rows_of_pairs

    with open(os.path.join(ROOT, "canu_tpu_torch", "ecoli_overlap_reference.json")) as fh:
        ref = json.load(fh)
    t_phase = t = time.time()
    rs = ecoli_reads(genome=ECOLI_OBT_GENOME)
    log(f"[9 ecoli] read set: {rs.n_reads} reads, {rs.total_bases} bases "
        f"(simulated in {time.time() - t:.1f} s)")
    check(rs.n_reads == ref["n_reads"] and rs.total_bases == ref["total_bases"],
          "E. coli read set differs from the reference's")
    work = tempfile.mkdtemp(prefix="chip_smoke_ecoli_")
    cfg = Config()
    cfg.set("genomeSize", ECOLI_OBT_GENOME)
    cfg.set("ovsMethod", "spill")
    ctx = make_ctx(work, "ecoli", cfg)

    # instrumentation, each undone below: K1's events and bounds, the
    # verify's memory peak and window, the candidates, the spill's tables
    k1 = {"events": [], "bounds": [], "peak": 0, "bound_s": 0.0}
    mem: dict = {"windows": []}
    pairs_seen, spilled, host_s = [], [], []
    real = {"k1": K1.myers_rows_cuda, "verify": AL.verify_overlaps,
            "window": AL._verify_window, "join": MH.find_candidates_join,
            "extend": MY.banded_extend_myers,
            "host": KM.count_readset_host, "append": OV.OverlapSpill.append}

    def window(*args):
        out = real["window"](*args)
        mem["windows"].append((args[:3], out))
        return out

    def host_timed(*args, **kw):
        t0 = time.time()
        out = real["host"](*args, **kw)
        host_s.append(time.time() - t0)
        return out

    def append(self, table):
        spilled.append(table)
        return real["append"](self, table)

    K1.myers_rows_cuda = k1_metered(real["k1"], k1, dev)
    AL.verify_overlaps = verify_metered(real["verify"], k1, mem, dev)
    AL._verify_window = window
    # the first extension group's inputs: K10 and K11 held to the plain chain
    _, ext9 = capture_calls(MY, "banded_extend_myers", first_only=True)
    MH.find_candidates_join = lambda *a, **kw: pairs_seen.append(real["join"](*a, **kw)) or \
        pairs_seen[-1]
    KM.count_readset_host, OV.OverlapSpill.append = host_timed, append
    # the first K7 group and every 16th after it, the index's first block
    real_pre, pre_kept = capture_pre(every=16)
    real_sy, sy_kept = capture_syncmer()
    try:
        reset_counts()
        t = time.time()
        fk = stages.meryl(ctx, "obt", rs, device=dev)
        t_meryl = time.time() - t
        st = stages.overlap(ctx, "obt", rs, fk, device=dev)
        torch.cuda.synchronize()
        t_stage = time.time() - t
        counts = read_counts()
    finally:
        K1.myers_rows_cuda, AL.verify_overlaps = real["k1"], real["verify"]
        AL._verify_window, MH.find_candidates_join = real["window"], real["join"]
        MY.banded_extend_myers = real["extend"]
        KM.count_readset_host, OV.OverlapSpill.append = real["host"], real["append"]
        AL._verify_pre = real_pre
        restore_syncmer(real_sy)
    prof = dict(AL.LAST_PROFILE)
    with open(ctx.path("ecoli.stage-times.jsonl")) as fh:
        sub = [json.loads(ln) for ln in fh if '"obt-overlap.sub"' in ln][-1]["sub_walls_s"]
    log(f"[9 ecoli] {card}: meryl {t_meryl:.2f} s (host k-mer count {sum(host_s):.2f} s); "
        f"meryl+overlap {t_stage:.2f} s; overlap sub-walls {sub} (sketch, match = the "
        f"hash-join, verify, store = spill sort + store write); verify profile {prof}")
    log(f"[9 ecoli] launch and call counts {counts}")
    check(counts["K1"] > 0, "9 ecoli: kernel K1 never launched during the stage")
    check(counts["K2"] == counts["K3"] == counts["K4"] == 0,
          "9 ecoli: kernel K2, K3 or K4 launched off its path")
    check(no_plain(counts),
          "9 ecoli: a plain loop ran on the card during the stage")
    check_minhash("9 ecoli", counts, match=False)
    for name in ("host_kmer_counts", "join_calls", "spill_builds"):
        check(counts[name] == 1, f"9 ecoli: {name} is {counts[name]}, expected 1")
    check(len(k1["events"]) == counts["K1"], "9 ecoli: K1 launches and timed calls differ")

    # the frequent table and the candidates equal the JAX package's
    fdig = frequent_digest(os.path.join(work, "trimming", "ecoli.ms22.frequent.npz"))
    (pairs,) = pairs_seen
    cdig = hashlib.sha256(np.ascontiguousarray(pairs.astype("<i8")).tobytes()).hexdigest()
    log(f"[9 ecoli] frequent sha256 {fdig}; {len(pairs)} candidates (reference "
        f"{ref['n_candidates']}), sha256 {cdig}")
    check(fdig == ref["frequent_sha256"], "9 ecoli: frequent-mer table differs from the JAX package's")
    check(len(pairs) == ref["n_candidates"] and cdig == ref["candidates_sha256"],
          "9 ecoli: candidates differ from the JAX package's")
    # the store: non-empty, symmetric, its rows for the sample the JAX
    # package's store of that sample, the spilled build the in-RAM one
    a, b = np.asarray(st.a_id).astype(np.int64), np.asarray(st.b_id).astype(np.int64)
    check(len(st) > 0, "9 ecoli: empty overlap store")
    check(np.array_equal(np.unique(a << 32 | b), np.unique(b << 32 | a)),
          "9 ecoli: overlap store is not symmetric")
    # two samples: every floor(M/2048)-th candidate, and the same from half
    # a stride in
    for key, second in (("sample", False), ("sample2", True)):
        sample = candidate_sample(pairs, ECOLI_SAMPLE, second=second)
        sdig = hashlib.sha256(np.ascontiguousarray(sample.astype("<i8")).tobytes()).hexdigest()
        check(sdig == ref[key]["candidates_sha256"], f"9 ecoli: the candidate {key} differs")
        rows = store_rows_of_pairs(st, sample)
        rdig = OV.store_digest(rows)
        log(f"[9 ecoli] store rows {len(st)}; {key}: the rows of the {len(sample)} sampled "
            f"candidates ({ref[key]['rule']}) {len(rows.a_id)} (reference {ref[key]['rows']}), "
            f"sha256 {rdig}")
        check(len(rows.a_id) == ref[key]["rows"] and rdig == ref[key]["store_sha256"],
              f"9 ecoli: the {key} candidates' rows differ from the JAX package's store")
    cat = AL.OverlapTable(**{c: np.concatenate([getattr(x, c) for x in spilled])
                             for c in ("a_id", "b_id", "flipped", "a_bgn", "a_end", "b_bgn",
                                       "b_end", "erate_q")})
    in_ram = OV.store_digest(OV.OverlapStore.build(cat, rs.n_reads))
    check(in_ram == OV.store_digest(st), "9 ecoli: the spilled store differs from the in-RAM build")
    log(f"[9 ecoli] store symmetric; both samples' rows equal the JAX package's; the spilled store "
        f"equals the in-RAM build of the {len(spilled)} tables the spill got ({len(cat)} rows)")

    # K1 on every launch of the drive, by CUDA events, beside its bound
    k1_ms, bd, tb = k1_drive_line("9", card, k1)
    (w_args, (group, n_window)), *rest = mem["windows"]
    est = AL._chunk_staging_bytes(*w_args, True) * n_window
    log(f"[9 memory] {card}: verify device peak {mem['peak'] / 1e9:.3f} GB "
        f"(torch.cuda.max_memory_allocated; {(mem['peak'] - mem['start']) / 1e9:.3f} GB above "
        f"the {mem['start'] / 1e9:.3f} GB allocated at its start); _chunk_staging_bytes"
        f"{tuple(w_args)} on the card x the window of {n_window} chunks = {est / 1e9:.3f} GB "
        f"(the plain chain's estimate {AL._chunk_staging_bytes(*w_args) * n_window / 1e9:.3f} "
        f"GB; groups of {group}; {len(rest)} more window calls: {[w[1] for w in rest]})")
    check(counts["K10"] == counts["K11_pick"] == counts["K1"] and counts["K11"] == 0,
          f"9 ecoli: K10 {counts['K10']} launches for K1's {counts['K1']} ("
          f"{counts['K11_pick']} with the end pick), K11 alone {counts['K11']}")
    check(len(ext9) == 1, "9 ecoli: the verify never called banded_extend_myers")
    (e_args, e_kw), = ext9
    ends9 = held_myers_ends("9 first group", e_args[:5], e_args[6], e_kw, reps=5)
    del ext9
    log(f"[9 kernel] {card}: K10 and K1 with the end pick bit-equal to the plain chain on the "
        f"first group ({e_args[0].shape[0]} extensions x {e_args[6]} rows, centres at stride "
        f"{ends9['K10']['stride']}): K10 {ends9['K10']['ms']:.3f} ms (plain "
        f"{ends9['K10']['plain_ms']:.3f} ms, bound {ends9['K10']['bound']['bound_ms']:.4f} ms "
        f"by {ends9['K10']['bound']['bound_by']}; as rows it would be "
        f"{ends9['K10']['bound_rows']['bound_ms']:.4f} ms), K11 alone "
        f"{ends9['K11']['ms']:.4f} ms (plain {ends9['K11']['plain_ms']:.3f} ms, bound "
        f"{ends9['K11']['bound']['bound_ms']:.4f} ms)")
    # K7 and K8 held to the plain versions on the kept groups and block
    verify_err = held_verify_calls("phase 9", pre_kept, sy_kept)
    vsplit = verify_kernel_split("9", card, pre_kept, sy_kept)
    del pre_kept, sy_kept
    log(f"[9 ecoli] phase wall {time.time() - t_phase:.1f} s")
    return {"verify_err": verify_err, "verify_split": vsplit, "meryl_s": t_meryl,
            "myers_ends": ends9, "host_count_s": sum(host_s),
            "stage_s": t_stage,
            "sub_walls_s": sub, "verify_profile": prof, "rows": len(st),
            "n_candidates": len(pairs), "launches": counts, "k1_ms": k1_ms,
            "k1_ms_per_drive": sum(k1_ms), "k1_bounds": bd, "k1_bound_ms_per_drive": tb,
            "k1_bound_s": k1["bound_s"], "verify_peak_bytes": mem["peak"],
            "verify_start_bytes": mem["start"], "window": [list(w_args), group, n_window],
            "staging_estimate_bytes": est, "phase_s": time.time() - t_phase}


def fold_bound(G: int, Lt: int, n_rows: int, W_e: int, host_cols) -> dict:
    """Kernel K9's bound on one launch (a DP group's fold), from its jobs'
    host columns: FOLD_ROW_OPS and one a channel (15) for each live (job,
    row), a row below min(t_span, n_rows) of a job that votes (weight not
    0 in bfloat16, slot on the block); its bytes each such job's path up
    to its last live row, its live template rows, its evidence window and
    its five columns read once, and the block's votes read and written
    once."""
    import numpy as np

    from canu_tpu_torch.ops.kernels import votepile_cuda as K9

    w = K9.rounded_weights(host_cols[8])
    slot = host_cols[7]
    votes = (host_cols[3] > 0) & (w != 0) & (slot >= 0) & (slot < G)
    rows = np.minimum(host_cols[3][votes].astype(np.int64), n_rows)
    live = int(rows.sum())
    ops = (FOLD_ROW_OPS + 15) * live
    nbytes = 4 * (live + len(rows)) + live + W_e * len(rows) + 20 * len(rows)
    out = bound(ops, nbytes + 2 * 4 * G * 15 * Lt)
    out["live_rows"] = live
    return out


def fold_metered(real, ev: list, keep: dict | None = None, key=lambda args: "first"):
    """A stand-in for ops.votepile._fold_group that records CUDA events
    around each call into ev with its geometry and host columns (for
    fold_bound), and keeps, for each key(args) not yet in keep, the call's
    inputs with the votes cloned before and after it (held_fold)."""
    import torch

    def call(*args):
        votes, js, t_sub, e_sub, cols, host_cols, n_rows, Lt, G, B = args[:10]
        k = key(args) if keep is not None else None
        before = votes.clone() if k is not None and k not in keep else None
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = real(*args)
        e1.record()
        ev.append((e0, e1, (G, Lt, n_rows, e_sub.shape[1], host_cols, -(-js.shape[0] // B))))
        if before is not None:
            keep[k] = (before, js, t_sub, e_sub, cols, host_cols, n_rows, Lt, G, B, out.clone())
        return out

    return call


def fold_events(ev: list, card: str, tag: str, what: str) -> dict:
    """K9 over a drive's launches by CUDA events (ms a launch, a chunk and
    in all) beside the summed bound of every launch (fold_bound)."""
    ms = [a.elapsed_time(b) for a, b, _ in ev]
    chunks = sum(g[5] for _, _, g in ev)
    bds = [fold_bound(*g[:5]) for _, _, g in ev]
    tb = sum(b["bound_ms"] for b in bds)
    out = {"launches": len(ms), "chunks": chunks, "ms": sum(ms),
           "ms_a_launch": sum(ms) / max(len(ms), 1), "ms_a_chunk": sum(ms) / max(chunks, 1),
           "bound_ms": tb, "bound_share": tb / max(sum(ms), 1e-9)}
    log(f"[{tag} timing] {card}: K9 (the vote fold) over {what}: {len(ms)} launches, {chunks} "
        f"chunks, {sum(ms):.3f} ms by CUDA events ({out['ms_a_launch']:.3f} ms a launch, "
        f"{out['ms_a_chunk']:.4f} ms a chunk); bound {tb:.3f} ms summed over the launches "
        f"(fold_bound: {sum(b['live_rows'] for b in bds)} live rows, "
        f"{sum(b['bytes'] for b in bds):.3e} bytes), {100 * out['bound_share']:.1f}% of it")
    return out


def held_fold(name: str, kept, card: str, reps: int = 5) -> dict:
    """Kernel K9 held bit for bit to the plain fold (ops.votepile
    ._fold_chunk, chunk by chunk) on a group the main path folded, from the
    votes it held before: the main path's result and a fresh launch both
    equal the plain votes.  Then K9 by CUDA events (mean of reps launches
    into a scratch copy: the launch alone, and the wrapper's whole call)
    and the plain fold's one run, beside fold_bound."""
    import numpy as np
    import torch

    from canu_tpu_torch.ops import votepile as VP
    from canu_tpu_torch.ops.kernels import votepile_cuda as K9

    before, js, t_sub, e_sub, cols, host_cols, n_rows, Lt, G, B, after = kept
    plain = before.clone()

    def fold_plain():
        v = plain
        for lo in range(0, js.shape[0], B):
            v = VP._fold_chunk(v, js[lo : lo + B], t_sub[lo : lo + B], e_sub[lo : lo + B],
                               cols[:, lo : lo + B], n_rows, Lt, G)
        return v

    plain, plain_ms = once_ms(fold_plain)
    mask = (1 << VP._log_rounds(Lt)) - 1
    fresh = before.clone()
    l0 = K9.LAUNCHES
    K9.vote_fold(fresh, js, t_sub, e_sub, cols.contiguous(), n_rows, mask, host_cols,
                 np.zeros(G))
    check(K9.LAUNCHES == l0 + 1, f"{name}: K9 launched {K9.LAUNCHES - l0} times for one group")
    torch.cuda.synchronize()
    err = max(float((plain - after).abs().max()), float((plain - fresh).abs().max()))
    check(err == 0, f"{name}: kernel K9 and the plain fold differ (max |diff| {err})")
    scratch = before.clone()
    call_ms = cuda_ms(lambda: K9.vote_fold(scratch, js, t_sub, e_sub, cols.contiguous(), n_rows,
                                           mask, host_cols, np.zeros(G)), reps)
    by_slot = torch.from_numpy(K9.slot_order(host_cols, G)).to(before.device)
    ms = cuda_ms(lambda: K9.launch(scratch, js, t_sub, e_sub, cols.contiguous(), n_rows, mask,
                                   by_slot), reps)
    chunks = -(-js.shape[0] // B)
    bd = fold_bound(G, Lt, n_rows, e_sub.shape[1], host_cols)
    log(f"[{name.split()[0]} fold] {card}: {name}: one K9 launch of {js.shape[0]} jobs ({chunks} "
        f"chunks of {B}) x {n_rows} rows into votes [{G}, 15, {Lt}], bit-equal to the plain fold "
        f"(the main path's votes and a fresh launch); K9 {ms:.3f} ms (the launch alone, mean of "
        f"{reps}; {call_ms:.3f} ms the wrapper's call with its host part: the weights' check, "
        f"the slot order and its upload), "
        f"{ms / chunks:.4f} ms a chunk; the plain fold {plain_ms:.1f} ms "
        f"({plain_ms / chunks:.3f} ms a chunk); bound {bd['bound_ms']:.4f} ms "
        f"({bd['ops']:.3e} operations over {bd['live_rows']} live rows, {bd['bytes']:.3e} bytes; "
        f"bound by {bd['bound_by']}; {100 * bd['bound_ms'] / ms:.1f}% of it)")
    return {"err": err, "jobs": int(js.shape[0]), "chunks": chunks, "ms": ms,
            "call_ms": call_ms, "ms_a_chunk": ms / chunks, "plain_ms": plain_ms, "bound": bd}


def fold_edge_checks(dev, card: str) -> float:
    """Phase 3g: K9 against the plain fold on tests/torch_cases.py's fold
    cases (FOLD_CASES, fold_exact_case, FOLD_TILE_CASES), one launch each
    into votes that already hold votes, and at the correction's geometry
    (a group of 17 chunks of 256 jobs, 2,048 rows, G 256, W_e 3,072)."""
    import numpy as np
    import torch

    from canu_tpu_torch.ops import votepile as VP
    from torch_cases import FOLD_CASES, FOLD_TILE_CASES, fold_case, fold_exact_case, fold_tile_case

    cases = [(name, fold_case(sum(map(ord, name)), *c), c[1], c[1], c[3], 64)
             for name, c in FOLD_CASES.items()]
    cases.append(("exact", fold_exact_case(256, 256, 128), 256, 256, 8, 64))
    for name in FOLD_TILE_CASES:
        js, t_sub, e_sub, cols, n_rows, Lt, G = fold_tile_case(name)
        cases.append((name, (js, t_sub, e_sub, cols), n_rows, Lt, G, 32))
    cases.append(("real 17 x 256 jobs", fold_case(117, 17 * 256, 2048, 256, 256), 2048, 2048,
                  256, 256))
    err = 0.0
    for name, (js, t_sub, e_sub, cols), n_rows, Lt, G, B in cases:
        before = torch.from_numpy((np.random.default_rng(3).integers(0, 4, (G, 15, Lt))
                                   * 0.25).astype(np.float32)).to(dev)
        t = [torch.from_numpy(x).to(dev) for x in (js, t_sub, e_sub, cols)]
        host = np.ascontiguousarray(cols)
        after = VP._fold_group(before.clone(), *t, host, n_rows, Lt, G, B, np.zeros(G))
        r = held_fold(f"3g {name}", (before, *t, host, n_rows, Lt, G, B, after), card,
                      reps=1)
        err = max(err, r["err"])
    return err


def correct_drive(dev, card: str) -> dict:
    """Phase 10: the port's correction_phase from a FASTA of the raw bench
    reads, Config() + genomeSize=300k, in a directory of its own, the
    counts set to 0 just before and read just after.  K1 must have launched
    (the cor overlap stage), K4 once per DP call and K9 once per DP group,
    and no other kernel, plain loop, plain DP or plain fold on the card,
    and at least one K4 launch of 4 chunks or more (a DP call takes a group
    of chunks); the first three DP calls' inputs are kept for phase 12c,
    and K9 is held to the plain fold on the first DP group (held_fold).
    Holds the gatekeeper store, the cor store and each of the nine blocks
    of corrected reads
    (correction_reference.json) against the JAX package's; the FASTA must be non-empty with
    every record <read>_corrN.  Prints the stage walls and the correction's
    parts: selection and decode on the host clock, the DP, the windows and
    the fold (K9) of each group and the finalize by CUDA events,
    the fetch of the packed rows (host clock; it waits for the device); the
    chunks, groups and jobs and the jobs of each K4 launch; the first
    pile_votes call (a chapter of chunks) under torch.profiler (its
    launches and the device busy share); the device memory peak over the
    correction."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from canu_tpu_torch.config import Config
    from canu_tpu_torch.io.fastx import read_fastx, write_fasta
    from canu_tpu_torch.ops import falcon as F
    from canu_tpu_torch.ops import votepile as VP
    from canu_tpu_torch.ops.kernels import trace_cuda as K4
    from canu_tpu_torch.pipeline import stages
    from canu_tpu_torch.pipeline.driver import make_ctx
    from canu_tpu_torch.stores.overlaps import OverlapStore, store_digest
    from canu_tpu_torch.stores.readset import ReadSet

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_cases import corrected_digest

    with open(os.path.join(ROOT, "canu_tpu_torch", "correction_reference.json")) as fh:
        ref = json.load(fh)
    with open(os.path.join(ROOT, "canu_tpu_torch", "cor_overlap_reference.json")) as fh:
        cor_ref = json.load(fh)
    t_phase = time.time()
    raw = bench_reads()
    work = tempfile.mkdtemp(prefix="chip_smoke_correct_")
    fasta = os.path.join(work, "reads.fasta")
    write_fasta(fasta, ((raw.name(i), raw.get_seq(i)) for i in range(1, raw.n_reads + 1)))
    cfg = Config()
    cfg.set("genomeSize", BENCH_GENOME)
    ctx = make_ctx(work, "bench", cfg)

    # instrumentation, each undone below: every block's reads as the phase
    # gets them, CUDA events around the DP, each group's windows and DP,
    # each group's fold (K9) and each finalize, the first chapter's inputs,
    # the first group's fold inputs, the memory peak from the first block
    # on
    blocks: dict = {}
    ev: dict = {"dp": [], "group": [], "finalize": []}
    fold_ev: list = []
    fold_kept: dict = {}
    first_chapter: list = []
    dp_jobs: list = []  # the jobs each DP call launched K4 on (K4.JOBS_LAUNCHED)
    mem: dict = {}
    real = {"blocks": F.correct_reads_blocks, "dp": VP.align_positions_lean,
            "group": VP._group_paths, "fold": VP._fold_group, "finalize": F._finalize_plurality,
            "chapter": F.pile_votes}

    def timed(name):
        return cuda_timed(real[name], ev[name])

    def chapter(*args, **kw):
        if not first_chapter:
            first_chapter.append((args, kw))
        return real["chapter"](*args, **kw)

    def capture(*args, **kw):
        torch.cuda.synchronize()
        mem["start"] = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        for bi, items in real["blocks"](*args, **kw):
            blocks[bi] = items
            yield bi, items
        torch.cuda.synchronize()
        mem["peak"] = torch.cuda.max_memory_allocated(dev)

    dp_chunks: list = []
    dp_timed = timed("dp")

    def dp(*args, **kw):
        if len(dp_chunks) < 3:  # held to the plain DP in phase 12c
            dp_chunks.append(keep_call(args, kw))
        j0 = K4.JOBS_LAUNCHED
        out = dp_timed(*args, **kw)
        dp_jobs.append(K4.JOBS_LAUNCHED - j0)
        return out

    F.correct_reads_blocks, VP.align_positions_lean = capture, dp
    VP._group_paths = timed("group")
    VP._fold_group = fold_metered(real["fold"], fold_ev, fold_kept)
    F._finalize_plurality, F.pile_votes = timed("finalize"), chapter
    try:
        reset_counts()
        F.PROFILE.clear()
        VP.CHUNKS = VP.JOBS = VP.GROUPS = 0
        t = time.time()
        stages.correction_phase(ctx, [fasta], device=dev)
        torch.cuda.synchronize()
        t_run = time.time() - t
        counts = read_counts()
    finally:
        F.correct_reads_blocks, VP.align_positions_lean = real["blocks"], real["dp"]
        VP._group_paths, VP._fold_group = real["group"], real["fold"]
        F._finalize_plurality, F.pile_votes = real["finalize"], real["chapter"]
    chunk_b = VP.chunk_jobs(F.VOTE_SEG)
    log(f"[10 correct] {card}: correction_phase from a FASTA of {raw.n_reads} reads: "
        f"{t_run:.2f} s; launch counts {counts}; jobs a K4 launch {dp_jobs} (chunks of "
        f"{chunk_b})")
    check(counts["K1"] > 0, "10 correct: kernel K1 never launched during the phase")
    check(counts["K2"] == counts["K3"] == 0, "10 correct: kernel K2 or K3 launched off its path")
    check_dp("10 correct", counts, len(ev["dp"]))
    check(max(dp_jobs) >= 4 * chunk_b,
          f"10 correct: no K4 launch took 4 chunks or more (jobs a launch {dp_jobs})")
    check(no_plain(counts),
          "10 correct: a plain loop or the plain DP ran on the card during the phase")
    check_fold("10 correct", counts)
    check(len(fold_ev) == counts["K9"], "10 correct: K9 launches and timed calls differ")
    check_minhash("10 correct", counts, match=True)

    # the gatekeeper store and the cor store equal the JAX package's
    d = os.path.join(work, "correction")
    rs = ReadSet.load(os.path.join(d, "bench.gkpStore"))
    st = OverlapStore.load(os.path.join(d, "bench.ovlStore"))
    sdig = store_digest(st)
    log(f"[10 correct] gatekeeper store {rs.n_reads} reads, {rs.total_bases} bases (reference "
        f"{ref['gatekeeper_reads']}, {ref['gatekeeper_bases']}); cor store {len(st)} rows, "
        f"sha256 {sdig}")
    check(rs.n_reads == ref["gatekeeper_reads"] and rs.total_bases == ref["gatekeeper_bases"],
          "10 correct: the gatekeeper store differs from the JAX package's")
    check(len(st) == cor_ref["rows"] and sdig == cor_ref["store_sha256"] == ref["cor_store_sha256"],
          "10 correct: the cor store differs from the JAX package's")
    # every reference block's corrected reads equal the JAX package's
    check(sorted(blocks) == list(range(ref["n_blocks"])),
          f"10 correct: blocks {sorted(blocks)}, the reference has {ref['n_blocks']}")
    for rb in ref["blocks"]:
        items = blocks[rb["index"]]
        dig = corrected_digest(items)
        log(f"[10 correct] block {rb['index']}: {len(items)} reads, "
            f"{sum(len(s) for _, s in items)} bases, sha256 {dig} (reference {rb['reads']}, "
            f"{rb['bases']}, {rb['sha256']})")
        check(dig == rb["sha256"], f"10 correct: block {rb['index']}'s corrected reads differ "
              "from the JAX package's")
    recs = list(read_fastx(os.path.join(d, "bench.correctedReads.fasta.gz")))
    names = {rs.name(i) for i in range(1, rs.n_reads + 1)}
    check(len(recs) > 0 and len(recs) == sum(len(v) for v in blocks.values()),
          "10 correct: the corrected FASTA is empty or misses reads")
    check(all(r.name.rsplit("_corr", 1)[0] in names and r.name.rsplit("_corr", 1)[1].isdigit()
              for r in recs), "10 correct: a corrected read is not named <read>_corrN")
    log(f"[10 correct] {len(recs)} corrected reads, {sum(len(r.seq) for r in recs)} bases in "
        f"{len(blocks)} blocks; blocks {ref['blocks_covered']} equal the JAX package's")

    # where the time went
    with open(ctx.path("bench.stage-times.jsonl")) as fh:
        walls = {r["stage"]: r["wall_s"] for r in map(json.loads, fh) if "wall_s" in r}
    dev_s = {k: sum(a.elapsed_time(b) for a, b in v) / 1e3 for k, v in ev.items()}
    prof = dict(F.PROFILE)
    n_chunks, n_jobs, n_groups = VP.CHUNKS, VP.JOBS, VP.GROUPS
    parts = {"select_s": prof.get("select", 0.0), "dp_s": dev_s["dp"],
             "windows_s": dev_s["group"] - dev_s["dp"],
             "fold_s": sum(a.elapsed_time(b) for a, b, _ in fold_ev) / 1e3,
             "finalize_s": dev_s["finalize"], "fetch_s": prof.get("fetch", 0.0),
             "decode_s": prof.get("decode", 0.0), "enqueue_votes_s": prof.get("votes", 0.0),
             "block_write_s": prof.get("write", 0.0), "concat_s": prof.get("concat", 0.0),
             "count_s": prof.get("count", 0.0)}
    log(f"[10 timing] {card}: stage walls {walls}; correction parts " + ", ".join(
        f"{k} {v:.3f}" for k, v in parts.items()) + f" (DP, windows, fold and finalize: CUDA "
        f"events; the rest host clock); {n_jobs} vote jobs in {n_chunks} chunks of {chunk_b}, "
        f"{n_groups} DP groups")
    # K9 over the phase's groups beside their bounds, then held bit for bit
    # to the plain fold on the first group (12c's first full group) and
    # timed there
    fold = fold_events(fold_ev, card, "10", "the correction's DP groups")
    del fold_ev
    fold["held"] = held_fold("10 first DP group", fold_kept.pop("first"), card)

    # the first chapter (pile_votes call): its launches and the device's busy share
    args, kw = first_chapter[0]
    c0 = VP.CHUNKS
    torch.cuda.synchronize()
    t = time.time()
    real["chapter"](*args, **kw)
    torch.cuda.synchronize()
    wall1 = time.time() - t
    ch_chunks = VP.CHUNKS - c0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t = time.time()
        real["chapter"](*args, **kw)
        torch.cuda.synchronize()
        wall_p = time.time() - t
    cuda_ev = [e for e in p.key_averages()
               if getattr(getattr(e, "device_type", None), "name", "") == "CUDA"]
    launches = sum(e.count for e in cuda_ev)
    busy = sum(e.self_device_time_total for e in cuda_ev) / 1e6
    with open(os.path.join(OUT_DIR, "profile_correct.txt"), "w") as fh:
        fh.write(f"{card}\none vote chapter ({ch_chunks} chunks): wall {wall_p:.3f} s under the "
                 f"profiler, device busy {busy:.3f} s\n"
                 + p.key_averages().table(sort_by="self_device_time_total", row_limit=25) + "\n")
    log(f"[10 profile] {card}: one vote chapter ({ch_chunks} chunks): wall {wall1:.3f} s "
        f"({wall_p:.3f} s under the profiler), {wall1 / ch_chunks:.4f} s a chunk; {launches} "
        f"device launches (kernels, copies and fills), {launches / ch_chunks:.1f} a chunk; "
        f"device busy {busy:.3f} s = {100 * busy / wall1:.1f}% of the chapter's wall "
        f"({100 * busy / wall_p:.1f}% under the profiler); table in "
        "chiprun_out/profile_correct.txt")
    log(f"[10 memory] {card}: device peak over the correction "
        f"{mem['peak'] / 1e9:.3f} GB ({(mem['peak'] - mem['start']) / 1e9:.3f} GB above the "
        f"{mem['start'] / 1e9:.3f} GB allocated at its start)")
    log(f"[10 correct] phase wall {time.time() - t_phase:.1f} s")
    return {"fold": fold, "run_s": t_run, "stage_walls_s": walls, "parts_s": parts, "chunks": n_chunks,
            "jobs": n_jobs, "groups": n_groups, "dp_calls": len(ev["dp"]), "dp_jobs": dp_jobs,
            "dp_chunks": dp_chunks, "chunk_jobs": chunk_b, "launches": counts,
            "chapter_chunks": ch_chunks, "chapter_wall_s": wall1,
            "chapter_wall_profiled_s": wall_p, "chapter_launches": launches,
            "chapter_busy_s": busy, "peak_bytes": mem["peak"],
            "start_bytes": mem["start"], "corrected_reads": len(recs), "work": work,
            "fasta": fasta, "phase_s": time.time() - t_phase}


def ng50(lengths, genome_size: int) -> int:
    """The contig length at which the longest contigs first reach half the
    genome size (0 when they never do)."""
    acc = 0
    for n in sorted(lengths, reverse=True):
        acc += n
        if acc >= genome_size / 2:
            return n
    return 0


def assemble_run(name: str, dev, card: str, genome_len: int, genome_seed: int, repeats,
                 ref: dict | None) -> dict:
    """One run of phase 11: run_pipeline from a FASTA of simulated corrected
    reads, Config() + genomeSize, in a directory of its own, the counts set
    to 0 just before and read just after.  K1 must have launched in the obt
    overlap, the utg overlap and the OEA adjust (and in align_links where
    the GFA keeps a link), K4 once per DP call (RED's and the polish's
    first kept for phase 12c); no other kernel, no plain loop and no plain
    DP on the card.  With ``ref`` every gate of assembly_digests must equal the JAX
    package's.  Returns the run's record (walls, launches, K1 in the
    adjust with its bound, memory peak, contigs, identity)."""
    import torch

    from canu_tpu_torch.config import Config
    from canu_tpu_torch.io import gfa as GFA
    from canu_tpu_torch.io.fastx import read_fastx
    from canu_tpu_torch.ops import align as AL
    from canu_tpu_torch.ops import consensus as CNS
    from canu_tpu_torch.ops import myers as MY
    from canu_tpu_torch.ops import oea as OEA
    from canu_tpu_torch.ops import votepile as VP
    from canu_tpu_torch.ops.kernels import myers_cuda as K1
    from canu_tpu_torch.pipeline import stages
    from canu_tpu_torch.pipeline.driver import run_pipeline

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_cases import assembly_digests, largest_contig_identity, write_assembly_reads

    tag = f"11{name}"
    t_phase = time.time()
    work = tempfile.mkdtemp(prefix=f"chip_smoke_assemble_{name}_")
    fasta = os.path.join(work, "reads.fasta")
    genome, n_reads, n_bases, fasta_sha = write_assembly_reads(fasta, genome_len, genome_seed,
                                                               repeats)
    log(f"[{tag} assemble] read set: random_genome({genome_len}, seed={genome_seed}, "
        f"repeat_spec={repeats}): {n_reads} corrected reads, {n_bases} bases, FASTA sha256 "
        f"{fasta_sha}")
    if ref is not None:
        check(fasta_sha == ref["input_fasta_sha256"],
              f"{tag}: the read set differs from the reference's")
    wd = os.path.join(work, "asm")
    cfg = Config()
    cfg.set("genomeSize", genome_len)

    # instrumentation, each undone below: K1 launches within each overlap
    # stage, RED, the OEA adjust and align_links; RED's corrections; the
    # vote chunks and the DP (CUDA events) of RED and the polish; every K1
    # launch of the adjust with its inputs; the memory peak over assembly
    k1_in: dict = {}
    chunks_in: dict = {}
    step_peak: dict = {}  # device bytes above each step's start, its peak
    dp_ev: dict = {"red": [], "polish": []}
    where = [None]
    mem: dict = {}
    n_links = [0]
    corr: dict = {}
    real = {"overlap": stages.overlap, "red": OEA.detect_read_errors,
            "adjust": OEA.adjust_overlap_erates, "polish": CNS.polish_tig,
            "links": GFA.align_links, "dp": VP.align_positions_lean,
            "assembly": stages.assembly_phase, "rows": MY._rows_kernel}
    adjust_calls: list = []
    n_dp = [0]
    dp_chunks: dict = {}  # RED's and the polish's first DP call, held to the plain DP in 12c

    def counted(key, fn):
        def call(*args, **kw):
            k0, c0, prev = K1.LAUNCHES, VP.CHUNKS, where[0]
            where[0] = key
            torch.cuda.synchronize()
            m0 = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda.synchronize()
                step_peak[key] = max(step_peak.get(key, 0),
                                     torch.cuda.max_memory_allocated(dev) - m0)
                where[0] = prev
                k1_in[key] = k1_in.get(key, 0) + K1.LAUNCHES - k0
                chunks_in[key] = chunks_in.get(key, 0) + VP.CHUNKS - c0
        return call

    def overlap(ctx, tg, *args, **kw):
        return counted(f"{tg}-overlap", real["overlap"])(ctx, tg, *args, **kw)

    def red(*args, **kw):
        out = counted("red", real["red"])(*args, **kw)
        corr.update(out)
        return out

    def links(tigs, lk, *args, **kw):
        n_links[0] += len(lk)
        return counted("align_links", real["links"])(tigs, lk, *args, **kw)

    def dp(*args, **kw):
        n_dp[0] += 1
        if where[0] not in dp_ev:
            return real["dp"](*args, **kw)
        if where[0] not in dp_chunks:
            dp_chunks[where[0]] = keep_call(args, kw)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = real["dp"](*args, **kw)
        e1.record()
        dp_ev[where[0]].append((e0, e1))
        return out

    def rows(*args, **kw):
        if where[0] == "adjust":
            adjust_calls.append((args, kw))
        return real["rows"](*args, **kw)

    def assembly(*args, **kw):
        # the steps' peaks (each step resets the peak) and the phase's own
        torch.cuda.synchronize()
        mem["start"] = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        step_peak.clear()
        real["assembly"](*args, **kw)
        torch.cuda.synchronize()
        mem["peak"] = max([torch.cuda.max_memory_allocated(dev)]
                          + [mem["start"] + v for v in step_peak.values()])

    stages.overlap, stages.assembly_phase = overlap, assembly
    OEA.detect_read_errors, OEA.adjust_overlap_erates = red, counted("adjust", real["adjust"])
    CNS.polish_tig, GFA.align_links = counted("polish", real["polish"]), links
    VP.align_positions_lean, MY._rows_kernel = dp, rows
    # the OEA adjust's first K7 group (orient=False, the store's flipped)
    real_pre, adjust_pre = capture_pre(when=lambda: where[0] == "adjust")
    try:
        reset_counts()
        t = time.time()
        run_pipeline(wd, "asm", cfg, corrected_reads=[fasta], device=dev)
        torch.cuda.synchronize()
        t_run = time.time() - t
        counts = read_counts()
    finally:
        stages.overlap, stages.assembly_phase = real["overlap"], real["assembly"]
        OEA.detect_read_errors, OEA.adjust_overlap_erates = real["red"], real["adjust"]
        CNS.polish_tig, GFA.align_links = real["polish"], real["links"]
        VP.align_positions_lean, MY._rows_kernel = real["dp"], real["rows"]
        AL._verify_pre = real_pre
    log(f"[{tag} assemble] {card}: run_pipeline from corrected reads: {t_run:.2f} s; launch "
        f"counts {counts}; K1 launches by step {k1_in}")
    check(counts["K2"] == counts["K3"] == 0, f"{tag}: kernel K2 or K3 launched off its path")
    check_dp(tag, counts, n_dp[0])
    check(no_plain(counts),
          f"{tag}: a plain loop or the plain DP ran on the card during the run")
    check_fold(tag, counts)
    check_minhash(tag, counts, match=True)
    for step in ("obt-overlap", "utg-overlap", "adjust"):
        check(k1_in.get(step, 0) > 0, f"{tag}: kernel K1 never launched in {step}")
    check(len(adjust_pre) == 1 and not adjust_pre[0]["orient"],
          f"{tag}: the OEA adjust's verify made no K7 group of given orientations")
    verify_err = held_verify_calls(f"phase {tag}'s OEA adjust", adjust_pre, [])
    del adjust_pre
    if n_links[0]:
        check(k1_in.get("align_links", 0) > 0, f"{tag}: align_links never launched K1")
    check(os.path.exists(os.path.join(wd, "asm.contigs.fasta")), f"{tag}: no contigs FASTA")

    # where the time went
    with open(os.path.join(wd, "asm.stage-times.jsonl")) as fh:
        lines = [json.loads(ln) for ln in fh]
    walls = {r["stage"]: r["wall_s"] for r in lines if "wall_s" in r}
    oea_sub = [r for r in lines if r["stage"] == "oea.sub"][-1]
    dp_s = {k: sum(a.elapsed_time(b) for a, b in v) / 1e3 for k, v in dp_ev.items()}
    log(f"[{tag} timing] {card}: stage walls {walls}")
    log(f"[{tag} timing] {card}: oea.sub {oea_sub['sub_walls_s']} ({oea_sub['changed_reads']} "
        f"reads changed); RED {chunks_in.get('red', 0)} vote chunks in {len(dp_ev['red'])} DP "
        f"groups, DP {dp_s['red']:.3f} s; polish {chunks_in.get('polish', 0)} vote chunks in "
        f"{len(dp_ev['polish'])} DP groups, DP {dp_s['polish']:.3f} s (DP by CUDA events; one K4 "
        "launch a group)")
    # K1 in the OEA adjust: every launch with CUDA events beside its bound
    k1_launches = [k1_call(c) for c in adjust_calls]
    del adjust_calls
    k1_ms, k1_bounds = time_k1(k1_launches)
    del k1_launches
    for i, (ms, bd) in enumerate(zip(k1_ms, k1_bounds)):
        log(f"[{tag} timing] {card}: OEA adjust K1 launch {i + 1}/{len(k1_ms)}: {ms:.3f} ms; "
            f"bound {bd['bound_ms']:.3f} ms ({bd['ops']:.3e} operations, {bd['bytes']:.3e} "
            f"bytes; bound by {bd['bound_by']}; {100 * bd['bound_ms'] / ms:.1f}% of it)")
    log(f"[{tag} timing] {card}: OEA adjust K1 {len(k1_ms)} launches, {sum(k1_ms):.3f} ms; "
        f"bound {sum(b['bound_ms'] for b in k1_bounds):.3f} ms")
    log(f"[{tag} memory] {card}: device peak over the assembly phase "
        f"{mem['peak'] / 1e9:.3f} GB ({(mem['peak'] - mem['start']) / 1e9:.3f} GB above the "
        f"{mem['start'] / 1e9:.3f} GB allocated at its start); by step, above its start: "
        + ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in step_peak.items()))

    # what came out
    contigs = list(read_fastx(os.path.join(wd, "asm.contigs.fasta")))
    lens = sorted((len(r.seq) for r in contigs), reverse=True)
    check(len(contigs) >= 1, f"{tag}: no contig")
    lc = largest_contig_identity(wd, "asm", genome, dev)
    ident, breaks = lc["identity"], lc["misjoins"]
    digests = assembly_digests(wd, "asm", corr)
    n_l = digests["gfa"]["l_lines"]
    log(f"[{tag} assemble] {len(contigs)} contigs, largest {lens[0]}, NG50 "
        f"{ng50(lens, genome_len)} (genome {genome_len}); largest contig's identity to the "
        f"simulated genome {ident:.6f} ({breaks} misjoins between its 5 kb anchors); "
        f"{digests['unassembled']['n']} unassembled; GFA "
        f"{digests['gfa']['n'] - n_l} S-lines, {n_l} L-lines ({n_links[0]} links re-aligned); "
        f"RED corrected {digests['red']['n']} bases in {len(corr)} reads")
    log(f"[{tag} assemble] truth: the largest contig's identity {ident:.6f} is "
        + ("at or above" if ident >= TRUTH_IDENTITY else "BELOW")
        + f" tests/test_pipeline.py's {TRUTH_IDENTITY} (reported, not gated)")
    if ref is not None:
        want = ref["largest_contig"]
        log(f"[{tag} assemble] largest contig {lc} (reference {want})")
        check(lc == want, f"{tag}: the largest contig's length, identity or misjoins differ "
                          "from the JAX package's")
        for key, want in ref["gates"].items():
            got = digests.get(key)
            log(f"[{tag} assemble] {key}: {got} (reference {want})")
            check(got == want, f"{tag}: {key} differs from the JAX package's")
        log(f"[{tag} assemble] every gate equals the JAX package's: "
            + ", ".join(ref["gates"]))
    log(f"[{tag} assemble] phase wall {time.time() - t_phase:.1f} s")
    return {"run_s": t_run, "stage_walls_s": walls, "oea_sub": oea_sub, "launches": counts,
            "dp_calls": n_dp[0], "dp_chunks": dp_chunks,
            "k1_by_step": k1_in, "vote_chunks": chunks_in, "dp_s": dp_s,
            "adjust_k1_ms": k1_ms, "adjust_k1_bounds": k1_bounds, "peak_bytes": mem["peak"],
            "start_bytes": mem["start"], "step_peak_bytes": dict(step_peak), "contigs": lens,
            "ng50": ng50(lens, genome_len), "identity": ident, "misjoins": breaks,
            "truth_met": ident >= TRUTH_IDENTITY,
            "digests": digests, "links_aligned": n_links[0], "work": wd, "fasta": fasta,
            "genome_len": genome_len, "verify_err": verify_err, "phase_s": time.time() - t_phase}


def gfa_link_check(dev) -> dict:
    """write_gfa with verify_edges on the card, on test_gfa.py's case where
    a link between tig end reads survives align_links (the assemble runs
    keep no L-line, in canu_tpu too: ROADMAP §3(g)): K1 must launch in
    align_links, at least one L-line must survive, and the page must equal
    the port's on the CPU (the plain loop; tests/test_torch_gfa.py holds
    that to canu_tpu's)."""
    import torch

    import canu_tpu_torch.io.gfa as GFA
    import canu_tpu_torch.ops.align as AL
    import canu_tpu_torch.stores.overlaps as OV
    import canu_tpu_torch.stores.tigs as TG
    from canu_tpu_torch.ops.kernels import myers_cuda as K1

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_cases import GFA_STORE_ROWS, gfa_cases, gfa_store, gfa_tigs

    seqs, _ = gfa_cases()[0]
    pages, launches = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gfa_") as tmp:
        for d in (dev, torch.device("cpu")):
            k0 = K1.LAUNCHES
            path = os.path.join(tmp, f"{d.type}.gfa")
            GFA.write_gfa(path, gfa_tigs(TG, seqs), None, store=gfa_store(AL, OV, GFA_STORE_ROWS, 40),
                          verify_edges=True, device=d)
            launches[d.type] = K1.LAUNCHES - k0
            with open(path) as fh:
                pages[d.type] = fh.read()
    n_l = pages["cuda"].count("\nL\t")
    log(f"[11 gfa] write_gfa(verify_edges=True) on the card: {n_l} L-lines kept, "
        f"{launches['cuda']} K1 launches in align_links; page equals the CPU's: "
        f"{pages['cuda'] == pages['cpu']}")
    check(launches["cuda"] > 0, "11 gfa: align_links launched no K1 on the card")
    check(n_l >= 1, "11 gfa: no L-line survived the re-alignment")
    check(pages["cuda"] == pages["cpu"], "11 gfa: the card's GFA differs from the CPU's")
    return {"l_lines": n_l, "k1_launches": launches["cuda"]}


def assemble_drive(dev, card: str) -> dict:
    """Phase 11: run_pipeline from corrected reads to contigs, twice, each
    run's every gate held against its entry of assembly_reference.json.
    11a: the reduced genome with planted repeats, at
    least 2 contigs, and links between them re-aligned by align_links on
    K1; then gfa_link_check.  11b: the bench genome at full size, held
    also by well-formed outputs.  Then python -m canu_tpu_torch on 11b's
    directory, where every stage must skip by resume, and -options."""
    import numpy as np

    from canu_tpu_torch.stores.overlaps import OverlapStore

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_cases import ASSEMBLY_RUNS

    with open(os.path.join(ROOT, "canu_tpu_torch", "assembly_reference.json")) as fh:
        ref = json.load(fh)
    check(all(ref[r]["genome"] == ASSEMBLY_RUNS[r][0] for r in ASSEMBLY_RUNS),
          "11: the references are of other genome sizes")
    check(ASSEMBLY_RUNS["b"][:2] == (BENCH_GENOME, 42), "11b is not the bench genome")
    a = assemble_run("a", dev, card, *ASSEMBLY_RUNS["a"], ref["a"])
    check(len(a["contigs"]) >= 2, "11a: the repeats did not break the assembly into contigs")
    # the links between contig ends go through align_links and K1; none
    # re-aligns on the polished contigs (PERF.md §6), in canu_tpu too:
    # the GFA gate above holds the L-lines to the reference's
    check(a["links_aligned"] >= 1 and a["k1_by_step"].get("align_links", 0) > 0,
          "11a: the GFA found no link between contigs, or align_links never launched K1")
    gfa = gfa_link_check(dev)

    b = assemble_run("b", dev, card, *ASSEMBLY_RUNS["b"], ref["b"])
    wd = b["work"]
    with open(os.path.join(wd, "asm.contigs.gfa")) as fh:
        gl = [ln.split("\t") for ln in fh.read().splitlines()]
    s_names = {f[1] for f in gl if f[0] == "S"}
    check(all(f[1] in s_names and f[3] in s_names for f in gl if f[0] == "L"),
          "11b: a GFA L-line names a segment that is not an S-line")
    st = OverlapStore.load(os.path.join(wd, "unitigging", "asm.ovlStore"))
    with open(os.path.join(wd, "asm.layout.tsv")) as fh:
        ids = np.array([int(ln.split("\t")[1]) for ln in fh.read().splitlines()], np.int64)
    check(len(ids) > 0 and ids.min() >= 1 and ids.max() <= st.n_reads,
          "11b: a layout.tsv read id is not in the utg store")
    log(f"[11b assemble] GFA: {len(s_names)} S-lines, every L-line names two of them; "
        f"layout.tsv: {len(ids)} placements of reads 1..{st.n_reads} of the utg store")

    # the CLI on 11b's directory: every stage skips by resume
    with open(os.path.join(wd, "asm.stage-times.jsonl")) as fh:
        n_lines = len(fh.readlines())
    t = time.time()
    r = subprocess.run([sys.executable, "-m", "canu_tpu_torch", "-p", "asm", "-d", wd,
                        f"genomeSize={BENCH_GENOME}", "-corrected", b["fasta"]],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    t_cli = time.time() - t
    out = r.stdout + r.stderr
    skipped = out.count("already done, skipping") + out.count("phase complete, skipping")
    with open(os.path.join(wd, "asm.stage-times.jsonl")) as fh:
        n_after = len(fh.readlines())
    log(f"[11 cli] python -m canu_tpu_torch on 11b's directory: rc {r.returncode} in "
        f"{t_cli:.1f} s; {skipped} skips; stage starts {out.count(': start (attempt')}")
    check(r.returncode == 0, f"11 cli: exit {r.returncode}: {out[-2000:]}")
    check(": start (attempt" not in out and n_after == n_lines and skipped > 0,
          "11 cli: a stage ran again on a finished directory")
    r = subprocess.run([sys.executable, "-m", "canu_tpu_torch", "-options"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    check(r.returncode == 0 and "genomeSize" in r.stdout, "11 cli: -options lacks genomeSize")
    log("[11 cli] -options lists genomeSize")
    return {"a": a, "b": b, "gfa": gfa, "cli_s": t_cli}


def dag_correct(dev, card: str, correct: dict, ref: dict) -> dict:
    """Phase 12a: correction_phase with corConsensus=dag on a copy of phase
    10's directory without its corrected reads, so the gatekeeper, meryl
    and cor overlap stages resume as done and every block runs through
    the tag-chain consensus; the counts set to 0 just before and read
    just after.  K4 must launch once per path chunk (the paths are the
    vote engine's DP, counted by dagcon.CHUNKS), and no other kernel, no
    plain loop and no plain DP may run on the card.  The blocks
    dag_reference.json covers must equal the JAX package's by digest;
    every record is <read>_corrN."""
    import shutil

    import torch

    from canu_tpu_torch.config import Config
    from canu_tpu_torch.io.fastx import read_fastx
    from canu_tpu_torch.ops import dagcon as DG
    from canu_tpu_torch.ops import falcon as F
    from canu_tpu_torch.pipeline import stages
    from canu_tpu_torch.pipeline.driver import make_ctx
    from canu_tpu_torch.stores.readset import ReadSet

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_cases import corrected_digest

    t_phase = time.time()
    work = tempfile.mkdtemp(prefix="chip_smoke_dag_correct_")
    shutil.copytree(os.path.join(correct["work"], "correction"), os.path.join(work, "correction"))
    d = os.path.join(work, "correction")
    out = os.path.join(d, "bench.correctedReads.fasta.gz")
    os.remove(out)
    shutil.rmtree(os.path.join(d, "blocks"), ignore_errors=True)
    cfg = Config()
    cfg.set("genomeSize", BENCH_GENOME)
    cfg.set("corConsensus", "dag")
    ctx = make_ctx(work, "bench", cfg)

    blocks: dict = {}
    dp_ev: list = []
    mem: dict = {}
    real = {"blocks": F.correct_reads_blocks, "dp": DG.align_positions_lean}

    def capture(*args, **kw):
        torch.cuda.synchronize()
        mem["start"] = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        for bi, items in real["blocks"](*args, **kw):
            blocks[bi] = items
            yield bi, items
        torch.cuda.synchronize()
        mem["peak"] = torch.cuda.max_memory_allocated(dev)

    def dp(*args, **kw):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        res = real["dp"](*args, **kw)
        e1.record()
        dp_ev.append((e0, e1))
        return res

    F.correct_reads_blocks, DG.align_positions_lean = capture, dp
    try:
        reset_counts()
        DG.PROFILE.clear()
        DG.CHUNKS = DG.JOBS = 0
        t = time.time()
        stages.correction_phase(ctx, [correct["fasta"]], device=dev)
        torch.cuda.synchronize()
        t_run = time.time() - t
        counts = read_counts()
    finally:
        F.correct_reads_blocks, DG.align_positions_lean = real["blocks"], real["dp"]
    n_chunks, n_jobs = DG.CHUNKS, DG.JOBS
    log(f"[12a dag correct] {card}: correction_phase with corConsensus=dag on phase 10's "
        f"stores: {t_run:.2f} s; launch counts {counts}")
    check(all(v == 0 for k, v in counts.items() if k in ("K1", "K2", "K3", "K5", "K6")),
          "12a: a kernel launched during the dag correction (the stages before it resume)")
    check_dp("12a", counts, len(dp_ev))
    check(no_plain(counts),
          "12a: a plain loop or the plain DP ran on the card during the dag correction")
    check(n_chunks > 0, "12a: the dag consensus ran no path chunk")
    check(sorted(blocks) == list(range(ref["n_blocks"])),
          f"12a: blocks {sorted(blocks)}, the reference's phase has {ref['n_blocks']}")
    for rb in ref["blocks"]:
        items = blocks[rb["index"]]
        dig = corrected_digest(items)
        log(f"[12a dag correct] block {rb['index']}: {len(items)} reads, "
            f"{sum(len(x) for _, x in items)} bases, sha256 {dig} (reference {rb['reads']}, "
            f"{rb['bases']}, {rb['sha256']})")
        check(dig == rb["sha256"], f"12a: block {rb['index']}'s dag-corrected reads differ from "
              "the JAX package's")
    rs = ReadSet.load(os.path.join(d, "bench.gkpStore"))
    names = {rs.name(i) for i in range(1, rs.n_reads + 1)}
    recs = list(read_fastx(out))
    check(len(recs) > 0 and len(recs) == sum(len(v) for v in blocks.values()),
          "12a: the corrected FASTA is empty or misses reads")
    check(all(r.name.rsplit("_corr", 1)[0] in names and r.name.rsplit("_corr", 1)[1].isdigit()
              for r in recs), "12a: a corrected read is not named <read>_corrN")
    with open(ctx.path("bench.stage-times.jsonl")) as fh:
        walls = {r["stage"]: r["wall_s"] for r in map(json.loads, fh) if "wall_s" in r}
    dp_s = sum(a.elapsed_time(b) for a, b in dp_ev) / 1e3
    prof = {k: round(v, 3) for k, v in DG.PROFILE.items()}
    log(f"[12a timing] {card}: stage walls {walls}; {n_jobs} path jobs in {n_chunks} chunks of "
        f"{DG.votepile.chunk_jobs(F.VOTE_SEG)}, {len(dp_ev)} DP groups (one K4 launch each); DP "
        f"{dp_s:.3f} s (CUDA events); host parts "
        f"{prof} (dagcon.PROFILE: paths, enqueue and fetch, waiting for the device; tags and "
        f"chain, the tags and the tag-chain DP of every segment); {len(recs)} reads, "
        f"{sum(len(r.seq) for r in recs)} bases in {len(blocks)} blocks; blocks "
        f"{ref['blocks_covered']} equal the JAX package's")
    log(f"[12a memory] {card}: device peak over the dag correction {mem['peak'] / 1e9:.3f} GB "
        f"({(mem['peak'] - mem['start']) / 1e9:.3f} GB above its start)")
    return {"run_s": t_run, "stage_walls_s": walls, "launches": counts, "chunks": n_chunks,
            "jobs": n_jobs, "dp_calls": len(dp_ev), "dp_s": dp_s, "host_s": prof,
            "peak_bytes": mem["peak"],
            "start_bytes": mem["start"], "corrected_reads": len(recs),
            "phase_s": time.time() - t_phase}


def dag_polish(dev, card: str, run_a: dict, ref: dict) -> dict:
    """Phase 12b: run_pipeline with cnsConsensus=dag resumed on a copy of
    11a's directory without the consensus and output stages' products:
    only those two stages may run (the stage-times lines and the log say
    which ran).  K4 must launch once per path chunk (the first chunk's
    inputs are kept for phase 12c) and K1 only in the GFA's align_links; no
    other kernel, no plain loop and no plain DP on the card.  Every gate of
    dag_reference.json's polish entry (the JAX package's run of 11a with
    cnsConsensus=dag) must be equal."""
    import shutil

    import torch

    from canu_tpu_torch.config import Config
    from canu_tpu_torch.io import gfa as GFA
    from canu_tpu_torch.ops import dagcon as DG
    from canu_tpu_torch.ops.kernels import myers_cuda as K1
    from canu_tpu_torch.pipeline.driver import run_pipeline

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_cases import assembly_digests

    t_phase = time.time()
    wd = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_dag_polish_"), "asm")
    shutil.copytree(run_a["work"], wd)
    ctg = os.path.join(wd, "unitigging", "asm.ctgStore")
    removed = [f for f in os.listdir(ctg) if f.startswith("v002")]
    removed += [f for f in ("asm.contigs.fasta", "asm.unassembled.fasta", "asm.unitigs.fasta",
                            "asm.layout.tsv", "asm.contigs.gfa") if os.path.exists(
                                os.path.join(wd, f))]
    for f in removed:
        os.remove(os.path.join(ctg if f.startswith("v002") else wd, f))
    check(len(removed) == 7, f"12b: 11a's directory lacks a consensus or output product: "
          f"{removed}")
    with open(os.path.join(wd, "asm.stage-times.jsonl")) as fh:
        n_lines = len(fh.readlines())
    cfg = Config()
    cfg.set("genomeSize", run_a["genome_len"])
    cfg.set("cnsConsensus", "dag")

    dp_ev: list = []
    dp_chunk: list = []  # the first path chunk, held to the plain DP in 12c
    mem: dict = {}
    k1_links = [0]
    real = {"dp": DG.align_positions_lean, "links": GFA.align_links}

    def dp(*args, **kw):
        if not dp_chunk:
            dp_chunk.append(keep_call(args, kw))
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        res = real["dp"](*args, **kw)
        e1.record()
        dp_ev.append((e0, e1))
        return res

    def links(*args, **kw):
        k0 = K1.LAUNCHES
        try:
            return real["links"](*args, **kw)
        finally:
            k1_links[0] += K1.LAUNCHES - k0

    DG.align_positions_lean, GFA.align_links = dp, links
    try:
        reset_counts()
        DG.CHUNKS = DG.JOBS = 0
        DG.PROFILE.clear()
        torch.cuda.synchronize()
        mem["start"] = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t = time.time()
        run_pipeline(wd, "asm", cfg, corrected_reads=[run_a["fasta"]], device=dev)
        torch.cuda.synchronize()
        t_run = time.time() - t
        mem["peak"] = torch.cuda.max_memory_allocated(dev)
        counts = read_counts()
    finally:
        DG.align_positions_lean, GFA.align_links = real["dp"], real["links"]
    with open(os.path.join(wd, "asm.stage-times.jsonl")) as fh:
        new = [json.loads(ln) for ln in fh.readlines()[n_lines:]]
    ran = [r["stage"] for r in new if "wall_s" in r]
    log(f"[12b dag polish] {card}: run_pipeline with cnsConsensus=dag resumed on 11a's "
        f"directory: {t_run:.2f} s; stages run {ran}; launch counts {counts}, K1 in "
        f"align_links {k1_links[0]}")
    check(ran == ["consensus", "outputs"], f"12b: the resume ran {ran}, not the consensus and "
          "the outputs alone")
    check(counts["K1"] == k1_links[0] and counts["K2"] == counts["K3"] == counts["K5"]
          == counts["K6"] == 0, "12b: a kernel launched off align_links during the dag polish")
    check_dp("12b", counts, len(dp_ev))
    check(no_plain(counts),
          "12b: a plain loop or the plain DP ran on the card during the dag polish")
    check(DG.CHUNKS > 0, "12b: the dag consensus ran no path chunk")
    digests = assembly_digests(wd, "asm")
    for key, want in ref["gates"].items():
        got = digests.get(key)
        log(f"[12b dag polish] {key}: {got} (reference {want})")
        check(got == want, f"12b: {key} differs from the JAX package's dag run of 11a")
    walls = {r["stage"]: r["wall_s"] for r in new if "wall_s" in r}
    dp_s = sum(a.elapsed_time(b) for a, b in dp_ev) / 1e3
    prof = {k: round(v, 3) for k, v in DG.PROFILE.items()}
    log(f"[12b timing] {card}: stage walls {walls}; {DG.JOBS} path jobs in {DG.CHUNKS} chunks, "
        f"{len(dp_ev)} DP groups; DP {dp_s:.3f} s (CUDA events); host {prof} (dagcon.PROFILE, as in 12a); every gate "
        f"equals the JAX package's: " + ", ".join(ref["gates"]))
    log(f"[12b memory] {card}: device peak over the resumed run {mem['peak'] / 1e9:.3f} GB "
        f"({(mem['peak'] - mem['start']) / 1e9:.3f} GB above its start)")
    return {"run_s": t_run, "stages_run": ran, "stage_walls_s": walls, "launches": counts,
            "k1_align_links": k1_links[0], "chunks": DG.CHUNKS, "jobs": DG.JOBS,
            "dp_calls": len(dp_ev), "dp_chunk": dp_chunk[0], "dp_s": dp_s,
            "host_s": prof, "peak_bytes": mem["peak"], "start_bytes": mem["start"],
            "digests": digests, "phase_s": time.time() - t_phase}


def dag_drive(dev, card: str, correct: dict, assemble: dict) -> dict:
    """Phase 12: the tag-chain consensus, for correction (12a) and for the
    polish (12b), held against dag_reference.json."""
    with open(os.path.join(ROOT, "canu_tpu_torch", "dag_reference.json")) as fh:
        ref = json.load(fh)
    return {"correct": dag_correct(dev, card, correct, ref["correction"]),
            "polish": dag_polish(dev, card, assemble["a"], ref["polish"])}


# E. coli correction's vote chunks (ROADMAP 9(b)), for the DP projection
ECOLI_CHUNKS = 8600


def vote_dp_drive(dev, card: str, correct: dict, assemble: dict, dag: dict) -> dict:
    """Phase 12c: kernel K4 held bit for bit to the plain DP on the card
    (held_dp) on DP calls the main path made, each one K4 launch of a
    group of chunks: the first three of phase 10 (falcon, band 256, 2,048
    rows), the first of 11a's RED and of its polish and the first of 12b's
    dag polish (all with ends_free=True); the first is held whole, the
    others on dp_subset's jobs (each chunk's first and last, seeded others)
    from the full launch.  Then by CUDA events: K4 on phase 10's first
    chunk alone (mean of 10 launches, PR 10's shape) and on its first full
    group (mean of 5), each beside vdp_bound, the whole DP call (anchors,
    K4, positions) of the group, the plain DP's run on the group; the
    per-chunk share of the group and the E. coli projection (per-chunk
    time x ECOLI_CHUNKS)."""
    from canu_tpu_torch.ops import trace as TT
    from canu_tpu_torch.ops.kernels import trace_cuda as K4

    chunk = correct["chunk_jobs"]
    assemble["b"].pop("dp_chunks")
    chunks = [(f"10 group {i + 1}", c) for i, c in enumerate(correct.pop("dp_chunks"))]
    red_polish = assemble["a"].pop("dp_chunks")
    chunks += [(f"11a {k}", red_polish[k]) for k in ("red", "polish") if k in red_polish]
    chunks.append(("12b dag", dag["polish"].pop("dp_chunk")))
    check(len(chunks) == 6, f"12c: {len(chunks)} captured DP calls, expected 3 of phase 10, "
          "11a's RED and polish, 12b's dag")
    err, held = 0, {}
    for k, (name, call) in enumerate(chunks):
        t, _, e, _, band, n_rows, ef = dp_inputs(call)
        e_k, plain_ms, n_held = held_dp(f"12c {name}", call, None if k == 0 else chunk)
        err = max(err, e_k)
        held[name] = {"jobs": t.shape[0], "held_jobs": n_held, "band": band, "n_rows": n_rows,
                      "ends_free": ef, "evidence_cols": e.shape[1], "plain_ms": plain_ms}
        how = ("all of them" if n_held == t.shape[0] else
               f"{n_held} of them (each chunk of {chunk}'s first and last, seeded others up to "
               f"{HELD_JOBS}; dp_subset), K4's rows from the full launch")
        log(f"[12c vote_dp] {name}: one K4 launch of {t.shape[0]} jobs x {n_rows} rows, band "
            f"{band}, ends_free {ef}: bit-equal to the plain DP (j* and edits) on {how}; plain "
            f"{plain_ms:.1f} ms")
    name, call = chunks[0]
    t, tl, e, el, band, n_rows, ef = dp_inputs(call)
    B = t.shape[0]
    A = TT._anchors(tl, el, band, n_rows)
    one = tuple(x[:chunk].contiguous() for x in (t, tl, e, el, A))
    ms1 = cuda_ms(lambda: K4.vote_dp_keys(*one, band, n_rows, ef), 10)
    ms = cuda_ms(lambda: K4.vote_dp_keys(t, tl, e, el, A, band, n_rows, ef), 5)
    call_ms = cuda_ms(lambda: TT.align_positions_lean(*call[0], **call[1]), 5)
    plain_ms = held[name]["plain_ms"]
    bd1 = vdp_bound(((one[0], one[1], one[2], one[3], band, n_rows), {"ends_free": ef}))
    bd = vdp_bound(call)
    n_ch = -(-B // chunk)
    per_chunk = ms / n_ch
    log(f"[12c timing] {card}: K4 on phase 10's first chunk alone ({chunk} jobs x {n_rows} rows, "
        f"band {band}): {ms1:.3f} ms (CUDA events, mean of 10; bound {bd1['bound_ms']:.3f} ms, "
        f"{100 * bd1['bound_ms'] / ms1:.1f}% of it); on its first full group (one launch of "
        f"{B} jobs, {n_ch} chunks): {ms:.3f} ms (mean of 5), {per_chunk:.3f} ms a chunk; bound "
        f"{bd['bound_ms']:.3f} ms ({bd['ops']:.3e} operations on {bd['cells']} cells of "
        f"{bd['live_rows']} live rows, {bd['bytes']:.3e} bytes; bound by {bd['bound_by']}; "
        f"{100 * bd['bound_ms'] / ms:.1f}% of it); the whole DP call (anchors, K4, positions) "
        f"{call_ms:.3f} ms; the plain DP on the group {plain_ms:.1f} ms; scratch "
        f"{K4.scratch_bytes(B, band, n_rows) / 1e6:.1f} MB ({K4.scratch_bytes(1, band, n_rows)} "
        f"bytes a job)")
    log(f"[12c projection] {card}: E. coli correction's DP, {ECOLI_CHUNKS} chunks at the group's "
        f"{per_chunk:.3f} ms a chunk: {ECOLI_CHUNKS * per_chunk / 1e3:.2f} s (at the lone chunk's "
        f"{ms1:.3f} ms: {ECOLI_CHUNKS * ms1 / 1e3:.2f} s)")
    return {"err": err, "held": held, "ms": ms, "ms_chunk": ms1, "ms_per_chunk": per_chunk,
            "group_jobs": B, "group_chunks": n_ch, "call_ms": call_ms, "plain_ms": plain_ms,
            "bound": bd, "bound_chunk": bd1, "ecoli_dp_s": ECOLI_CHUNKS * per_chunk / 1e3}


def tools_drive(dev, card: str, run_b: dict) -> dict:
    """Phase 13: canu_tpu_torch.tools.main in this process on the scripted
    session of tests/torch_cases.py tools_session (the bench genome's
    size), the counts set to 0 just before and read just after each step:
    every step's exit code, stdout, stderr and files must equal
    tools_reference.json; K1 must launch in bogus and nowhere else, no
    other kernel and no plain loop on the card.  Prints bogus's verdict,
    each K1 launch of it by CUDA events beside its bound (k1_bound), then
    tig-dump, tig-display and tig-coverage on 11b's tig store and bogus
    on 11b's contigs against its genome (printed, not gated)."""
    import contextlib

    import torch

    from canu_tpu_torch.io.fastx import write_fasta
    from canu_tpu_torch.ops import myers as MY
    from canu_tpu_torch.ops.kernels import myers_cuda as K1
    from canu_tpu_torch.sim.simulate import random_genome
    from canu_tpu_torch.stores.readset import ReadSet
    from canu_tpu_torch.tools.__main__ import main as tools_main
    from canu_tpu_torch.utils.bitpack import codes_to_seq

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_cases import TOOLS_DB22_STEPS, TOOLS_GENOME, run_tools_session, tools_run

    with open(os.path.join(ROOT, "canu_tpu_torch", "tools_reference.json")) as fh:
        ref = json.load(fh)
    check(ref["genome"] == TOOLS_GENOME, "13: the reference is of another genome size")
    t_phase = time.time()
    work = tempfile.mkdtemp(prefix="chip_smoke_tools_")
    per_step: dict = {}
    bogus_calls: list = []
    bogus_ext: list = []  # bogus's first extension call, for K10 and K1 with the pick
    real_rows, real_ext = MY._rows_kernel, MY.banded_extend_myers

    def rows(*args, **kw):
        bogus_calls.append((args, kw))
        return real_rows(*args, **kw)

    def ext(*args, **kw):
        if not bogus_ext:
            bogus_ext.append((args, kw))
        return real_ext(*args, **kw)

    @contextlib.contextmanager
    def counted(name):
        reset_counts()
        MY._rows_kernel = rows if name == "bogus" else real_rows
        MY.banded_extend_myers = ext if name == "bogus" else real_ext
        try:
            yield
        finally:
            torch.cuda.synchronize()
            MY._rows_kernel, MY.banded_extend_myers = real_rows, real_ext
            per_step[name] = read_counts()

    t = time.time()
    recs, secs, outs = run_tools_session(work, TOOLS_GENOME, tools_main, ReadSet, counted,
                                         device=dev)
    t_run = time.time() - t
    n_bad = 0
    for name, rec in recs.items():
        want = ref["steps"][name]
        same = rec == want
        n_bad += not same
        log(f"[13 tools] {name}: rc {rec['rc']}, {secs[name]:.2f} s, "
            f"{len(rec['files'])} files; " + ("equal to the JAX package's" if same else
                                             f"DIFFERS: {rec} against {want}")
            + (" (its k=22 DB as saved: canu_tpu's in-memory result)"
               if name in TOOLS_DB22_STEPS else ""))
    check(n_bad == 0, f"13: {n_bad} tools steps differ from the JAX package's")
    k1_steps = {n: c["K1"] for n, c in per_step.items() if c["K1"]}
    others = {n: c for n, c in per_step.items()
              if c["K2"] or c["K3"] or c["K4"] or not no_plain(c)}
    log(f"[13 tools] {card}: {len(recs)} steps in {t_run:.1f} s, every one equal to the JAX "
        f"package's; K1 launches by step {k1_steps}")
    check(k1_steps.get("bogus", 0) > 0 and set(k1_steps) == {"bogus"},
          "13: K1 did not launch in bogus, or launched in another step")
    check(all(c["K10"] == c["K11_pick"] == c["K1"] and c["K11"] == 0
              for c in per_step.values()),
          "13: K10 did not launch once beside each K1 launch with the end pick, or K11 alone")
    check(not others, f"13: another kernel or a plain loop ran on the card: {others}")
    log("[13 tools] bogus: " + outs["bogus"].splitlines()[0])
    check(len(bogus_ext) == 1, "13: bogus never called banded_extend_myers")
    (j_args, j_kw), = bogus_ext
    err_ends = held_myers_ends("13 bogus", j_args[:5], j_args[6], j_kw)["err"]
    del bogus_ext
    log(f"[13 kernel] K10 and K1 with the end pick bit-equal to the plain chain on bogus's "
        f"launch ({j_args[0].shape[0]} pieces x {j_args[6]} rows, centres at stride "
        f"{j_kw.get('center_stride', 1)})")
    k1_launches = [k1_call(c) for c in bogus_calls]
    del bogus_calls
    k1_ms, k1_bounds = time_k1(k1_launches)
    k1_err, k1_plain_ms = 0, []
    for i, ((args, live), ms, bd) in enumerate(zip(k1_launches, k1_ms, k1_bounds)):
        log(f"[13 timing] {card}: bogus K1 launch {i + 1}/{len(k1_ms)}: {args[1].shape[0]} "
            f"pieces x {args[6]} rows: {ms:.3f} ms; bound {bd['bound_ms']:.3f} ms "
            f"({bd['ops']:.3e} operations: {bd['live_rows']} live rows, {bd['shift_rows']} "
            f"shifted, {bd['bx_rows']} with b_len in the window; {bd['bytes']:.3e} bytes; "
            f"bound by {bd['bound_by']}; {100 * bd['bound_ms'] / ms:.1f}% of it)")
        t = time.time()
        err, plain_ms, n_seg = k1_held_to_plain(f"13 bogus K1 launch {i + 1}", args)
        k1_err = max(k1_err, err)
        k1_plain_ms.append(plain_ms)
        log(f"[13 kernel] {card}: bogus K1 launch {i + 1}: every one of its {args[6]} rows held "
            f"to the plain loop, in {n_seg} segments of 4,096 rows run at once from K1's carry "
            f"at each segment start: every carry, edits, a_used and b_used bit-equal (max |diff| "
            f"{err}); plain rows {plain_ms:.1f} ms (CUDA events) vs K1 {ms:.3f} ms; "
            f"{time.time() - t:.1f} s with K1's {n_seg} launches to the segment starts")
    del k1_launches

    # 11b's tig store and contigs: printed, not gated
    ctg = os.path.join(run_b["work"], "unitigging", "asm.ctgStore")
    for argv in (["tig-dump", ctg, "sizes"], ["tig-display", ctg, "1"],
                 ["tig-coverage", ctg]):
        rc, out, err = tools_run(tools_main, argv, device=dev)
        log(f"[13 tools] {' '.join(argv[:1] + argv[2:])} on 11b's tig store: rc {rc}; "
            f"{(out + err).strip()[:600]}")
    genome = os.path.join(work, "bench_genome.fasta")
    write_fasta(genome, [("genome", codes_to_seq(random_genome(BENCH_GENOME, seed=42)))])
    k0 = K1.LAUNCHES
    t = time.time()
    rc, out, err = tools_run(tools_main, ["bogus", "-genome", genome, "-assembly",
                                          os.path.join(run_b["work"], "asm.contigs.fasta"),
                                          "-circular", "-verbose"], device=dev)
    torch.cuda.synchronize()
    k1_11b = K1.LAUNCHES - k0
    log(f"[13 tools] bogus on 11b's contigs against the bench genome (not gated): rc {rc} in "
        f"{time.time() - t:.1f} s, K1 {k1_11b} launches; {out.strip()[:800]}")
    return {"run_s": t_run, "step_s": secs, "k1_by_step": k1_steps, "k1_ms": k1_ms,
            "k1_bounds": k1_bounds, "k1_err": k1_err, "myers_ends_err": err_ends,
            "k1_plain_ms": k1_plain_ms,
            "bogus": outs["bogus"], "bogus_11b": out,
            "k1_launches": sum(k1_steps.values()) + k1_11b, "phase_s": time.time() - t_phase}


def capture_results(module, name: str):
    """Wrap module.<name> so each call's result is kept in the returned
    list; the caller restores the original afterwards."""
    real = getattr(module, name)
    seen: list = []

    def wrapper(*args, **kw):
        out = real(*args, **kw)
        seen.append(out)
        return out

    setattr(module, name, wrapper)
    return real, seen


def stage_walls():
    """Wrap stages.run_stage to time each stage this process runs (host
    clock, barriers included): returns (real run_stage, {stage: seconds})."""
    from canu_tpu_torch.pipeline import stages

    real, walls = stages.run_stage, {}

    def timed_stage(ctx, name, done, fn, **kw):
        t = time.time()
        try:
            return real(ctx, name, done, fn, **kw)
        finally:
            walls[name] = walls.get(name, 0.0) + time.time() - t

    stages.run_stage = timed_stage
    return real, walls


def collective_stats() -> dict:
    """parallel.launch.STATS as {collective: {calls, bytes, s}}."""
    from canu_tpu_torch.parallel import launch

    return {k: {"calls": v[0], "bytes": v[1], "s": v[2]} for k, v in launch.STATS.items()}


def grid_world_of_one(dev, card: str, fasta: str, ref: dict, work: str) -> dict:
    """Phase 14a: a world of one rank over NCCL on this card
    (parallel.launch.init_distributed with a FileStore), the cor
    gatekeeper, meryl and overlap stages with shardedCompute=true, the
    counts set to 0 just before and read just after: the hash-range
    meryl's all_to_all on NCCL, the ring (one step), K1 in the verify and
    no other kernel, no plain loop on the card; the frequent table,
    candidates and store equal cor_overlap_reference.json.  Then the k=22
    sharded count against the single-device counter, and one
    sharded_verify_candidates (K2 at band 128) on every third candidate,
    held bit for bit to the same call with the plain INF-walled loop in
    K2's place (ops.align.banded_extend_plain on the card, on the same
    inputs), whose rows 14b's ranks must give too (saved to
    work/sample.npz); K2 alone on each of its launches by CUDA events
    beside extend_bound to the exit rows."""
    import numpy as np
    import torch

    from canu_tpu_torch.config import Config
    from canu_tpu_torch.ops import align as AL
    from canu_tpu_torch.ops import kmer as KM
    from canu_tpu_torch.parallel import launch
    from canu_tpu_torch.parallel import shard_overlap as SO
    from canu_tpu_torch.pipeline import stages
    from canu_tpu_torch.pipeline.driver import make_ctx

    t_phase = time.time()
    got = launch.init_distributed("file://" + os.path.join(work, "store14a"), 1, 0, device=dev)
    check(got == (0, 1) and launch.backend() == "nccl",
          f"14a: the world of one did not join over NCCL: {got}, {launch.backend()}")
    cfg = Config()
    cfg.set("genomeSize", "300k")
    cfg.set("shardedCompute", "true")
    ctx = make_ctx(os.path.join(work, "one"), "bench", cfg)
    real_ring, rings = capture_results(SO, "sharded_find_candidates")
    real_stage, walls = stage_walls()
    try:
        reset_counts()
        launch.STATS.clear()
        t = time.time()
        rs = stages.gatekeeper(ctx, "cor", [fasta])
        fk = stages.meryl(ctx, "cor", rs, device=dev)
        meryl_stats = collective_stats()
        st = stages.overlap(ctx, "cor", rs, fk, device=dev)
        torch.cuda.synchronize()
        t_run = time.time() - t
        counts = read_counts()
        stats = collective_stats()
    finally:
        SO.sharded_find_candidates, stages.run_stage = real_ring, real_stage
    prof = dict(AL.LAST_PROFILE)
    log(f"[14a grid] {card}: a world of one over {launch.backend()}: gatekeeper + meryl + "
        f"overlap (cor, shardedCompute=true) {t_run:.2f} s; stage walls "
        + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items())
        + f"; launch counts {counts}; collectives {stats}")
    check(meryl_stats.get("all_to_all", {}).get("calls", 0) >= 1,
          "14a: the sharded meryl never ran its all_to_all on NCCL")
    check(len(rings) == 1, "14a: the overlap stage never ran the ring")
    check(counts["K1"] > 0, "14a: kernel K1 never launched during the stages")
    check(counts["K2"] == counts["K3"] == counts["K4"] == 0,
          "14a: kernel K2, K3 or K4 launched off its path")
    check(no_plain(counts),
          "14a: a plain loop ran on the card during the stages")
    check_minhash("14a", counts, match=True)
    fdig = frequent_digest(os.path.join(ctx.work_dir, "correction", "bench.ms16.frequent.npz"))
    check_store("14a grid", st, prof, fdig, ref)
    pairs = rings[0]

    # the two-lane sharded count against the single-device counter
    t = time.time()
    kc22 = SO.sharded_count_readset(rs, k=22, device=dev)
    t22 = time.time() - t
    one = KM.count_readset_device(rs, k=22, device=dev).to_host()
    order = np.argsort(one.unique, kind="stable")
    check(np.array_equal(kc22.unique, one.unique[order])
          and np.array_equal(kc22.counts, one.counts[order]),
          "14a: the k=22 sharded count differs from the single-device counter")
    log(f"[14a grid] sharded k=22 count: {len(kc22.unique)} distinct k-mers, {t22:.2f} s, "
        "equal to the single-device counter")

    # the INF-walled sharded verify in a world of one: the rows 14b holds
    sample = np.ascontiguousarray(pairs[::3, :2])
    reset_counts()
    real_extend, k2_calls = capture_calls(AL, "banded_extend")
    try:
        rows, verify_ms = once_ms(lambda: SO.sharded_verify_candidates(rs, sample, k=16,
                                                                       band=128, device=dev))
    finally:
        AL.banded_extend = real_extend
    k2 = read_counts()["K2"]
    check(k2 > 0 and k2 == len(k2_calls), "14a: sharded_verify_candidates never launched K2, "
          "or not once per banded_extend call")
    # the same call with the plain loop in K2's place (not counted)
    real_extend, AL.banded_extend = AL.banded_extend, AL.banded_extend_plain
    try:
        plain, plain_ms = once_ms(lambda: SO.sharded_verify_candidates(rs, sample, k=16,
                                                                       band=128, device=dev))
    finally:
        AL.banded_extend = real_extend
    check(plain.shape == rows.shape == (len(sample), 13),
          f"14a: sharded verify rows {rows.shape}, plain {plain.shape}")
    k2_err = int(np.abs(rows.astype(np.int64) - plain.astype(np.int64)).max(initial=0))
    check(k2_err == 0, f"14a: the sharded verify's rows on K2 differ from the plain loop's "
          f"(max |diff| {k2_err})")
    np.savez(os.path.join(work, "sample.npz"), pairs=sample, rows=rows, all_pairs=pairs)
    log(f"[14a grid] sharded_verify_candidates on {len(sample)} of the {len(pairs)} "
        f"candidates: {verify_ms:.1f} ms (CUDA events), K2 launches {k2}; the plain loop in "
        f"its place {plain_ms:.1f} ms, rows equal (max |diff| {k2_err}, tolerance 0)")
    # K2 alone on the call's launches, beside its bound up to each
    # extension's exit row (torch_cases.extend_exit_rows)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_cases import extend_exit_rows

    k2_ms, k2_bounds = [], []
    for args, _ in k2_calls:
        a5, (band, n_rows) = args[:5], args[5:7]
        exit_rows = extend_exit_rows(*a5, band, n_rows)[0]
        k2_ms.append(cuda_ms(lambda: extend_kernel(band)[1](*a5, band, n_rows), 3))
        k2_bounds.append(extend_bound(a5, band, n_rows, exit_rows))
        bd = k2_bounds[-1]
        log(f"[14a timing] {card}: sharded_verify_candidates' K2 launch {len(k2_ms)}: "
            f"{a5[0].shape[0]} extensions x {n_rows} rows, band {band}: {k2_ms[-1]:.3f} ms; "
            f"bound {bd['bound_ms']:.4f} ms to the exit rows ({bd['ops']:.3e} operations, "
            f"{bd['bytes']:.3e} bytes; bound by {bd['bound_by']}; "
            f"{100 * bd['bound_ms'] / k2_ms[-1]:.1f}% of it)")
    del k2_calls
    launch.shutdown()
    return {"run_s": t_run, "stage_walls_s": walls, "launches": counts, "collectives": stats,
            "k22_distinct": len(kc22.unique), "k22_s": t22, "sample": len(sample),
            "verify_ms": verify_ms, "verify_plain_ms": plain_ms, "k2_err": k2_err,
            "k2_launches": k2, "k2_ms": k2_ms, "k2_bounds": k2_bounds,
            "phase_s": time.time() - t_phase}


def grid_rank(rank: str, world: str, url: str, work: str, fasta: str, backend: str) -> int:
    """Phase 14b, one rank (a process of its own, jax and canu_tpu blocked):
    joins the world over ``backend`` on card rank % cards (cuda:0 for
    every rank of a one-card machine), runs correction_phase from the FASTA
    (Config() + genomeSize=300k) in work/range, then the cor meryl and
    overlap stages under ovsShardExchange=allgather in work/allgather,
    then sharded_verify_candidates on 14a's sample; writes what it saw to
    work/rank<r>.json."""
    import numpy as np
    import torch

    from canu_tpu_torch.config import Config
    from canu_tpu_torch.ops import falcon as F
    from canu_tpu_torch.ops import votepile as VP
    from canu_tpu_torch.parallel import launch
    from canu_tpu_torch.parallel import shard_overlap as SO
    from canu_tpu_torch.pipeline import stages
    from canu_tpu_torch.pipeline.driver import make_ctx
    from canu_tpu_torch.stores.overlaps import OverlapStore, store_digest
    from canu_tpu_torch.stores.readset import ReadSet

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_cases import corrected_digest

    r, n = int(rank), int(world)
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // n))
    dev = torch.device("cuda", r % torch.cuda.device_count())
    t = time.time()
    got = launch.init_distributed(url, n, r, backend=backend, device=dev)
    check(got == (r, n), f"14b rank {r}: joined as {got}")
    out: dict = {"rank": r, "join_s": time.time() - t}
    log(f"[14b rank {r}] joined a world of {n} over {launch.backend()} on {dev} in "
        f"{out['join_s']:.2f} s")

    # correction_phase: blocks this rank corrected, the DP by CUDA events,
    # the memory peak, the stage walls and the collectives
    blocks: dict = {}
    dp: list = []
    real = {"blocks": F.correct_reads_blocks, "dp": VP.align_positions_lean,
            "ring": SO.sharded_find_candidates}

    def capture(*args, **kw):
        for bi, items in real["blocks"](*args, **kw):
            blocks[bi] = items
            yield bi, items

    def timed_dp(*args, **kw):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        res = real["dp"](*args, **kw)
        e1.record()
        dp.append((e0, e1))
        return res

    cfg = Config()
    cfg.set("genomeSize", BENCH_GENOME)
    ctx = make_ctx(os.path.join(work, "range"), "bench", cfg)
    F.correct_reads_blocks, VP.align_positions_lean = capture, timed_dp
    real_ring, rings = capture_results(SO, "sharded_find_candidates")
    real_stage, walls = stage_walls()
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        launch.STATS.clear()
        t = time.time()
        stages.correction_phase(ctx, [fasta], device=dev)
        torch.cuda.synchronize()
        out["correction_phase_s"] = time.time() - t
        out["launches"] = read_counts()
        out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        out["collectives"] = collective_stats()
    finally:
        F.correct_reads_blocks, VP.align_positions_lean = real["blocks"], real["dp"]
        SO.sharded_find_candidates, stages.run_stage = real["ring"], real_stage
    out["stage_walls_s"] = walls
    out["dp_calls"] = len(dp)
    out["dp_s"] = sum(a.elapsed_time(b) for a, b in dp) / 1e3
    out["blocks"] = {bi: {"reads": len(items), "bases": sum(len(s) for _, s in items),
                          "sha256": corrected_digest(items)} for bi, items in blocks.items()}
    d = os.path.join(ctx.work_dir, "correction")
    st = OverlapStore.load(os.path.join(d, "bench.ovlStore"))
    out["store"] = {"rows": len(st), "sha256": store_digest(st),
                    "frequent_sha256": frequent_digest(os.path.join(d, "bench.ms16.frequent.npz"))}
    sample = np.load(os.path.join(work, "sample.npz"))
    check(len(rings) == 1 and np.array_equal(rings[0], sample["all_pairs"]),
          f"14b rank {r}: the ring's candidates differ from the world of one's")
    out["n_candidates"] = len(rings[0])
    if r == 0:
        from canu_tpu_torch.io.fastx import read_fastx

        rs0 = ReadSet.load(os.path.join(d, "bench.gkpStore"))
        names = {rs0.name(i) for i in range(1, rs0.n_reads + 1)}
        recs = list(read_fastx(os.path.join(d, "bench.correctedReads.fasta.gz")))
        out["corrected_reads"] = len(recs)
        out["names_ok"] = all(x.name.rsplit("_corr", 1)[0] in names
                              and x.name.rsplit("_corr", 1)[1].isdigit() for x in recs)
    log(f"[14b rank {r}] correction_phase {out['correction_phase_s']:.2f} s; stage walls "
        + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items())
        + f"; DP {out['dp_s']:.3f} s (CUDA events); blocks {sorted(blocks)}; launch counts "
        f"{out['launches']}; device peak {out['peak_bytes'] / 1e9:.3f} GB "
        f"(this process); collectives {out['collectives']}")

    # the cor overlap stage again, every rank holding the whole table
    rs = ReadSet.load(os.path.join(d, "bench.gkpStore"))
    cfg2 = Config()
    cfg2.set("genomeSize", BENCH_GENOME)
    cfg2.set("ovsShardExchange", "allgather")
    ctx2 = make_ctx(os.path.join(work, "allgather"), "bench", cfg2)
    reset_counts()
    t = time.time()
    st2 = stages.overlap(ctx2, "cor", rs, stages.meryl(ctx2, "cor", rs, device=dev), device=dev)
    torch.cuda.synchronize()
    out["allgather"] = {"stage_s": time.time() - t, "launches": read_counts(), "rows": len(st2),
                        "sha256": store_digest(st2)}
    log(f"[14b rank {r}] meryl + overlap under ovsShardExchange=allgather "
        f"{out['allgather']['stage_s']:.2f} s; launch counts {out['allgather']['launches']}")

    # the INF-walled sharded verify on 14a's sample
    reset_counts()
    launch.barrier("verify")
    rows, ms = once_ms(lambda: SO.sharded_verify_candidates(rs, sample["pairs"], k=16, band=128,
                                                            device=dev))
    out["verify"] = {"ms": ms, "launches": read_counts(),
                     "equal": bool(np.array_equal(rows, sample["rows"]))}
    log(f"[14b rank {r}] sharded_verify_candidates on {len(sample['pairs'])} pairs: "
        f"{ms:.1f} ms (CUDA events, its half and the gather); launch counts "
        f"{out['verify']['launches']}; rows equal to the world of one's: {out['verify']['equal']}")
    launch.shutdown()
    with open(os.path.join(work, f"rank{r}.json"), "w") as fh:
        json.dump(out, fh, default=str)
    return 0


# a 14b rank: jax and the JAX package blocked, as main() blocks them
GRID_RANK = ('import sys; sys.modules["jax"] = None; sys.modules["canu_tpu"] = None; '
             'sys.path.insert(0, sys.argv[1]); import chip_smoke; '
             'sys.exit(chip_smoke.grid_rank(*sys.argv[2:]))')


def card_memory_used_mb():
    """The memory in use on every card together (nvidia-smi), MB; None if
    it cannot say."""
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, timeout=10)
        return sum(float(x) for x in q.stdout.split()) if q.returncode == 0 else None
    except (OSError, ValueError, subprocess.TimeoutExpired):
        return None


def grid_drive(dev, card: str, correct: dict) -> dict:
    """Phase 14: the sharded path (canu_tpu_torch.parallel).  14a: a world of
    one rank over NCCL in this process (grid_world_of_one).  14b: one rank
    a card over NCCL on a machine of several cards, else two ranks on the
    one card over gloo (NCCL refuses two ranks on one card), each a process
    of its own started after the kernels were built (grid_rank):
    correction_phase from phase 10's FASTA, the gatekeeper
    writer-only, the hash-range meryl, the ring, each rank verifying a
    strided half of the candidates, the a_id-range exchange into store
    shards merged by rank 0 (save_from_row_shards), the correction blocks
    strided over the ranks.  Gates: the cor frequent table, candidates and
    store equal cor_overlap_reference.json; rank r corrects blocks r,
    r + n, ... (two ranks: 0, 2, 4, 6, 8 and 1, 3, 5, 7), every block equal
    to correction_reference.json; every record <read>_corrN; K1 on each rank;
    no plain loop on the card; the allgather exchange's store equal too;
    sharded_verify_candidates' rows on both ranks equal the world of
    one's, with K2 launched.  The cards' memory in use is sampled
    (nvidia-smi) while the ranks run."""
    import threading

    import torch

    with open(os.path.join(ROOT, "canu_tpu_torch", "cor_overlap_reference.json")) as fh:
        ref = json.load(fh)
    with open(os.path.join(ROOT, "canu_tpu_torch", "correction_reference.json")) as fh:
        cref = json.load(fh)
    t_phase = time.time()
    cards = torch.cuda.device_count()
    n, backend = (cards, "nccl") if cards > 1 else (2, "gloo")
    work = tempfile.mkdtemp(prefix="chip_smoke_grid_")
    one = grid_world_of_one(dev, card, correct["fasta"], ref, work)

    url = "file://" + os.path.join(work, "store14b")
    logs = [os.path.join(OUT_DIR, f"phase14_rank{r}.log") for r in range(n)]
    os.makedirs(OUT_DIR, exist_ok=True)
    samples: list = []
    stop = threading.Event()

    def sample_memory():
        while not stop.is_set():
            samples.append(card_memory_used_mb())
            stop.wait(1.0)

    sampler = threading.Thread(target=sample_memory, daemon=True)
    t = time.time()
    files = [open(p, "w") for p in logs]
    procs = [subprocess.Popen([sys.executable, "-c", GRID_RANK, ROOT, str(r), str(n), url, work,
                               correct["fasta"], backend], stdout=files[r],
                              stderr=subprocess.STDOUT, cwd=ROOT) for r in range(n)]
    sampler.start()
    rcs = []
    try:
        deadline = time.time() + 900
        for p in procs:
            try:
                rcs.append(p.wait(timeout=max(1.0, deadline - time.time())))
            except subprocess.TimeoutExpired:
                rcs.append(None)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        stop.set()
        sampler.join()
        for f in files:
            f.close()
    wall = time.time() - t
    for r, p in enumerate(logs):
        with open(p) as fh:
            for line in fh:
                if line.startswith("[14b") or "FAILED" in line or "Error" in line:
                    log(line.rstrip())
    check(all(rc == 0 for rc in rcs), f"14b: a rank failed or timed out (exit codes {rcs}); "
          f"its log is in chiprun_out/phase14_rank*.log")
    ranks = []
    for r in range(n):
        with open(os.path.join(work, f"rank{r}.json")) as fh:
            ranks.append(json.load(fh))
    mem = [s for s in samples if s is not None]
    log(f"[14b grid] {card}: {n} ranks over {backend} on "
        f"{min(n, torch.cuda.device_count())} card(s): {wall:.1f} s from the spawn to "
        f"every rank's exit; correction_phase {[round(x['correction_phase_s'], 2) for x in ranks]} s "
        f"(phase 10, one rank: {correct['run_s']:.2f} s); DP "
        f"{[round(x['dp_s'], 3) for x in ranks]} s; per-process device peaks "
        f"{[round(x['peak_bytes'] / 1e9, 3) for x in ranks]} GB; the cards' memory in use "
        f"(nvidia-smi, {len(mem)} samples) peaked at {max(mem) if mem else 'not measured'} MB")

    for x in ranks:
        r = x["rank"]
        c = x["launches"]
        check(c["K1"] > 0, f"14b: kernel K1 never launched on rank {r}")
        check_dp(f"14b rank {r}", c, x["dp_calls"])
        check(no_plain(c), f"14b: a plain loop or the plain DP ran on the card on rank {r}")
        check_fold(f"14b rank {r}", c)
        check_minhash(f"14b rank {r}", c, match=True)
        c = x["allgather"]["launches"]
        check(c["K1"] > 0 and no_plain(c),
              f"14b: rank {r}'s allgather stage missed K1 or ran a plain loop")
        check_minhash(f"14b rank {r} allgather", c, match=True)
        check(x["store"]["sha256"] == ref["store_sha256"] and x["store"]["rows"] == ref["rows"],
              f"14b: the range exchange's cor store differs from the JAX package's (rank {r})")
        check(x["store"]["frequent_sha256"] == ref["frequent_sha256"],
              "14b: the frequent-mer table differs from the JAX package's")
        check(x["n_candidates"] == ref["n_candidates"], "14b: the candidate count differs")
        check(x["allgather"]["sha256"] == ref["store_sha256"],
              f"14b: the allgather exchange's store differs from the JAX package's (rank {r})")
        v = x["verify"]
        check(v["equal"] and v["launches"]["K2"] > 0 and v["launches"]["plain_extend_rows"] == 0,
              f"14b: sharded_verify_candidates on rank {r} differs from the world of one's "
              "or missed K2")
        check(sorted(int(b) for b in x["blocks"]) == list(range(r, cref["n_blocks"], n)),
              f"14b: rank {r} corrected blocks {sorted(x['blocks'])}")
    blocks = {int(b): v for x in ranks for b, v in x["blocks"].items()}
    for rb in cref["blocks"]:
        got = blocks[rb["index"]]
        log(f"[14b grid] block {rb['index']} (rank {rb['index'] % n}): {got['reads']} reads, "
            f"{got['bases']} bases, sha256 {got['sha256']} (reference {rb['sha256']})")
        check(got["sha256"] == rb["sha256"], f"14b: block {rb['index']}'s corrected reads differ "
              "from the JAX package's")
    check(ranks[0]["names_ok"] and ranks[0]["corrected_reads"]
          == sum(v["reads"] for v in blocks.values()),
          "14b: the corrected FASTA misses reads or a record is not <read>_corrN")
    log(f"[14b grid] the cor store (range and allgather exchanges), the frequent table and "
        f"{ref['n_candidates']} candidates equal the JAX package's; blocks "
        f"{[b['index'] for b in cref['blocks']]} equal; {ranks[0]['corrected_reads']} corrected "
        f"reads; K1 launches {[x['launches']['K1'] for x in ranks]}")
    log(f"[14 grid] phase wall {time.time() - t_phase:.1f} s")
    return {"a": one, "b": ranks, "n": n, "backend": backend, "b_wall_s": wall,
            "card_memory_mb": mem,
            "k1_launches": one["launches"]["K1"] + sum(
                x["launches"]["K1"] + x["allgather"]["launches"]["K1"] for x in ranks),
            "k2_launches": one["k2_launches"] + sum(x["verify"]["launches"]["K2"]
                                                    for x in ranks),
            "k4_launches": sum(x["launches"]["K4"] for x in ranks),
            "phase_s": time.time() - t_phase}


def ecolicor_drive(dev, card: str, projected_dp_s: float | None = None) -> dict:
    """Phase 15: the port's correction_phase from a FASTA of raw reads at
    E. coli scale (the JAX package's config 2 at 10% error, nothing cut),
    Config() + genomeSize=4.6 Mb, in a directory of its own, the counts set
    to 0 just before and read just after.  K1 must have launched (the cor
    overlap), K4 once per DP call with at least one launch of 4 chunks or
    more, K9 once per DP group, and no K2 or K3 launch, plain loop, plain
    DP or plain fold on the card.  Holds
    against ecoli_correction_reference.json: the gatekeeper store's reads
    and bases, the frequent table, the whole candidate set, the cor store's
    rows whose a_id is a sampled template (tests/torch_cases.py
    template_sample, store_of_templates) and the sampled templates' records
    <read>_corrN in the phase's correctedReads.fasta.gz.  The first DP call
    is held to the plain DP on dp_subset's jobs (held_dp).  Prints the stage
    walls and meryl's route (device or host counter), the overlap's
    sub-walls and verify profile, the store's route (in RAM or spill), K1
    on each launch by CUDA events beside its bound, the correction's parts
    as phase 10 prints them with the block files' writes, their
    concatenation and the re-read that counts the records, the templates,
    blocks, chunks, DP groups and the jobs of each K4 launch, the DP beside
    projected_dp_s (phase 12c's projection from its full group), K9 on
    every group beside its summed bound (and held to the plain fold on the
    first group), and the device memory peak over meryl, over the verify
    and over the correction."""
    import numpy as np
    import torch

    from canu_tpu_torch.config import Config
    from canu_tpu_torch.io.fastx import read_fastx, write_fasta
    from canu_tpu_torch.ops import align as AL
    from canu_tpu_torch.ops import falcon as F
    from canu_tpu_torch.ops import minhash as MH
    from canu_tpu_torch.ops import votepile as VP
    from canu_tpu_torch.ops.hashing import u32_tensor
    from canu_tpu_torch.ops.kernels import minhash_cuda as MK
    from canu_tpu_torch.ops.kernels import myers_cuda as K1
    from canu_tpu_torch.ops.kernels import trace_cuda as K4
    from canu_tpu_torch.pipeline import stages
    from canu_tpu_torch.pipeline.configure import configure_resources
    from canu_tpu_torch.pipeline.driver import make_ctx
    from canu_tpu_torch.stores.overlaps import OverlapStore, store_digest
    from canu_tpu_torch.stores.readset import ReadSet

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_cases import corrected_digest, store_of_templates, template_sample

    with open(os.path.join(ROOT, "canu_tpu_torch", "ecoli_correction_reference.json")) as fh:
        ref = json.load(fh)
    t_phase = t = time.time()
    raw = ecoli_reads(error_rate=0.10)
    work = tempfile.mkdtemp(prefix="chip_smoke_ecolicor_")
    fasta = os.path.join(work, "reads.fasta")
    write_fasta(fasta, ((raw.name(i), raw.get_seq(i)) for i in range(1, raw.n_reads + 1)))
    log(f"[15 ecolicor] raw read set: {raw.n_reads} reads, {raw.total_bases} bases, simulated "
        f"and written to a FASTA in {time.time() - t:.1f} s")
    del raw
    # run_pipeline's configuration of -pacbio-raw reads (the read-type
    # profile, the resource solver), so that phase 16 resumes this
    # correction as the user's run would have made it
    cfg = Config()
    cfg.set("genomeSize", ECOLI_GENOME)
    cfg.apply_read_type_profile()
    cfg.validate()
    ctx = make_ctx(work, "ecoli", cfg)
    configure_resources(cfg, ctx.log)

    # instrumentation, each undone below: K1's events and bounds, the
    # memory peaks over meryl, the verify and the correction, the
    # candidates, the blocks' templates, CUDA events around the DP, each
    # group's windows, each group's fold (K9) and each finalize, the first
    # DP call's inputs and the first group's fold inputs
    k1 = {"events": [], "bounds": [], "peak": 0, "bound_s": 0.0}
    mem: dict = {"verify": {}}
    pairs_seen, block_templates, dp_jobs, first_dp, dp_lens_seen = [], [], [], [], []
    ev: dict = {"dp": [], "group": [], "finalize": []}
    fold_ev: list = []
    fold_kept: dict = {}
    sk_events, sk_args, join_args = [], [], []
    real = {"k1": K1.myers_rows_cuda, "verify": AL.verify_overlaps, "sketch": MK.sketch,
            "join": MH.find_candidates_join, "meryl": stages.meryl,
            "blocks": F.correct_reads_blocks, "vote_blocks": F.run_vote_blocks,
            "dp": VP.align_positions_lean, "group": VP._group_paths, "fold": VP._fold_group,
            "finalize": F._finalize_plurality}

    def peak_from_here() -> int:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        return torch.cuda.memory_allocated(dev)

    def meryl(*args, **kw):
        start = peak_from_here()
        t0 = time.time()
        out = real["meryl"](*args, **kw)
        torch.cuda.synchronize()
        mem["meryl"] = {"start": start, "peak": torch.cuda.max_memory_allocated(dev),
                        "wall_s": time.time() - t0}
        return out

    def blocks(*args, **kw):
        start = peak_from_here()
        yield from real["blocks"](*args, **kw)
        torch.cuda.synchronize()
        mem["correct"] = {"start": start, "peak": torch.cuda.max_memory_allocated(dev)}

    def vote_blocks(*args, **kw):
        for bi, bt, rows2d in real["vote_blocks"](*args, **kw):
            block_templates.append(len(bt))
            yield bi, bt, rows2d

    def timed(name):
        return cuda_timed(real[name], ev[name])

    dp_timed = timed("dp")

    def dp(*args, **kw):
        if not first_dp:  # held to the plain DP below
            first_dp.append(keep_call(args, kw))
        j0 = K4.JOBS_LAUNCHED
        out = dp_timed(*args, **kw)
        dp_jobs.append(K4.JOBS_LAUNCHED - j0)
        dp_lens_seen.append(dp_lens(args))
        return out

    sketch_timed = cuda_timed(real["sketch"], sk_events)

    def sketch(*args):
        sk_args.append(args)  # every K5 launch's inputs, for its bound below
        return sketch_timed(*args)

    def join(sk, **kw):
        join_args.append((np.ascontiguousarray(sk[:2048]), kw))  # K6's real blocks below
        pairs_seen.append(real["join"](sk, **kw))
        return pairs_seen[-1]

    K1.myers_rows_cuda = k1_metered(real["k1"], k1, dev)
    AL.verify_overlaps = verify_metered(real["verify"], k1, mem["verify"], dev)
    MK.sketch, MH.find_candidates_join = sketch, join
    stages.meryl, F.correct_reads_blocks, F.run_vote_blocks = meryl, blocks, vote_blocks
    VP.align_positions_lean, VP._group_paths = dp, timed("group")
    VP._fold_group = fold_metered(real["fold"], fold_ev, fold_kept)
    F._finalize_plurality = timed("finalize")
    # the first K7 group and every 16th after it, the index's first block
    real_pre, pre_kept = capture_pre(every=16)
    real_sy, sy_kept = capture_syncmer()
    try:
        reset_counts()
        F.PROFILE.clear()
        VP.CHUNKS = VP.JOBS = VP.GROUPS = 0
        t = time.time()
        stages.correction_phase(ctx, [fasta], device=dev)
        torch.cuda.synchronize()
        t_run = time.time() - t
        counts = read_counts()
    finally:
        K1.myers_rows_cuda, AL.verify_overlaps = real["k1"], real["verify"]
        MH.find_candidates_join, stages.meryl = real["join"], real["meryl"]
        MK.sketch = real["sketch"]
        F.correct_reads_blocks, F.run_vote_blocks = real["blocks"], real["vote_blocks"]
        VP.align_positions_lean, VP._group_paths = real["dp"], real["group"]
        VP._fold_group, F._finalize_plurality = real["fold"], real["finalize"]
        AL._verify_pre = real_pre
        restore_syncmer(real_sy)
    verify_err = held_verify_calls("phase 15", pre_kept, sy_kept)
    vsplit = verify_kernel_split("15", card, pre_kept, sy_kept)
    del pre_kept, sy_kept
    chunk_b = VP.chunk_jobs(F.VOTE_SEG)
    route = "host" if counts["host_kmer_counts"] else "device"
    store_route = "spill" if counts["spill_builds"] else "in RAM"
    log(f"[15 ecolicor] {card}: correction_phase from the FASTA: {t_run:.2f} s; launch and call "
        f"counts {counts}; meryl counted on the {route}; the cor store built {store_route}")
    check(counts["K1"] > 0, "15 ecolicor: kernel K1 never launched during the phase")
    check(counts["K2"] == counts["K3"] == 0, "15 ecolicor: kernel K2 or K3 launched off its path")
    check_dp("15 ecolicor", counts, len(ev["dp"]))
    check(max(dp_jobs) >= 4 * chunk_b,
          f"15 ecolicor: no K4 launch took 4 chunks or more (largest {max(dp_jobs)} jobs)")
    check(no_plain(counts),
          "15 ecolicor: a plain loop or the plain DP ran on the card during the phase")
    check_fold("15 ecolicor", counts)
    check(len(fold_ev) == counts["K9"], "15 ecolicor: K9 launches and timed calls differ")
    check_minhash("15 ecolicor", counts, match=False)
    check(counts["join_calls"] == 1, f"15 ecolicor: {counts['join_calls']} hash-joins, expected 1")
    check(len(k1["events"]) == counts["K1"], "15 ecolicor: K1 launches and timed calls differ")
    check(len(sk_events) == counts["K5"], "15 ecolicor: K5 launches and timed calls differ")

    # K5 over the whole sketch by CUDA events beside its summed bound; K5
    # on the first (longest) block and K6 on the first 2,048 reads'
    # sketches (a self and a cross block pair) held to the plain versions
    k5_ms = sum(a.elapsed_time(b) for a, b in sk_events)
    k5_bound = sum_bounds([sketch_bound(*a) for a in sk_args])
    log(f"[15 timing] {card}: K5 over the cor sketch: {len(sk_events)} launches "
        f"({sk_args[0][0].shape[0]} reads x up to {sk_args[0][0].shape[1]} words, H "
        f"{sk_args[0][2].shape[0]}), {k5_ms:.3f} ms (CUDA events); bound "
        f"{k5_bound['bound_ms']:.3f} ms ({k5_bound['ops']:.3e} operations, "
        f"{k5_bound['bytes']:.3e} bytes; {100 * k5_bound['bound_ms'] / k5_ms:.1f}% of it)")
    err_mh = held_sketch("15 K5 first block", sk_args[0])
    ((sk0, jkw),) = join_args
    S = u32_tensor(sk0, dev)
    mm = int(jkw["min_matches"])
    real_blocks = [(S[:1024], S[:1024], mm, True, 1 << 17),
                   (S[:1024], S[1024:2048], mm, False, 1 << 17)]
    for i, args in enumerate(real_blocks):
        e, n = held_match(f"15 K6 block pair {i}", *args)
        err_mh = max(err_mh, e)
        log(f"[3e kernel] phase 15: K6 bit-equal to the plain match on the sketches of reads "
            f"{'1-1,024 with themselves' if i == 0 else '1-1,024 against 1,025-2,048'} (min_matches "
            f"{mm}): n_found {n}")
    log("[3e kernel] phase 15: K5 bit-equal to the plain sketch on the first block")
    del sk_args, S

    # the gatekeeper store, the frequent table, the candidates, the sampled
    # templates' store rows and corrected reads equal the JAX package's
    d = os.path.join(work, "correction")
    rs = ReadSet.load(os.path.join(d, "ecoli.gkpStore"))
    log(f"[15 ecolicor] gatekeeper store {rs.n_reads} reads, {rs.total_bases} bases (reference "
        f"{ref['gatekeeper_reads']}, {ref['gatekeeper_bases']})")
    check(rs.n_reads == ref["gatekeeper_reads"] and rs.total_bases == ref["gatekeeper_bases"],
          "15 ecolicor: the gatekeeper store differs from the JAX package's")
    fdig = frequent_digest(os.path.join(d, f"ecoli.ms{ref['k']}.frequent.npz"))
    (pairs,) = pairs_seen
    cdig = hashlib.sha256(np.ascontiguousarray(pairs.astype("<i8")).tobytes()).hexdigest()
    log(f"[15 ecolicor] frequent sha256 {fdig}; {len(pairs)} candidates (reference "
        f"{ref['n_candidates']}), sha256 {cdig}")
    check(fdig == ref["frequent_sha256"],
          "15 ecolicor: frequent-mer table differs from the JAX package's")
    check(len(pairs) == ref["n_candidates"] and cdig == ref["candidates_sha256"],
          "15 ecolicor: candidates differ from the JAX package's")
    st = OverlapStore.load(os.path.join(d, "ecoli.ovlStore"))
    tids = F.select_templates(rs, float(cfg.get("genomeSize")), int(cfg.get("corOutCoverage")))
    sample = template_sample(tids)
    check([int(i) for i in sample] == ref["sample"]["ids"],
          "15 ecolicor: the template sample differs from the reference's")
    rows = store_of_templates(st, sample)
    rdig = store_digest(rows)
    log(f"[15 ecolicor] {len(tids)} templates (reference {ref['n_templates']}); store rows "
        f"{len(st)}; the rows of the {len(sample)} sampled templates {len(rows.a_id)} "
        f"(reference {ref['sample']['rows']}), sha256 {rdig}")
    check(len(rows.a_id) == ref["sample"]["rows"] and rdig == ref["sample"]["store_sha256"],
          "15 ecolicor: the sampled templates' store rows differ from the JAX package's")
    t = time.time()
    recs = list(read_fastx(os.path.join(d, "ecoli.correctedReads.fasta.gz")))
    names = {rs.name(i) for i in range(1, rs.n_reads + 1)}
    check(len(recs) > 0 and all(r.name.rsplit("_corr", 1)[0] in names
                                and r.name.rsplit("_corr", 1)[1].isdigit() for r in recs),
          "15 ecolicor: the corrected FASTA is empty or a record is not named <read>_corrN")
    picked = {rs.name(int(i)) for i in sample}
    mine = [(r.name, r.seq) for r in recs if r.name.rsplit("_corr", 1)[0] in picked]
    sref = ref["sample"]
    dig = corrected_digest(mine)
    log(f"[15 ecolicor] {len(recs)} corrected reads, {sum(len(r.seq) for r in recs)} bases "
        f"(read back in {time.time() - t:.1f} s); the sampled templates' {len(mine)} records, "
        f"{sum(len(x) for _, x in mine)} bases, sha256 {dig} (reference "
        f"{sref['corrected_reads']}, {sref['corrected_bases']}, {sref['corrected_sha256']})")
    check(dig == sref["corrected_sha256"],
          "15 ecolicor: the sampled templates' corrected reads differ from the JAX package's")

    # K4 on the first DP call, held to the plain DP on dp_subset's jobs
    (call,) = first_dp
    err, plain_ms, n_held = held_dp("15 group 1", call, chunk_b)
    log(f"[15 vote_dp] the first DP call: one K4 launch of {call[0][0].shape[0]} jobs, "
        f"bit-equal to the plain DP (j* and edits) on {n_held} of them (dp_subset); plain "
        f"{plain_ms:.1f} ms")
    # K9 on the first DP group, held to the plain fold
    fold_held = held_fold("15 first DP group", fold_kept.pop("first"), card)

    # where the time went
    with open(ctx.path("ecoli.stage-times.jsonl")) as fh:
        lines = [json.loads(ln) for ln in fh]
    walls = {r["stage"]: r["wall_s"] for r in lines if "wall_s" in r}
    sub = [r for r in lines if r.get("stage") == "cor-overlap.sub"][-1]
    k1_ms, bd, tb = k1_drive_line("15", card, k1)
    dev_s = {k: sum(a.elapsed_time(b) for a, b in v) / 1e3 for k, v in ev.items()}
    prof = dict(F.PROFILE)
    parts = {"select_s": prof.get("select", 0.0), "setup_s": prof.get("setup", 0.0),
             "dp_s": dev_s["dp"], "windows_s": dev_s["group"] - dev_s["dp"],
             "fold_s": sum(a.elapsed_time(b) for a, b, _ in fold_ev) / 1e3,
             "finalize_s": dev_s["finalize"],
             "enqueue_votes_s": prof.get("votes", 0.0), "fetch_s": prof.get("fetch", 0.0),
             "decode_s": prof.get("decode", 0.0), "block_write_s": prof.get("write", 0.0),
             "concat_s": prof.get("concat", 0.0), "count_s": prof.get("count", 0.0)}
    log(f"[15 timing] {card}: stage walls {walls}; meryl {mem['meryl']['wall_s']:.2f} s on the "
        f"{route}; overlap sub-walls {sub['sub_walls_s']} (sketch, match = the hash-join, "
        f"verify, store); verify profile {sub['verify_profile']}")
    log(f"[15 timing] {card}: correction parts " + ", ".join(
        f"{k} {v:.3f}" for k, v in parts.items()) + " (DP, windows, fold and finalize: CUDA "
        "events; the rest host clock)")
    n_dp = len(dp_jobs)
    vb = [vdp_bound_of(*x) for x in dp_lens_seen]
    del dp_lens_seen
    dp_bound_s = sum(b["bound_ms"] for b in vb) / 1e3
    fold = fold_events(fold_ev, card, "15", "the correction's DP groups")
    fold["held"] = fold_held
    del fold_ev
    log(f"[15 timing] {card}: K4's bound summed over the {len(vb)} DP calls (vdp_bound): "
        f"{dp_bound_s:.3f} s ({sum(b['ops'] for b in vb):.3e} operations on "
        f"{sum(b['cells'] for b in vb)} cells, {sum(b['bytes'] for b in vb):.3e} bytes), "
        f"{100 * dp_bound_s / max(dev_s['dp'], 1e-9):.1f}% of the DP's {dev_s['dp']:.3f} s")
    log(f"[15 timing] {card}: {sum(block_templates)} templates in {len(block_templates)} blocks; "
        f"{VP.JOBS} vote jobs in {VP.CHUNKS} chunks of {chunk_b}, {VP.GROUPS} DP groups, "
        f"{counts['K4']} K4 launches of {min(dp_jobs)}-{max(dp_jobs)} jobs (median "
        f"{int(np.median(dp_jobs))}; each in chiprun_out/chip_smoke.json); the DP "
        f"{dev_s['dp']:.3f} s (phase 12c's projection for {ECOLI_CHUNKS} chunks: "
        + ("not made" if projected_dp_s is None else f"{projected_dp_s:.2f} s") + ")")
    for name, m in (("meryl", mem["meryl"]), ("verify", mem["verify"]),
                    ("correction", mem["correct"])):
        log(f"[15 memory] {card}: device peak over the {name} {m['peak'] / 1e9:.3f} GB "
            f"({(m['peak'] - m['start']) / 1e9:.3f} GB above the {m['start'] / 1e9:.3f} GB "
            "allocated at its start)")
    log(f"[15 ecolicor] phase wall {time.time() - t_phase:.1f} s; its directory goes on to "
        "phase 16")
    return {"work": work, "fasta": fasta, "run_s": t_run, "stage_walls_s": walls, "meryl_route": route,
            "store_route": store_route, "sub_walls_s": sub["sub_walls_s"],
            "verify_profile": sub["verify_profile"], "parts_s": parts,
            "templates": sum(block_templates), "blocks": len(block_templates),
            "chunks": VP.CHUNKS, "jobs": VP.JOBS, "groups": VP.GROUPS, "dp_calls": n_dp,
            "dp_jobs": dp_jobs, "chunk_jobs": chunk_b, "launches": counts,
            "n_candidates": len(pairs), "rows": len(st), "corrected_reads": len(recs),
            "k1_ms": k1_ms, "k1_bounds": bd, "k1_ms_per_drive": sum(k1_ms),
            "k1_bound_ms_per_drive": tb,
            "k1_bound_s": k1["bound_s"], "dp_err": err, "dp_plain_ms": plain_ms,
            "dp_s": dev_s["dp"], "dp_bound_s": dp_bound_s, "dp_bounds": vb,
            "k5_ms": k5_ms, "k5_bound": k5_bound, "minhash_err": err_mh, "fold": fold,
            "verify_err": verify_err, "verify_split": vsplit, "memory": mem,
            "phase_s": time.time() - t_phase}


# canu_tpu's own result on config 2's raw reads (BASELINE.md, run r5b):
# contigs, NG50, misjoins, identity, genome fraction
CANU_TPU_ECOLI = {"contigs": 2, "ng50": 3_811_527, "misjoins": 0, "identity": 0.99999,
                  "genome_fraction": 0.9997}
# where a first run of phase 16 (no reference yet, or an input digest that
# differs from the reference's) leaves its stage-boundary inputs
ECOLI_ASM_OUT = os.path.join(OUT_DIR, "ecoli_asm")


def ecoliasm_drive(dev, card: str, cor: dict) -> dict:
    """Phase 16: raw reads to contigs at E. coli scale through the port's
    entry point, run_pipeline(raw_reads=[FASTA]) with Config() +
    genomeSize, in phase 15's directory, so that the correction resumes:
    trimming (obt gatekeeper, meryl, overlap, trimming) and assembly (utg
    gatekeeper, meryl, overlap, oea: RED and OEA's adjust, unitig,
    consensus, outputs), the counts set to 0 just before and read just
    after.  K1 must have launched in the obt and utg overlaps, the adjust,
    align_links (where the GFA has a link) and the judge, K4 once per DP
    call, no K2 or K3 launch and no plain loop or plain DP on the card.
    Each stage is held to ecoli_assembly_reference.json (the JAX package on
    the CPU, scripts/torch_ecoli_assembly_reference.py) on its own input
    as this card made it: first each input's digest (the corrected reads,
    the trimmed reads, the autoerate gate, RED's corrections of every
    read, the adjusted utg store, spec.used), then the obt and utg
    gatekeepers, frequent tables and candidates, the store rows of a
    256-read sample of each (tests/torch_cases.py template_sample,
    store_of_templates), the sampled reads' trimmed records and RED
    corrections, the adjusted erates of every row of the utg sample's
    reads (rows_of_reads) and every unitig and contig layout.  Without a
    reference, or where an input's digest differs, the inputs go to
    chiprun_out/ecoli_asm/ for the reference script and the phase fails.
    RED's and the polish's first DP calls are held to the plain DP
    (held_dp).  The judge (sim/bogus.py evaluate_assembly, K1) scores the
    contigs against the genome: printed beside canu_tpu's own result and
    the 0.999 bar, not gated.  Then the CLI on the directory must skip
    every stage.  Prints the stage walls, the overlaps' and oea's
    sub-walls, meryl's route, each step's device memory peak, K1 on each
    launch by CUDA events beside its bound per drive, and RED's and the
    polish's DP by CUDA events beside their bounds."""
    import logging
    import shutil

    import numpy as np
    import torch

    from canu_tpu_torch.config import Config
    from canu_tpu_torch.io import fastx as FX
    from canu_tpu_torch.io import gfa as GFA
    from canu_tpu_torch.ops import align as AL
    from canu_tpu_torch.ops import consensus as CNS
    from canu_tpu_torch.ops import falcon as F
    from canu_tpu_torch.ops import kmer as KM
    from canu_tpu_torch.ops import minhash as MH
    from canu_tpu_torch.ops import myers as MY
    from canu_tpu_torch.ops import oea as OEA
    from canu_tpu_torch.ops import votepile as VP
    from canu_tpu_torch.ops.kernels import myers_cuda as K1
    from canu_tpu_torch.ops.kernels import trace_cuda as K4
    from canu_tpu_torch.pipeline import stages
    from canu_tpu_torch.pipeline.driver import run_pipeline
    from canu_tpu_torch.sim import bogus as BG
    from canu_tpu_torch.sim.simulate import random_genome
    from canu_tpu_torch.stores.overlaps import OverlapStore, store_digest
    from canu_tpu_torch.stores.readset import ReadSet
    from canu_tpu_torch.utils.bitpack import seq_to_codes

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_cases import (
        _sha_of,
        corrected_digest,
        corrections_arrays,
        corrections_records,
        fasta_records,
        pack_records,
        rows_of_reads,
        store_halves,
        store_of_templates,
        template_sample,
        tig_records,
        trimmed_of,
    )

    ref_path = os.path.join(ROOT, "canu_tpu_torch", "ecoli_assembly_reference.json")
    ref = None
    if os.path.exists(ref_path):
        with open(ref_path) as fh:
            ref = json.load(fh)
    t_phase = time.time()
    work, fasta = cor["work"], cor["fasta"]
    cor_out = os.path.join(work, "correction", "ecoli.correctedReads.fasta.gz")
    cor_mtime = os.path.getmtime(cor_out)
    cfg = Config()
    cfg.set("genomeSize", ECOLI_GENOME)

    # instrumentation, each undone below: each step's K1 launches, vote
    # chunks, host k-mer counts and device peak; K1 by CUDA events with its
    # bound a launch; the DP of RED and the polish by CUDA events, what
    # their bounds need and their first calls; the candidates; each
    # overlap's store; RED's corrections; the judge's K1; the log
    where = [None]
    k1_in: dict = {}
    chunks_in: dict = {}
    hosts_in: dict = {}
    step_peak: dict = {}
    step_wall: dict = {}
    k1 = {"events": [], "bounds": [], "where": [], "peak": 0, "bound_s": 0.0}
    dp_ev: dict = {"red": [], "polish": []}
    dp_seen: dict = {"red": [], "polish": []}
    dp_first: dict = {}
    pairs_seen: list = []
    stores: dict = {}
    corr: dict = {}
    n_links = [0]
    n_dp = [0]
    msgs: list = []
    real = {"k1": K1.myers_rows_cuda, "meryl": stages.meryl, "overlap": stages.overlap,
            "join": MH.find_candidates_join, "red": OEA.detect_read_errors,
            "adjust": OEA.adjust_overlap_erates, "polish": CNS.polish_tig,
            "links": GFA.align_links, "dp": VP.align_positions_lean,
            "bogus": BG._segment_identity, "write": FX.write_fasta, "fold": VP._fold_group,
            "extend": MY.banded_extend_myers}

    def counted(key, fn):
        def call(*args, **kw):
            k0, c0, h0, prev = K1.LAUNCHES, VP.CHUNKS, KM.HOST_COUNTS, where[0]
            where[0] = key
            torch.cuda.synchronize()
            m0 = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            k1["peak"] = 0
            t0 = time.time()
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda.synchronize()
                step_wall[key] = step_wall.get(key, 0.0) + time.time() - t0
                step_peak[key] = max(step_peak.get(key, 0), k1["peak"] - m0,
                                     torch.cuda.max_memory_allocated(dev) - m0)
                where[0] = prev
                k1_in[key] = k1_in.get(key, 0) + K1.LAUNCHES - k0
                chunks_in[key] = chunks_in.get(key, 0) + VP.CHUNKS - c0
                hosts_in[key] = hosts_in.get(key, 0) + KM.HOST_COUNTS - h0
        return call

    def k1_call(*args, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = real["k1"](*args, **kw)
        e1.record()
        k1["events"].append((e0, e1))
        k1["where"].append(where[0])
        k1["peak"] = max(k1["peak"], torch.cuda.max_memory_allocated(dev))
        t0 = time.time()
        k1["bounds"].append(k1_bound(args, torch.clamp(args[4].to(torch.int64), 0, args[6]),
                                     kw.get("pick", False)))
        k1["bound_s"] += time.time() - t0
        torch.cuda.reset_peak_memory_stats(dev)
        return out

    def meryl(ctx, tg, *args, **kw):
        return counted(f"{tg}-meryl", real["meryl"])(ctx, tg, *args, **kw)

    def overlap(ctx, tg, *args, **kw):
        st = counted(f"{tg}-overlap", real["overlap"])(ctx, tg, *args, **kw)
        # the sample's rows now: the oea stage installs the adjusted erates
        # in this same store
        rows = store_of_templates(st, template_sample(np.arange(1, st.n_reads + 1)))
        stores[tg] = {"sample_rows": int(len(rows.a_id)), "sample_store_sha256": store_digest(rows)}
        return st

    def join(*args, **kw):
        pairs_seen.append(real["join"](*args, **kw))
        return pairs_seen[-1]

    def red(*args, **kw):
        out = counted("red", real["red"])(*args, **kw)
        corr.update(out)
        return out

    def write_fasta(path, *args, **kw):
        t0 = time.time()
        try:
            return real["write"](path, *args, **kw)
        finally:
            key = f"write_fasta {os.path.basename(path).split('.WORKING')[0]}"
            step_wall[key] = step_wall.get(key, 0.0) + time.time() - t0

    def links(tigs, lk, *args, **kw):
        n_links[0] += len(lk)
        return counted("align_links", real["links"])(tigs, lk, *args, **kw)

    def dp(*args, **kw):
        n_dp[0] += 1
        if where[0] not in dp_ev:
            return real["dp"](*args, **kw)
        if where[0] not in dp_first:
            dp_first[where[0]] = keep_call(args, kw)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = real["dp"](*args, **kw)
        e1.record()
        dp_ev[where[0]].append((e0, e1))
        dp_seen[where[0]].append(dp_lens(args))
        return out

    # K9 by CUDA events in RED and in the polish, each one's first group kept
    fold_ev: dict = {"red": [], "polish": []}
    fold_kept: dict = {}
    fold_in = {k: fold_metered(real["fold"], v, fold_kept, lambda args, k=k: k)
               for k, v in fold_ev.items()}

    def fold_where(*args):
        return fold_in.get(where[0], real["fold"])(*args)

    class Lines(logging.Handler):
        def emit(self, rec):
            msgs.append(rec.getMessage())

    # on the root logger, which the stages' records reach whether or not
    # make_ctx has set the prefix's logger up yet
    lines_h = Lines()
    logging.getLogger().addHandler(lines_h)
    K1.myers_rows_cuda = k1_call
    stages.meryl, stages.overlap, MH.find_candidates_join = meryl, overlap, join
    OEA.detect_read_errors, OEA.adjust_overlap_erates = red, counted("adjust", real["adjust"])
    CNS.polish_tig, GFA.align_links = counted("polish", real["polish"]), links
    VP.align_positions_lean, FX.write_fasta, VP._fold_group = dp, write_fasta, fold_where
    # the first K7 group and every 16th after it, each index's first block,
    # each verify's profile
    real_pre, pre_kept = capture_pre(every=16)
    real_sy, sy_kept = capture_syncmer()
    real_vo, vprofs = verify_profiles(where)
    try:
        reset_counts()
        VP.CHUNKS = VP.JOBS = VP.GROUPS = 0
        F.PROFILE.clear()  # RED's block loop: its enqueue of the votes ("votes")
        t = time.time()
        run_pipeline(work, "ecoli", cfg, raw_reads=[fasta], device=dev)
        torch.cuda.synchronize()
        t_run = time.time() - t
        counts = read_counts()
        # the judge: the contigs against the simulated genome, K1 on the card
        genome = random_genome(ECOLI_GENOME, seed=7)
        contigs = [seq_to_codes(r[1]) for r in fasta_records(os.path.join(work,
                                                                          "ecoli.contigs.fasta"))]
        BG._segment_identity = counted("bogus", real["bogus"])
        # the judge's extension inputs: K10 and K11 held to the plain chain
        _, judge_ext = capture_calls(MY, "banded_extend_myers")
        k0 = (K1.LAUNCHES, K1.PROLOGUE_LAUNCHES, K1.PICK_LAUNCHES, K1.EPILOGUE_LAUNCHES)
        t = time.time()
        ev = BG.evaluate_assembly(genome, contigs, k=21, circular=True, device=dev)
        t_judge = time.time() - t
        judge_k1, judge_k10, judge_k11, judge_k11_alone = (n - n0 for n, n0 in zip(
            (K1.LAUNCHES, K1.PROLOGUE_LAUNCHES, K1.PICK_LAUNCHES, K1.EPILOGUE_LAUNCHES), k0))
    finally:
        MY.banded_extend_myers = real["extend"]
        logging.getLogger().removeHandler(lines_h)
        K1.myers_rows_cuda = real["k1"]
        AL._verify_pre, AL.verify_overlaps = real_pre, real_vo
        restore_syncmer(real_sy)
        stages.meryl, stages.overlap = real["meryl"], real["overlap"]
        MH.find_candidates_join = real["join"]
        OEA.detect_read_errors, OEA.adjust_overlap_erates = real["red"], real["adjust"]
        CNS.polish_tig, GFA.align_links = real["polish"], real["links"]
        VP.align_positions_lean, BG._segment_identity = real["dp"], real["bogus"]
        FX.write_fasta, VP._fold_group = real["write"], real["fold"]
    log(f"[16 ecoliasm] {card}: run_pipeline(raw_reads=...) in phase 15's directory: "
        f"{t_run:.2f} s; launch and call counts {counts}; K1 launches by step {k1_in}; "
        f"host k-mer counts by step {hosts_in}")
    resumed = any("correction phase complete, skipping" in m for m in msgs)
    log(f"[16 ecoliasm] correction resumed from phase 15 (the log says \"correction phase "
        f"complete, skipping\"): {resumed}; its FASTA untouched: "
        f"{os.path.getmtime(cor_out) == cor_mtime}")
    check(resumed and os.path.getmtime(cor_out) == cor_mtime,
          "16 ecoliasm: the correction phase ran again instead of resuming phase 15's")
    check(counts["K2"] == counts["K3"] == 0, "16 ecoliasm: kernel K2 or K3 launched off its path")
    check_dp("16 ecoliasm", counts, n_dp[0])
    check(no_plain(counts),
          "16 ecoliasm: a plain loop or the plain DP ran on the card during the run")
    check_fold("16 ecoliasm", counts)
    check(len(fold_ev["red"]) + len(fold_ev["polish"]) == counts["K9"],
          "16 ecoliasm: K9 launches outside RED and the polish, or untimed")
    check_minhash("16 ecoliasm", counts, match=False)
    for step in ("obt-overlap", "utg-overlap", "adjust"):
        check(k1_in.get(step, 0) > 0, f"16 ecoliasm: kernel K1 never launched in {step}")
    if n_links[0]:
        check(k1_in.get("align_links", 0) > 0, "16 ecoliasm: align_links never launched K1")
    check(judge_k1 > 0 and k1_in.get("bogus", 0) == judge_k1,
          "16 ecoliasm: the judge never launched K1")
    check(judge_k10 == judge_k11 == judge_k1 == len(judge_ext) and judge_k11_alone == 0,
          f"16 ecoliasm: the judge's {judge_k1} K1 launches ({judge_k11} with the end pick) came "
          f"with {judge_k10} K10 launches and {judge_k11_alone} of K11 alone "
          f"({len(judge_ext)} extension calls)")
    check(counts["K10"] == counts["K11_pick"] == counts["K1"] and counts["K11"] == 0,
          f"16 ecoliasm: K10 {counts['K10']} launches for K1's {counts['K1']} "
          f"({counts['K11_pick']} with the end pick), K11 alone {counts['K11']}")
    (j_args, j_kw), *_ = judge_ext
    ends_judge = held_myers_ends("16 judge", j_args[:5], j_args[6], j_kw, reps=2)
    del judge_ext
    log(f"[16 kernel] {card}: K10 and K1 with the end pick bit-equal to the plain chain on the "
        f"judge's launch ({j_args[0].shape[0]} extensions x {j_args[6]} rows, centres at stride "
        f"{ends_judge['K10']['stride']}): K10 {ends_judge['K10']['ms']:.4f} ms (plain "
        f"{ends_judge['K10']['plain_ms']:.3f} ms, bound "
        f"{ends_judge['K10']['bound']['bound_ms']:.4f} ms; as rows it would be "
        f"{ends_judge['K10']['bound_rows']['bound_ms']:.4f} ms), K11 alone "
        f"{ends_judge['K11']['ms']:.4f} ms")
    check(len(k1["events"]) == counts["K1"] + judge_k1,
          "16 ecoliasm: K1 launches and timed calls differ")
    check(len(pairs_seen) == 2 and counts["join_calls"] == 2,
          f"16 ecoliasm: {len(pairs_seen)} hash-joins, expected the obt and the utg one")
    for name in ("contigs.fasta", "unassembled.fasta", "unitigs.fasta", "layout.tsv",
                 "contigs.gfa"):
        check(os.path.exists(os.path.join(work, f"ecoli.{name}")), f"16 ecoliasm: no ecoli.{name}")

    d_trim, d_utg = os.path.join(work, "trimming"), os.path.join(work, "unitigging")

    # K4 on RED's and the polish's first DP calls, held to the plain DP
    chunk_b = VP.chunk_jobs(F.VOTE_SEG)
    dp_err, held = 0, {}
    for key in ("red", "polish"):
        check(key in dp_first, f"16 ecoliasm: {key} made no DP call")
        e_k, plain_ms, n_held = held_dp(f"16 {key} group 1", dp_first[key], chunk_b)
        dp_err = max(dp_err, e_k)
        held[key] = {"jobs": dp_first[key][0][0].shape[0], "held_jobs": n_held,
                     "plain_ms": plain_ms}
        log(f"[16 vote_dp] {key}'s first DP call: one K4 launch of "
            f"{dp_first[key][0][0].shape[0]} jobs, bit-equal to the plain DP (j* and edits) on "
            f"{n_held} of them (dp_subset); plain {plain_ms:.1f} ms")
    # K9 on RED's and the polish's first DP groups, held to the plain fold
    fold = {}
    for key in ("red", "polish"):
        check(key in fold_kept, f"16 ecoliasm: {key} folded no DP group")
        fold[key] = {"held": held_fold(f"16 {key}'s first DP group", fold_kept.pop(key), card)}
    dp_first.clear()

    # K7 and K8 held to the plain versions on the kept groups and blocks
    verify_err = held_verify_calls("phase 16", pre_kept, sy_kept)
    vsplit = verify_kernel_split("16", card, pre_kept, sy_kept)
    del pre_kept, sy_kept

    # where the time went
    with open(os.path.join(work, "ecoli.stage-times.jsonl")) as fh:
        lines = [json.loads(ln) for ln in fh]
    lines = [r for r in lines if r.get("t_end", 0) >= t_phase]
    walls = {r["stage"]: r["wall_s"] for r in lines if "wall_s" in r}
    subs = {r["stage"]: r.get("sub_walls_s") for r in lines if r["stage"].endswith(".sub")}
    log(f"[16 timing] {card}: stage walls {walls} (sum {sum(walls.values()):.1f} s)")
    log(f"[16 timing] {card}: sub-walls {subs}; RED {len(corr)} reads changed")
    log(f"[16 timing] {card}: verify profiles " + "; ".join(f"{w}: {p}" for w, p in vprofs))
    log(f"[16 timing] {card}: step walls (host clock around each call) " + ", ".join(
        f"{k} {v:.2f} s" for k, v in step_wall.items()))
    routes = {tg: ("host" if hosts_in.get(f"{tg}-meryl", 0) else "device") for tg in ("obt", "utg")}
    log(f"[16 timing] {card}: meryl counted on the {routes['obt']} (obt) and the {routes['utg']} "
        f"(utg)")
    k1_ms = [a.elapsed_time(b) for a, b in k1["events"]]
    k1_drive: dict = {}
    for w, ms, bd in zip(k1["where"], k1_ms, k1["bounds"]):
        x = k1_drive.setdefault(w, {"launches": 0, "ms": 0.0, "bound_ms": 0.0, "ops": 0.0,
                                    "bytes": 0.0, "first_ms": ms})
        x["launches"] += 1
        x["ms"] += ms
        x["bound_ms"] += bd["bound_ms"]
        x["ops"] += bd["ops"]
        x["bytes"] += bd["bytes"]
    for w, x in k1_drive.items():
        log(f"[16 timing] {card}: K1 in {w}: {x['launches']} launches, {x['ms']:.3f} ms (first "
            f"{x['first_ms']:.3f} ms); bound {x['bound_ms']:.3f} ms ({x['ops']:.3e} operations, "
            f"{x['bytes']:.3e} bytes; {100 * x['bound_ms'] / max(x['ms'], 1e-9):.1f}% of it)")
    log(f"[16 timing] {card}: K1's bounds computed after each launch: {k1['bound_s']:.2f} s of "
        "the walls")
    dp_s, dp_bound = {}, {}
    for key in ("red", "polish"):
        dp_s[key] = sum(a.elapsed_time(b) for a, b in dp_ev[key]) / 1e3
        vb = [vdp_bound_of(*x) for x in dp_seen[key]]
        dp_bound[key] = {"calls": len(vb), "bound_s": sum(b["bound_ms"] for b in vb) / 1e3,
                         "ops": sum(b["ops"] for b in vb), "bytes": sum(b["bytes"] for b in vb),
                         "cells": sum(b["cells"] for b in vb),
                         "bound_by": "operations" if sum(b["ops"] for b in vb) / INT32_OPS_S
                         >= sum(b["bytes"] for b in vb) / HBM_BYTES_S else "bytes"}
        b = dp_bound[key]
        log(f"[16 timing] {card}: {key}: {chunks_in.get(key, 0)} vote chunks in {b['calls']} DP "
            f"calls (one K4 launch each), DP {dp_s[key]:.3f} s by CUDA events; bound "
            f"{b['bound_s']:.3f} s ({b['ops']:.3e} operations on {b['cells']} cells, "
            f"{b['bytes']:.3e} bytes; {100 * b['bound_s'] / max(dp_s[key], 1e-9):.1f}% of it)")
        fold[key].update(fold_events(fold_ev[key], card, "16", f"{key}'s DP groups"))
    fold["red"]["enqueue_votes_s"] = F.PROFILE.get("votes", 0.0)
    log(f"[16 timing] {card}: parts of RED: DP {dp_s['red']:.3f} s, fold_s "
        f"{fold['red']['ms'] / 1e3:.3f}, enqueue_votes_s {fold['red']['enqueue_votes_s']:.3f} "
        f"(the host's pile_votes calls, host clock); of the polish: DP {dp_s['polish']:.3f} s, "
        f"fold_s {fold['polish']['ms'] / 1e3:.3f} (DP and fold: CUDA events)")
    dp_seen.clear()
    fold_ev.clear()
    for k, v in step_peak.items():
        log(f"[16 memory] {card}: device peak over {k}: {v / 1e9:.3f} GB above its start")

    # what came out, and the judge
    lens = sorted((len(c) for c in contigs), reverse=True)
    with open(os.path.join(work, "ecoli.contigs.gfa")) as fh:
        gl = [ln.split("\t") for ln in fh.read().splitlines()]
    s_names = {f[1] for f in gl if f[0] == "S"}
    check(all(f[1] in s_names and f[3] in s_names for f in gl if f[0] == "L"),
          "16 ecoliasm: a GFA L-line names a segment that is not an S-line")
    with open(os.path.join(work, "ecoli.layout.tsv")) as fh:
        ids = np.array([int(ln.split("\t")[1]) for ln in fh.read().splitlines()], np.int64)
    n_utg = ReadSet.load(os.path.join(d_utg, "ecoli.gkpStore")).n_reads
    check(len(ids) > 0 and ids.min() >= 1 and ids.max() <= n_utg,
          "16 ecoliasm: a layout.tsv read id is not in the utg store")
    judge = {"contigs": len(contigs), "ng50": int(ev.contig_ng50), "misjoins": int(ev.n_misjoins),
             "identity": float(ev.identity), "genome_fraction": float(ev.genome_fraction),
             "duplication": float(ev.duplication), "placed": int(ev.n_placed),
             "ideal_ng50": int(ev.ideal_ng50), "largest": lens[0] if lens else 0}
    log(f"[16 judge] {card}: sim/bogus.py evaluate_assembly on the card in {t_judge:.1f} s "
        f"({judge_k1} K1 launches): {ev.summary()}; largest contig {judge['largest']}; GFA "
        f"{len(s_names)} S-lines, {sum(1 for f in gl if f[0] == 'L')} L-lines ({n_links[0]} "
        "links re-aligned)")
    log(f"[16 judge] canu_tpu on these reads (BASELINE.md, run r5b): {CANU_TPU_ECOLI['contigs']} "
        f"contigs, NG50 {CANU_TPU_ECOLI['ng50']}, {CANU_TPU_ECOLI['misjoins']} misjoins, identity "
        f"{CANU_TPU_ECOLI['identity']}, genome fraction {CANU_TPU_ECOLI['genome_fraction']}; the "
        f"port's identity {judge['identity']:.5f} is "
        + ("at or above" if judge["identity"] >= TRUTH_IDENTITY else "BELOW")
        + f" tests/test_pipeline.py's {TRUTH_IDENTITY} (reported, not gated)")

    # the CLI on the directory: every stage skips by resume
    with open(os.path.join(work, "ecoli.stage-times.jsonl")) as fh:
        n_lines = len(fh.readlines())
    t = time.time()
    r = subprocess.run([sys.executable, "-m", "canu_tpu_torch", "-p", "ecoli", "-d", work,
                        f"genomeSize={ECOLI_GENOME}", "-pacbio-raw", fasta],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    t_cli = time.time() - t
    out = r.stdout + r.stderr
    skipped = out.count("already done, skipping") + out.count("phase complete, skipping")
    with open(os.path.join(work, "ecoli.stage-times.jsonl")) as fh:
        n_after = len(fh.readlines())
    log(f"[16 cli] python -m canu_tpu_torch -pacbio-raw on the directory: rc {r.returncode} in "
        f"{t_cli:.1f} s; {skipped} skips; stage starts {out.count(': start (attempt')}")
    check(r.returncode == 0, f"16 cli: exit {r.returncode}: {out[-2000:]}")
    check(": start (attempt" not in out and n_after == n_lines and skipped > 0,
          "16 cli: a stage ran again on a finished directory")
    # the stage-boundary inputs as this card made them
    t = time.time()
    cor_recs = fasta_records(cor_out)
    trim_recs = fasta_records(os.path.join(d_trim, "ecoli.trimmedReads.fasta.gz"))
    with open(os.path.join(d_trim, "autoerate.json"), "rb") as fh:
        auto_raw = fh.read()
    with open(os.path.join(work, "ecoli.spec.used"), "rb") as fh:
        spec_raw = fh.read()
    adjusted = OverlapStore.load(os.path.join(d_utg, "ecoli.ovlStore.adjusted"))
    inputs = {
        "corrected": {"n": len(cor_recs), "bases": sum(len(s) for _, s in cor_recs),
                      "sha256": corrected_digest(cor_recs)},
        "trimmed": {"n": len(trim_recs), "bases": sum(len(s) for _, s in trim_recs),
                    "sha256": corrected_digest(trim_recs)},
        "autoerate": {"value": json.loads(auto_raw),
                      "sha256": hashlib.sha256(auto_raw).hexdigest()},
        "red": {"reads": len(corr), "n": sum(len(v) for v in corr.values()),
                "sha256": _sha_of(corrections_records(corr))},
        "adjusted_store": {"n": len(adjusted), "sha256": store_digest(adjusted)},
        "spec_used": {"sha256": hashlib.sha256(spec_raw).hexdigest()},
    }
    log(f"[16 inputs] the stage-boundary inputs (read back in {time.time() - t:.1f} s): "
        + "; ".join(f"{k} {v}" for k, v in inputs.items()))
    same = ref is not None and all(ref["inputs"].get(k) == v for k, v in inputs.items())
    if not same:
        # the reference script's inputs: the corrected reads at 2 bits a
        # base, the trimmed reads' names (cut from them), the autoerate
        # gate, RED's corrections, the adjusted store's a_id < b_id rows
        # and every row's erate, spec.used; with their digests
        shutil.rmtree(ECOLI_ASM_OUT, ignore_errors=True)
        os.makedirs(ECOLI_ASM_OUT)
        np.savez_compressed(os.path.join(ECOLI_ASM_OUT, "corrected.npz"), **pack_records(cor_recs))
        with open(os.path.join(ECOLI_ASM_OUT, "trimmed_names.txt"), "w") as fh:
            fh.write("\n".join(n for n, _ in trim_recs) + "\n")
        np.savez_compressed(os.path.join(ECOLI_ASM_OUT, "red.npz"), **corrections_arrays(corr))
        np.savez_compressed(os.path.join(ECOLI_ASM_OUT, "adjusted_store.npz"),
                            **store_halves(adjusted))
        for name, raw in (("autoerate.json", auto_raw), ("ecoli.spec.used", spec_raw)):
            with open(os.path.join(ECOLI_ASM_OUT, name), "wb") as fh:
                fh.write(raw)
        with open(os.path.join(ECOLI_ASM_OUT, "inputs.json"), "w") as fh:
            json.dump(inputs, fh, indent=1)
        sizes = {f: os.path.getsize(os.path.join(ECOLI_ASM_OUT, f))
                 for f in sorted(os.listdir(ECOLI_ASM_OUT))}
        log(f"[16 inputs] {'no reference' if ref is None else 'an input differs from the reference'}"
            f": the inputs went to chiprun_out/ecoli_asm/ ({sum(sizes.values()) / 1e6:.1f} MB: "
            + ", ".join(f"{k} {v}" for k, v in sizes.items()) + ")")
        if ref is not None:
            for k, v in inputs.items():
                log(f"[16 inputs] {k}: {v} (reference {ref['inputs'].get(k)})")
    check(ref is not None, "16 ecoliasm: no ecoli_assembly_reference.json; the inputs to build "
                           "it are in chiprun_out/ecoli_asm/ (scripts/torch_ecoli_assembly_"
                           "reference.py)")
    check(same, "16 ecoliasm: a stage-boundary input differs from the one the reference was "
                "built from")

    # each stage's outputs against the JAX package's on those inputs
    got: dict = {}
    for tag, d in (("obt", d_trim), ("utg", d_utg)):
        rs = ReadSet.load(os.path.join(d, "ecoli.gkpStore"))
        k = int(cfg.get(tag + "MerSize"))
        pairs = pairs_seen[0 if tag == "obt" else 1]
        sample = template_sample(np.arange(1, rs.n_reads + 1))
        got[tag] = {"gatekeeper_reads": int(rs.n_reads), "gatekeeper_bases": int(rs.total_bases),
                    "frequent_sha256": frequent_digest(os.path.join(d, f"ecoli.ms{k}.frequent.npz")),
                    "n_candidates": int(len(pairs)),
                    "candidates_sha256": hashlib.sha256(np.ascontiguousarray(
                        pairs.astype("<i8")).tobytes()).hexdigest(), **stores[tag]}
        names = {rs.name(int(i)) for i in sample}
        if tag == "obt":
            mine = trimmed_of(trim_recs, names)
            got["trimmed_sample"] = {"n": len(mine), "sha256": corrected_digest(mine)}
        else:
            mine = {int(i): corr[int(i)] for i in sample if int(i) in corr}
            got["red_sample"] = {"reads": len(mine), "n": sum(len(v) for v in mine.values()),
                                 "sha256": _sha_of(corrections_records(mine))}
            ar = rows_of_reads(adjusted, sample)
            got["adjusted_sample"] = {"n": int(len(ar.a_id)), "sha256": store_digest(ar)}
    for key, name in (("utg_layouts", "utgStore"), ("ctg_layouts", "ctgStore")):
        items = tig_records(os.path.join(d_utg, f"ecoli.{name}"))
        got[key] = {"n": len(items), "sha256": _sha_of(items)}
    del cor_recs
    if ref is None:
        log(f"[16 ecoliasm] the stages' outputs on these inputs: {got}")
    for key, want in (ref or {}).get("gates", {}).items():
        log(f"[16 ecoliasm] {key}: {got.get(key)} (reference {want})")
        check(got.get(key) == want, f"16 ecoliasm: {key} differs from the JAX package's")
    log("[16 ecoliasm] every stage equals the JAX package's on its input: "
        + ", ".join((ref or {}).get("gates", {})))

    log(f"[16 ecoliasm] phase wall {time.time() - t_phase:.1f} s")
    shutil.rmtree(work, ignore_errors=True)
    return {"verify_err": verify_err, "verify_split": vsplit, "verify_profiles": vprofs,
            "run_s": t_run, "stage_walls_s": walls, "sub_walls_s": subs, "step_walls_s": step_wall,
            "meryl_routes": routes, "launches": counts, "k1_by_step": k1_in, "judge_k1": judge_k1,
            "judge_k10": judge_k10, "judge_k11": judge_k11, "myers_ends_judge": ends_judge,
            "vote_chunks": chunks_in, "dp_calls": n_dp[0], "dp_s": dp_s, "dp_bound": dp_bound,
            "dp_err": dp_err, "held": held, "fold": fold, "k1_ms": k1_ms, "k1_where": k1["where"],
            "k1_drive": k1_drive, "k1_bound_s": k1["bound_s"], "step_peak_bytes": step_peak,
            "inputs": inputs, "gates": got, "judge": judge, "judge_s": t_judge,
            "links_aligned": n_links[0], "cli_s": t_cli, "phase_s": time.time() - t_phase}


def longread_drive(dev, card: str) -> dict:
    """Phase 17: the cor meryl + overlap stages on reads above 131,072 bases
    (tests/torch_cases.py longread_reads, the port's simulator), so the
    read index is 16,384 words wide, the verify runs 262,144 rows a pair
    and K8 cuts every read's syncmers at pm: the read set's digest, the
    frequent table, the candidate count and the store row for row against
    the JAX package's (longread_overlap_reference.json,
    scripts/torch_longread_reference.py); K7 on the stage's verify group and
    K8's rows of the index, bit for bit against the plain versions."""
    from canu_tpu_torch.sim import simulate as SIM

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_cases import LONG_READ_W, longread_reads, readset_digest

    with open(os.path.join(ROOT, "canu_tpu_torch", "longread_overlap_reference.json")) as fh:
        ref = json.load(fh)
    t = time.time()
    rs = longread_reads(SIM)
    dig = readset_digest(rs)
    log(f"[17 longread] {rs.n_reads} reads of {int(rs.length.min())}-{int(rs.length.max())} "
        f"bases, {rs.total_bases} in all, sha256 {dig} (reference {ref['reads_sha256']})")
    check(dig == ref["reads_sha256"] and rs.n_reads == ref["n_reads"],
          "17 longread: the read set differs from the reference's")
    check(int(rs.length.min()) > 16 * LONG_READ_W // 2,
          "17 longread: a read is not above 131,072 bases")
    rec, _calls, _st, held = drive_stage("17 longread", "cor", 128, rs, dev, ref, "K1")
    check(rec["launches"]["K8"] == rec["launches"]["index_builds"] == 1,
          f"17 longread: {rec['launches']['K8']} K8 launches for "
          f"{rec['launches']['index_builds']} index builds")
    rec["verify_err"] = held_verify_calls("phase 17", *held)
    rec["phase_s"] = time.time() - t
    log(f"[17 longread] {card}: the store equals the JAX package's on reads of up to "
        f"{int(rs.length.max())} bases; phase wall {rec['phase_s']:.1f} s")
    return rec


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "canu_tpu_torch")):
        print("chip_smoke: canu_tpu_torch/ is not beside this script; run it from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    # the port must run without jax and without the JAX package: make any
    # import of either fail
    sys.modules["jax"] = None
    sys.modules["canu_tpu"] = None
    import numpy as np
    import torch

    # ---- 1: device ---------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip()
    log(f"[1 device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}; python {sys.version.split()[0]}")
    log(card)
    record: dict = {"card": card, "torch": torch.__version__}
    ops_row = plain_row_ops()
    log("[1 device] the plain loops' own operations per live row and lane (plain_row_ops; "
        f"the bounds count the least: K1 {K1_ROW_OPS} a row + {K1_SHIFT_OPS} a shift + "
        f"{K1_BX_OPS} a row with b_len in the window, INF-walled {INF_ROW_OPS} a row + "
        f"{INF_CELL_OPS} a cell): "
        + ", ".join(f"{k if isinstance(k, str) else f'{k[0]} band {k[1]}'} {v:.1f}"
                    for k, v in ops_row.items()))
    record["plain_row_ops"] = {str(k): v for k, v in ops_row.items()}

    # ---- 2: build ----------------------------------------------------------
    from canu_tpu_torch.ops import align as AL
    from canu_tpu_torch.ops import myers as MY
    from canu_tpu_torch.ops.kernels import _nvcc
    from canu_tpu_torch.ops.kernels import extend_cuda as EX
    from canu_tpu_torch.ops.kernels import minhash_cuda as MK
    from canu_tpu_torch.ops.kernels import myers_cuda as K1
    from canu_tpu_torch.ops.kernels import trace_cuda as K4
    from canu_tpu_torch.ops.kernels import verify_cuda as VC
    from canu_tpu_torch.ops.kernels import votepile_cuda as K9

    t = time.time()
    sources = (K1.SOURCE, EX.SOURCE, K4.SOURCE, MK.SOURCE, VC.SOURCE, K9.SOURCE)
    built = _nvcc.build(*sources)
    log(f"[2 build] {len(sources)} libraries in {time.time() - t:.1f} s (one nvcc each, in "
        "parallel)")
    record["build_s"] = {}
    for src, (lib, build_s, ptxas) in zip(sources, built):
        log(f"[2 build] {os.path.relpath(lib, ROOT)}: nvcc {build_s:.1f} s")
        for line in ptxas.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                log(f"[2 build] ptxas: {line.strip()}")
        record["build_s"][src.name] = build_s

    # ---- 3a: kernel vs plain, edge cases -----------------------------------
    err = 0
    for name, (args, n_rows, kw) in kernel_cases(dev).items():
        err = max(err, compare(f"K1 edge case {name}",
                               MY.banded_extend_myers_plain(*args, 128, n_rows, **kw),
                               MY.banded_extend_myers(*args, 128, n_rows, **kw)))
        log(f"[3a kernel] K1 edge case {name}: {args[0].shape[0]} extensions x {n_rows} rows "
            f"bit-equal")
    err_ends = myers_ends_edge_checks(dev)
    err_ext = 0
    for band in (128, 256, 640, 1024):
        e_args, e_rows = extend_edge_cases(band, dev)
        err_ext = max(err_ext, check_extend_kernels(f"extend edge cases, band {band}",
                                                    e_args, band, e_rows))
        log(f"[3c kernel] band {band}: {extend_kernel(band)[0]} bit-equal to the plain loop on "
            f"{e_args[0].shape[0]} edge-case extensions x {e_rows} rows")

    # ---- 3d: K4 vs the plain DP, the shared cases ----------------------------
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_cases import DP_GROUP_CASES, dp_group_case, trace_cases

    err_dp = 0
    for band in (128, 200, 256):
        for ef in (False, True):
            args = [torch.from_numpy(x).to(dev) for x in trace_cases(256 + band + int(ef), 256,
                                                                     band)]
            err_dp = max(err_dp, held_dp(f"3d K4 band {band} ends_free {ef}",
                                         ((*args, band, 256), {"ends_free": ef}))[0])
            log(f"[3d kernel] K4 bit-equal to the plain DP on {args[0].shape[0]} jobs x 256 rows "
                f"(tests/torch_cases.py trace_cases), band {band}, ends_free {ef}")
    for B, n_rows, band, ef, short in DP_GROUP_CASES:
        args = [torch.from_numpy(x).to(dev)
                for x in dp_group_case(B + n_rows + band, B, n_rows, band, short)]
        l0 = K4.LAUNCHES
        err_dp = max(err_dp, held_dp(f"3d K4 group {B} x {n_rows}, band {band}",
                                     ((*args, band, n_rows), {"ends_free": ef}))[0])
        check(K4.LAUNCHES == l0 + 1, f"3d: K4 launched {K4.LAUNCHES - l0} times for one DP call")
        log(f"[3d kernel] K4 bit-equal to the plain DP on one launch of {B} jobs x {n_rows} rows "
            f"(tests/torch_cases.py dp_group_case, {'mostly short' if short else 'uniform'} "
            f"t_len), band {band}, ends_free {ef}")

    # ---- 3e: K5 and K6 vs the plain sketch and match, edge cases --------------
    err_mh = minhash_edge_checks(dev)

    # ---- 3f: K7 and K8 vs the plain anchor step and syncmer selection --------
    err_vp = verify_edge_checks(dev)

    # ---- 3g: K9 vs the plain fold, the shared cases ---------------------------
    err_fold = fold_edge_checks(dev, card)

    # ---- 4: the slice ------------------------------------------------------
    from canu_tpu_torch.config import Config
    from canu_tpu_torch.ops import minhash as MH
    from canu_tpu_torch.pipeline import stages
    from canu_tpu_torch.pipeline.driver import make_ctx

    with open(os.path.join(ROOT, "canu_tpu_torch", "cor_overlap_reference.json")) as fh:
        ref = json.load(fh)
    t = time.time()
    rs = bench_reads()
    log(f"[4 slice] read set: {rs.n_reads} reads, {rs.total_bases} bases "
        f"(simulated in {time.time() - t:.1f} s)")
    check(rs.n_reads == ref["n_reads"] and rs.total_bases == ref["total_bases"],
          "bench read set differs from the reference's")
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    cfg = Config()
    cfg.set("genomeSize", "300k")
    ctx = make_ctx(work, "bench", cfg)
    # keep the stage's first verify group's extension inputs (phases 3b
    # and 5) and every K1 launch's inputs (phase 5)
    real_extend, groups = capture_calls(MY, "banded_extend_myers", first_only=True)
    real_rows, k1_calls = capture_calls(MY, "_rows_kernel")
    # and its sketch blocks and block pairs (phase 3e)
    real_sk, sk_calls = capture_calls(MH, "_sketch_kernel")
    real_mt, mt_calls = capture_calls(MH, "_match_kernel")
    # and its first K7 group and every block of its index (phases 3f and 5)
    real_pre, pre4 = capture_pre()
    real_sy, sy4 = capture_syncmer(all_blocks=True, keep_args=True)
    try:
        reset_counts()
        t = time.time()
        fk = stages.meryl(ctx, "cor", rs, device=dev)
        t_meryl = time.time() - t
        st = stages.overlap(ctx, "cor", rs, fk, device=dev)
        torch.cuda.synchronize()
        t_stage = time.time() - t
        counts = read_counts()
        launches, plain_segments = counts["K1"], counts["plain_myers_segments"]
    finally:
        MY.banded_extend_myers, MY._rows_kernel = real_extend, real_rows
        MH._sketch_kernel, MH._match_kernel = real_sk, real_mt
        AL._verify_pre = real_pre
        restore_syncmer(real_sy)
    check(counts["K2"] == counts["K3"] == counts["K4"] == 0 and no_plain(counts),
          f"the cor stage ran the INF-walled engine, the DP or a plain loop: {counts}")
    check_minhash("4 slice", counts, match=True)
    prof = dict(AL.LAST_PROFILE)
    with open(ctx.path("bench.stage-times.jsonl")) as fh:
        sub = [json.loads(ln) for ln in fh if '"cor-overlap.sub"' in ln][-1]["sub_walls_s"]
    log(f"[4 slice] meryl {t_meryl:.2f} s; meryl+overlap {t_stage:.2f} s; overlap sub-walls "
        f"{sub}; verify profile {prof}")
    log(f"[4 slice] K1 launches {launches} (MYERS_GROUP {AL.MYERS_GROUP}); plain-loop "
        f"segments on the card {plain_segments}; K5 {counts['K5']}, K6 {counts['K6']} "
        f"(compact {counts['K6_compact']})")
    check(launches > 0, "kernel K1 never launched during the overlap stage")
    check(plain_segments == 0, "the plain Myers loop ran on the card during the stage")
    check(len(k1_calls) == launches, f"{len(k1_calls)} K1 calls captured, {launches} launched")
    fdig = frequent_digest(os.path.join(work, "correction", "bench.ms16.frequent.npz"))
    check_store("4 slice", st, prof, fdig, ref)
    record.update(stage_s=t_stage, meryl_s=t_meryl, sub_walls_s=sub, verify_profile=prof,
                  rows=len(st), launches=launches, myers_group=AL.MYERS_GROUP,
                  launch_counts=counts)

    # ---- 4c: the cor and obt stages with frequent mers excluded, spilled ----
    record["frequent"] = freq = frequent_drive(dev, card)

    # ---- 4d: stage C on the cor stage's candidates, then their verify ------
    record["placed"] = placed = placed_drive(dev, card, fk)
    err_mh = max(err_mh, held_minhash_calls("phase 4", sk_calls, mt_calls),
                 held_minhash_calls("phase 4c", freq.pop("sketch_calls"),
                                    freq.pop("match_calls")))
    del sk_calls, mt_calls
    err_vp = max(err_vp, held_verify_calls("phase 4", pre4, sy4))

    # ---- 3b: kernel vs plain on real extensions of the first group ----------
    check(len(groups) == 1, "the overlap stage never called banded_extend_myers")
    g_args, g_kw = groups[0]
    g_kw = {n: v for n, v in g_kw.items() if n != "events"}  # verify's own event list
    ext, (band, n_rows) = g_args[:5], g_args[5:7]
    B, rows = ext[0].shape[0], g_kw["max_rows"]
    pick = torch.arange(0, B, max(1, B // 256), device=dev)
    sample = tuple(x[pick] for x in ext)
    ref_s, plain_sample_ms = once_ms(
        lambda: MY.banded_extend_myers_plain(*sample, band, n_rows, **g_kw))
    err = max(err, compare("first-group sample", ref_s,
                           MY.banded_extend_myers(*sample, band, n_rows, **g_kw)))
    k1_sample_ms = cuda_ms(lambda: MY.banded_extend_myers(*sample, band, n_rows, **g_kw), 10)
    log(f"[3b kernel] {len(pick)} of the {B} extensions of the stage's first verify group "
        f"({rows} rows, cap_q {g_kw['partial_cap_q']}) bit-equal; {card}: "
        f"banded_extend_myers {k1_sample_ms:.3f} ms with K1 vs {plain_sample_ms:.1f} ms plain")
    record.update(k1_sample_ms=k1_sample_ms, plain_sample_ms=plain_sample_ms)

    # ---- 5: warm passes, as bench.py times them -----------------------------
    cold: dict = {}
    t = time.time()
    run_pass(rs, fk, dev, timed(cold))
    cold_s = time.time() - t
    walls, splits = [], []
    for rep in range(WARM_PASSES):
        warm: dict = {}
        t = time.time()
        ov, pairs = run_pass(rs, fk, dev, timed(warm))
        walls.append(time.time() - t)
        splits.append(warm)
        log(f"[5 timing] {card}: warm pass {rep + 1}: {walls[-1]:.3f} s -> {len(ov)} "
            f"overlaps, {len(ov) / walls[-1]:.1f} overlaps/s; split "
            + ", ".join(f"{k} {v:.3f} s" for k, v in warm.items())
            + f"; verify profile {dict(AL.LAST_PROFILE)}")
    wall = float(np.median(walls))
    log(f"[5 timing] {card}: cold pass {cold_s:.3f} s; warm pass median {wall:.3f} s -> "
        f"{len(ov) / wall:.1f} overlaps/s")
    record.update(cold_pass_s=cold_s, warm_pass_s=walls, warm_split_s=splits,
                  warm_overlaps=len(ov), overlaps_per_s_median=len(ov) / wall,
                  warm_verify_profile=dict(AL.LAST_PROFILE))

    busy: dict = {}
    tables: list = []
    run_pass(rs, fk, dev, profiled(busy, tables))
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "profile.txt"), "w") as fh:
        fh.write(f"{card}\n" + "\n".join(tables) + "\n")
    log(f"[5 profile] {card}: " + "; ".join(
        f"{k} wall {w:.3f} s, device busy {d:.3f} s ({100 * d / w:.0f}%)"
        for k, (w, d) in busy.items()) + " (tables in chiprun_out/profile.txt)")
    record["profile_wall_busy_s"] = busy

    # K5 and K6 on every launch of the pass, beside their bounds and plain times
    record["minhash"] = mht = minhash_timing(rs, fk, dev, card)
    err_mh = max(err_mh, mht.pop("err"))
    # K7 on phase 4's first verify group and K8's one launch of its index
    record["verify_kernels"] = vkt = verify_timing(pre4[0], sy4, card)
    del pre4, sy4

    # K1 on every launch of the cor stage, and the stage's sum
    k1_launches = [k1_call(c) for c in k1_calls]
    del k1_calls
    k1_group_ms, k1_bounds = time_k1(k1_launches)
    for gi, (ms_g, bd) in enumerate(zip(k1_group_ms, k1_bounds)):
        log(f"[5 timing] {card}: cor K1 launch {gi + 1}/{len(k1_launches)}: "
            f"{k1_launches[gi][0][1].shape[0]} extensions x {k1_launches[gi][0][6]} rows: "
            f"{ms_g:.3f} ms; bound {bd['bound_ms']:.3f} ms ({bd['ops']:.3e} operations: "
            f"{bd['live_rows']} live rows, {bd['shift_rows']} shifted, {bd['bx_rows']} with "
            f"b_len in the window; {bd['bytes']:.3e} bytes; bound by {bd['bound_by']}; "
            f"{100 * bd['bound_ms'] / ms_g:.1f}% of it)")
    ms, bd1 = k1_group_ms[0], k1_bounds[0]
    log(f"[5 timing] {card}: K1 ms per cor stage (MYERS_GROUP {AL.MYERS_GROUP}, "
        f"{len(k1_launches)} launches): {sum(k1_group_ms):.3f} ms; bound "
        f"{sum(b['bound_ms'] for b in k1_bounds):.3f} ms")
    # the same extensions in the launches of 4 chunks that MYERS_GROUP 4 made
    old = [k1_lanes(lc, lo, lo + OLD_GROUP_LANES) for lc in k1_launches
           for lo in range(0, lc[0][0].shape[1], OLD_GROUP_LANES)]
    old_ms, old_bounds = time_k1(old)
    del old
    b0 = old_bounds[0]
    log(f"[5 timing] {card}: the same extensions as MYERS_GROUP 4 launched them: "
        f"{len(old_ms)} launches, {sum(old_ms):.3f} ms per cor stage; the first "
        f"({OLD_GROUP_LANES} extensions, the earlier first group) {old_ms[0]:.3f} ms, bound "
        f"{b0['bound_ms']:.3f} ms ({b0['ops']:.3e} operations, {b0['bytes']:.3e} bytes; "
        f"{100 * b0['bound_ms'] / old_ms[0]:.1f}% of it)")
    record.update(k1_group_ms=k1_group_ms, k1_bounds=k1_bounds,
                  k1_ms_per_cor_stage=sum(k1_group_ms), k1_group4_ms=old_ms,
                  k1_group4_bounds=old_bounds, k1_ms_per_cor_stage_group4=sum(old_ms))
    del k1_launches

    ref_g, plain_ms = once_ms(lambda: MY.banded_extend_myers_plain(*g_args, **g_kw))
    err = max(err, compare("first group", ref_g, MY.banded_extend_myers(*g_args, **g_kw)))
    log(f"[5 timing] {card}: K1 {ms:.3f} ms (bound {bd1['bound_ms']:.3f} ms, "
        f"{100 * bd1['bound_ms'] / ms:.1f}% of it) vs plain loop {plain_ms:.1f} ms for {B} "
        f"extensions x {rows} rows (the stage's first verify group), bit-equal")
    record.update(k1_ms=ms, plain_ms=plain_ms, group_B=B, group_rows=rows)
    # K10 and K11 on the same group, held to the plain chain, then timed; K1
    # with the end pick against K1 and K11 alone
    ends = held_myers_ends("5 first group", g_args[:5], n_rows, g_kw, reps=10, k1_reps=5)
    err_ends = max(err_ends, ends["err"])
    for kn, what in (("K10", "the schedule and row-0 state"), ("K11", "the end pick, alone")):
        e = ends[kn]
        log(f"[5 timing] {card}: {kn} ({what}) {e['ms']:.4f} ms on the first group (bound "
            f"{e['bound']['bound_ms']:.4f} ms by {e['bound']['bound_by']}, "
            f"{100 * e['bound']['bound_ms'] / e['ms']:.1f}% of it) vs the plain chain "
            f"{e['plain_ms']:.3f} ms, bit-equal")
    e10, e11 = ends["K10"], ends["K11"]
    log(f"[5 timing] {card}: K10 read the centres at stride {e10['stride']}; had it read rows "
        f"its bound would be {e10['bound_rows']['bound_ms']:.4f} ms by "
        f"{e10['bound_rows']['bound_by']} ({e10['bound_rows']['bytes']:.3e} bytes, "
        f"{100 * e10['bound_rows']['bound_ms'] / e10['ms']:.1f}% of this K10's time); K1 with "
        f"the end pick {e11['k1_pick_ms']:.3f} ms against K1 then K11 alone "
        f"{e11['k1_then_k11_ms']:.3f} ms")
    record["myers_ends"] = ends

    # ---- 4b: the cor stage at corOvlBandWidth=256 (K2, with partial overlaps,
    # on reads whose extensions really fail) -----------------------------------
    cor256, cor256_calls, st256, held_k78 = drive_stage("4b cor256", "cor", 256, rs, dev,
                                                        ref["cor256"], "K2")
    err_vp = max(err_vp, held_verify_calls("phase 4b", *held_k78))

    def row_set(store):
        cols = [np.asarray(getattr(store, c)).tolist() for c in
                ("a_id", "b_id", "flipped", "a_bgn", "a_end", "b_bgn", "b_end", "erate_q")]
        return set(zip(*cols))

    r128, r256 = row_set(st), row_set(st256)
    cor256["rows_only_band128"], cor256["rows_only_band256"] = len(r128 - r256), len(r256 - r128)
    log(f"[4b cor256] against the band-128 cor store: {len(r128 - r256)} rows only at band "
        f"128, {len(r256 - r128)} only at band 256, {len(r128 & r256)} in both")
    del r128, r256, st256

    # ---- 6, 7: the corrected-read stages -----------------------------------
    with open(os.path.join(ROOT, "canu_tpu_torch", "corrected_overlap_reference.json")) as fh:
        cref = json.load(fh)
    t = time.time()
    crs = bench_reads(error_rate=0.03, seed=44)
    log(f"[6 obt] corrected read set: {crs.n_reads} reads, {crs.total_bases} bases "
        f"(simulated in {time.time() - t:.1f} s)")
    check(crs.n_reads == cref["n_reads"] and crs.total_bases == cref["total_bases"],
          "corrected read set differs from the reference's")
    drives, calls = {}, {}
    drives["obt"], _, _, held_k78 = drive_stage("6 obt", "obt", 128, crs, dev, cref["obt"], "K1")
    err_vp = max(err_vp, held_verify_calls("phase 6", *held_k78))
    for name, band, kname in (("utg256", 256, "K2"), ("utg1024", 1024, "K3")):
        drives[name], calls[name], _, held_k78 = drive_stage(f"7 {name}", "utg", band, crs, dev,
                                                             cref[name], kname)
        err_vp = max(err_vp, held_verify_calls(f"phase 7 {name}", *held_k78))
    del held_k78
    record["corrected"] = drives
    drives["cor256"] = cor256
    calls["cor256"] = cor256_calls

    # ---- 3c: K2 and K3 vs plain on real extensions of each drive's first call
    for name in ("utg256", "utg1024"):
        check(len(calls[name]) > 0, f"the {name} stage never called banded_extend")
        x_args, (x_band, x_rows) = calls[name][0][0][:5], calls[name][0][0][5:7]
        XB = x_args[0].shape[0]
        pick = torch.arange(0, XB, max(1, XB // 256), device=dev)
        err_ext = max(err_ext, check_extend_kernels(
            f"{name} first call sample", tuple(x[pick] for x in x_args), x_band, x_rows))
        log(f"[3c kernel] {len(pick)} of the {XB} extensions of the {name} stage's first "
            f"banded_extend call (band {x_band}, {x_rows} rows) bit-equal in "
            f"{extend_kernel(x_band)[0]}")

    # ---- 8: K2 and K3 on every call of their drives, and the plain loop -----
    ext = {}
    for name in ("cor256", "utg256", "utg1024"):
        ext[name] = extend_drive(name, calls[name], card)
        err_ext = max(err_ext, ext[name]["err"])
    del calls
    log(f"[8 timing] {card}: stage walls (meryl+overlap) "
        + ", ".join(f"{n} {d['stage_s']:.2f} s" for n, d in drives.items()))
    record["extend"] = ext

    # ---- 9: the E. coli-scale obt path -------------------------------------
    record["ecoli"] = ecoli = ecoli_drive(dev, card)

    # ---- 10: read correction from a FASTA ----------------------------------
    record["correct"] = correct = correct_drive(dev, card)

    # ---- 11: trimming and assembly, corrected reads to contigs ---------------
    record["assemble"] = assemble = assemble_drive(dev, card)

    # ---- 12: the tag-chain (dag) consensus, correction and polish ----------
    record["dag"] = dag = dag_drive(dev, card, correct, assemble)

    # ---- 12c: K4 against the plain DP on chunks of phases 10-12, its time --
    record["vote_dp"] = vdp = vote_dp_drive(dev, card, correct, assemble, dag)

    # ---- 13: the tools CLI ---------------------------------------------------
    record["tools"] = tools = tools_drive(dev, card, assemble["b"])

    # ---- 14: the sharded path: a world of one over NCCL, two ranks over gloo
    record["grid"] = grid = grid_drive(dev, card, correct)

    # ---- 15: read correction from a FASTA at E. coli scale -----------------
    record["ecolicor"] = ecolicor = ecolicor_drive(dev, card, vdp["ecoli_dp_s"])
    err_dp = max(err_dp, ecolicor["dp_err"])
    err_mh = max(err_mh, ecolicor["minhash_err"])

    # ---- 16: raw reads to contigs at E. coli scale, correction resumed ------
    record["ecoliasm"] = ecoliasm = ecoliasm_drive(dev, card, ecolicor)
    err_dp = max(err_dp, ecoliasm["dp_err"])
    # ---- 17: reads above 131,072 bases through the cor overlap stage --------
    record["longread"] = longread = longread_drive(dev, card)
    err_vp = max(err_vp, ecoli["verify_err"], assemble["a"]["verify_err"],
                 assemble["b"]["verify_err"], ecolicor["verify_err"], ecoliasm["verify_err"],
                 longread["verify_err"])

    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as fh:
        json.dump(record, fh, indent=1, default=str)
    check(all(sys.modules.get(m) is None for m in ("jax", "canu_tpu")),
          "jax or canu_tpu was imported")

    # K5 and K6 launches in every main-path run: phases 4, 4b, 4c, 6, 7, 9, 10,
    # 11, 14 (14a, and 14b's ranks with their allgather stages), 15, 16 and
    # 17; K7 and K8 launched in each of them, K8 once per index build
    named = {"4": counts, "4c cor": freq["cor"]["launches"], "4c obt": freq["obt"]["launches"],
             "9": ecoli["launches"], "10": correct["launches"], "11a": assemble["a"]["launches"],
             "11b": assemble["b"]["launches"], "14a": grid["a"]["launches"],
             "15": ecolicor["launches"], "16": ecoliasm["launches"],
             "17": longread["launches"], "4d": placed["launches"]}
    named.update({f"drive {n}": d["launches"] for n, d in drives.items()})
    for r, x in enumerate(grid["b"]):
        named[f"14b rank {r}"] = x["launches"]
        named[f"14b rank {r} allgather"] = x["allgather"]["launches"]
    main_runs = list(named.values())
    for name, c in named.items():
        check(c["K7"] > 0 and c["K8"] > 0, f"phase {name}: kernel K7 or K8 never launched "
              f"(K7 {c['K7']}, K8 {c['K8']})")
        check(c["K9"] == c["vote_groups"] and c["plain_fold"] == 0,
              f"phase {name}: kernel K9 launched {c['K9']} times for {c['vote_groups']} DP "
              "groups, or the plain fold ran on the card")
        check(c["plain_pre"] == c["plain_syncmer"] == 0,
              f"phase {name}: the plain anchor step or syncmer selection ran on the card")
        check(c["K8"] == c["index_builds"],
              f"phase {name}: kernel K8 launched {c['K8']} times for {c['index_builds']} "
              "read index builds (one launch a build)")
        check(c["K10"] == c["K11_pick"] == c["K1"] and c["K11"] == 0
              and c["plain_schedule"] == 0 and c["plain_myers_segments"] == 0,
              f"phase {name}: K10 {c['K10']} launches for K1's {c['K1']} ({c['K11_pick']} with "
              f"the end pick), K11 alone {c['K11']}, or the plain schedule "
              f"({c['plain_schedule']}) or plain segments ({c['plain_myers_segments']}) ran on "
              "the card")
    k5_launches = sum(c["K5"] for c in main_runs)
    k6_launches = sum(c["K6"] for c in main_runs)
    k7_launches = sum(c["K7"] for c in main_runs)
    k8_launches = sum(c["K8"] for c in main_runs)
    k9_launches = sum(c["K9"] for c in main_runs)
    builds = sum(c["index_builds"] for c in main_runs)
    log(f"[kernels] K5 launched {k5_launches} times, K6 {k6_launches}, K7 {k7_launches}, K8 "
        f"{k8_launches} and K9 {k9_launches} on the main path's runs (phases 4-17; K7 and K8 "
        f"in each of its {len(named)} runs, K8 once per read index build ({builds} builds), K9 "
        "once per DP group in each run that votes)")
    # K10 once beside each K1 launch of every run (and the judge's), K11's end
    # pick inside each of those K1 launches, and K11 alone never
    k10_launches = sum(c["K10"] for c in main_runs) + ecoliasm["judge_k10"]
    k11_launches = sum(c["K11_pick"] for c in main_runs) + ecoliasm["judge_k11"]
    err_ends = max(err_ends, ecoli["myers_ends"]["err"], ecoliasm["myers_ends_judge"]["err"],
                   placed["myers_ends_err"], tools["myers_ends_err"])
    log(f"[kernels] K10 launched {k10_launches} times, once beside each K1 launch of the main "
        f"path's runs and the judge, and K11's end pick ran inside {k11_launches} of those K1 "
        f"launches (K11 alone: 0); K12 {placed['launches']['K12']} (one a place_candidates call "
        "of phase 4d)")
    k9 = correct["fold"]["held"]
    err_fold = max(err_fold, k9["err"], ecolicor["fold"]["held"]["err"],
                   ecoliasm["fold"]["red"]["held"]["err"],
                   ecoliasm["fold"]["polish"]["held"]["err"])
    src = "canu_tpu_torch/csrc/banded_extend.cu"
    k2, k3 = ext["utg256"], ext["utg1024"]
    k2b, k3b = k2["first_bound_exit"], k3["first_bound_exit"]
    print(json.dumps({"kernels": [
        {"name": "myers_rows (K1)", "route": "cuda",
         "source": "canu_tpu_torch/csrc/myers_tile.cu",
         "replaces": "canu_tpu/ops/pallas/myers_pallas.py:77",
         "launches": launches + drives["obt"]["launches"]["K1"] + ecoli["launches"]["K1"]
         + correct["launches"]["K1"] + assemble["a"]["launches"]["K1"]
         + assemble["b"]["launches"]["K1"] + record["dag"]["polish"]["launches"]["K1"]
         + tools["k1_launches"] + grid["k1_launches"] + ecolicor["launches"]["K1"]
         + ecoliasm["launches"]["K1"] + ecoliasm["judge_k1"] + longread["launches"]["K1"]
         + placed["launches"]["K1"],
         "max_abs_err": max(err, tools["k1_err"]),
         "ms": ms, "plain_ms": plain_ms, "bound_ms": bd1["bound_ms"],
         "bound_by": bd1["bound_by"], "library_ms": None},
        {"name": "extend_warp (K2)", "route": "cuda", "source": src,
         "replaces": "canu_tpu/ops/pallas/extend_x8.py:72",
         "launches": drives["utg256"]["launches"]["K2"] + grid["k2_launches"],
         "max_abs_err": max(err_ext, grid["a"]["k2_err"]),
         "ms": k2["first_ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2b["bound_ms"], "bound_by": k2b["bound_by"], "library_ms": None},
        {"name": "extend_block (K3)", "route": "cuda", "source": src,
         "replaces": "canu_tpu/ops/pallas/extend.py:79",
         "launches": drives["utg1024"]["launches"]["K3"], "max_abs_err": err_ext,
         "ms": k3["first_ms"], "plain_ms": k3["plain_ms"],
         "bound_ms": k3b["bound_ms"], "bound_by": k3b["bound_by"], "library_ms": None},
        {"name": "vote_dp (K4)", "route": "cuda", "source": "canu_tpu_torch/csrc/vote_dp.cu",
         "replaces": "canu_tpu/ops/trace.py:175",
         "launches": correct["launches"]["K4"] + assemble["a"]["launches"]["K4"]
         + assemble["b"]["launches"]["K4"] + dag["correct"]["launches"]["K4"]
         + dag["polish"]["launches"]["K4"] + grid["k4_launches"]
         + ecolicor["launches"]["K4"] + ecoliasm["launches"]["K4"],
         "max_abs_err": max(err_dp, vdp["err"]), "ms": vdp["ms"], "plain_ms": vdp["plain_ms"],
         "bound_ms": vdp["bound"]["bound_ms"], "bound_by": vdp["bound"]["bound_by"],
         "library_ms": None},
        {"name": "minhash_sketch (K5)", "route": "cuda", "source": "canu_tpu_torch/csrc/minhash.cu",
         "replaces": "canu_tpu/ops/minhash.py:53", "launches": k5_launches, "max_abs_err": err_mh,
         "ms": mht["K5"]["sum_ms"], "plain_ms": mht["K5"]["plain_sum_ms"],
         "bound_ms": mht["K5"]["bound"]["bound_ms"], "bound_by": mht["K5"]["bound"]["bound_by"],
         "library_ms": None},
        {"name": "slot_match (K6)", "route": "cuda", "source": "canu_tpu_torch/csrc/minhash.cu",
         "replaces": "canu_tpu/ops/minhash.py:111", "launches": k6_launches,
         "max_abs_err": err_mh, "ms": mht["K6"]["sum_ms"], "plain_ms": mht["K6"]["plain_sum_ms"],
         "bound_ms": mht["K6"]["bound"]["bound_ms"], "bound_by": mht["K6"]["bound"]["bound_by"],
         "library_ms": None},
        {"name": "verify_pre (K7)", "route": "cuda", "source": "canu_tpu_torch/csrc/verify.cu",
         "replaces": "canu_tpu/ops/align.py:385", "launches": k7_launches, "max_abs_err": err_vp,
         "ms": vkt["K7"]["ms"], "plain_ms": vkt["K7"]["plain_ms"],
         "bound_ms": vkt["K7"]["bound"]["bound_ms"], "bound_by": vkt["K7"]["bound"]["bound_by"],
         "library_ms": None},
        {"name": "syncmer (K8)", "route": "cuda", "source": "canu_tpu_torch/csrc/verify.cu",
         "replaces": "canu_tpu/ops/minimizers.py:90", "launches": k8_launches,
         "max_abs_err": err_vp, "ms": vkt["K8"]["ms"], "plain_ms": vkt["K8"]["plain_ms"],
         "bound_ms": vkt["K8"]["bound"]["bound_ms"], "bound_by": vkt["K8"]["bound"]["bound_by"],
         "library_ms": None},
        {"name": "vote_fold (K9)", "route": "cuda", "source": "canu_tpu_torch/csrc/vote_fold.cu",
         "replaces": "canu_tpu/ops/votepile.py:125", "launches": k9_launches,
         "max_abs_err": err_fold, "ms": k9["ms"], "plain_ms": k9["plain_ms"],
         "bound_ms": k9["bound"]["bound_ms"], "bound_by": k9["bound"]["bound_by"],
         "library_ms": None},
        {"name": "myers_prologue (K10)", "route": "cuda",
         "source": "canu_tpu_torch/csrc/myers_tile.cu",
         "replaces": "canu_tpu/ops/myers.py:152 and :172", "launches": k10_launches,
         "max_abs_err": err_ends, "ms": ends["K10"]["ms"], "plain_ms": ends["K10"]["plain_ms"],
         "bound_ms": ends["K10"]["bound"]["bound_ms"],
         "bound_by": ends["K10"]["bound"]["bound_by"], "library_ms": None},
        {"name": "end_pick (K11, inside K1; alone as myers_epilogue)", "route": "cuda",
         "source": "canu_tpu_torch/csrc/myers_tile.cu", "replaces": "canu_tpu/ops/myers.py:336",
         "launches": k11_launches, "max_abs_err": err_ends, "ms": ends["K11"]["ms"],
         "plain_ms": ends["K11"]["plain_ms"], "bound_ms": ends["K11"]["bound"]["bound_ms"],
         "bound_by": ends["K11"]["bound"]["bound_by"], "library_ms": None},
        {"name": "pair_stats (K12)", "route": "cuda", "source": "canu_tpu_torch/csrc/verify.cu",
         "replaces": "canu_tpu/ops/minhash.py:296", "launches": placed["launches"]["K12"],
         "max_abs_err": placed["err"], "ms": placed["ms"], "plain_ms": placed["plain_ms"],
         "bound_ms": placed["bound"]["bound_ms"], "bound_by": placed["bound"]["bound_by"],
         "library_ms": None},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
