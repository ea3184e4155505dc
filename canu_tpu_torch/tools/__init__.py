"""Ancillary command-line tools (the reference's standalone binaries); the
port's counterpart of canu_tpu.tools, with the same arguments and outputs.

`python -m canu_tpu_torch.tools <cmd> ...` exposes the utility surface
that the reference ships as separate C++ programs:

  simulate    fastqSimulate (Canu src/fastq-utilities/fastqSimulate.C)
  sample      fastqSample (subsample to coverage or fraction)
  analyze     fastqAnalyze (read stats, GC, N50)
  dump-reads  gatekeeperDumpFASTQ (Canu src/stores/gatekeeperDumpFASTQ.C)
  dump-meta   gatekeeperDumpMetaData -stats
  ov-stats    ovStoreStats / ovStoreHistogram (Canu src/stores/)
  ov-dump     overlapConvert / ovStoreDump (text dump)
  ov-import   overlapImport + mmapConvert (text/PAF -> store; -random N)
  kmer-count  meryl count + histogram + threshold (Canu src/meryl/)
  kmer-op     meryl DB algebra on saved DBs
  map-mers, mask-mers, mer-trim, mercy   the ancillary k-mer tools
  tig-dump    tgStoreDump (fasta/layout/sizes dumps)
  tig-display tgTigDisplay (one tig, human-readable)
  tig-coverage tgStoreCoverageStat
  best-edges  the best-overlap graph's edges and flags (bogart analysis)
  options     the parameter registry
  bogus       bogus + bogusness (assembly-vs-truth evaluation)

Each is a thin CLI over the library.  kmer-count and bogus run their
device work on the card; main(argv, device="cpu") runs them on the CPU.
"""
