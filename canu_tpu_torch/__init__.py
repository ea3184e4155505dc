"""canu_tpu_torch — the canu_tpu assembler ported to PyTorch and CUDA.

The JAX package ``canu_tpu`` is the reference; this package computes the
same results on a torch device (an NVIDIA H100 through hand-written CUDA
kernels, or the CPU through each kernel's plain PyTorch version).  Module
layout and names mirror ``canu_tpu`` so the counterpart of every module is
found at the same path:

  * k-mer counting (meryl)             -> canu_tpu_torch.ops.kmer
  * MinHash sketches + candidates      -> canu_tpu_torch.ops.minhash
  * syncmer read index                 -> canu_tpu_torch.ops.minimizers
  * anchored overlap verification      -> canu_tpu_torch.ops.align
  * banded Myers extension (kernel K1) -> canu_tpu_torch.ops.myers,
                                          canu_tpu_torch.csrc/myers_tile.cu
  * overlap store (in RAM or spilled)  -> canu_tpu_torch.stores.overlaps
  * read correction (vote engine)      -> canu_tpu_torch.ops.falcon,
                                          canu_tpu_torch.ops.votepile
  * RED + OEA                          -> canu_tpu_torch.ops.oea
  * plurality polish                   -> canu_tpu_torch.ops.consensus
  * GFA with re-aligned links          -> canu_tpu_torch.io.gfa
  * stages, phases, run_pipeline, CLI  -> canu_tpu_torch.pipeline,
                                          python -m canu_tpu_torch

The numpy-only pieces of ``canu_tpu`` that the port uses (config,
ReadSet, the simulator, bit packing, FASTA/FASTQ reading, the report,
the pipeline context, error estimation, subread splitting, the tig
store, the best-overlap graph with its repeat and orphan passes, the
object store and the HTML report) are copied here at their
counterparts' paths.  This package imports nothing of ``canu_tpu`` and
never imports jax.
"""

__version__ = "0.1.0"
