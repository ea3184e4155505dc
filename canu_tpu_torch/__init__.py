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
  * in-RAM overlap store               -> canu_tpu_torch.stores.overlaps
  * meryl / overlap pipeline stages    -> canu_tpu_torch.pipeline.stages

The numpy-only pieces of ``canu_tpu`` that the port uses (config,
ReadSet, the simulator, bit packing, FASTA/FASTQ reading, the report,
the pipeline context, error estimation) are copied here at their
counterparts' paths.  This package imports nothing of ``canu_tpu`` and
never imports jax.
"""

__version__ = "0.1.0"
