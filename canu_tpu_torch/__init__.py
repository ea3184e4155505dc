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

The numpy-only modules of ``canu_tpu`` (config, ReadSet, the simulator,
bit packing, the report, the pipeline context, error estimation) are
imported from there, not copied.  This package never imports jax.
"""

import os as _os

# Importing any canu_tpu module runs canu_tpu/__init__.py, which imports
# jax to configure its compile cache unless this opt-out is set.  Set it
# before the first canu_tpu import so the port stays jax-free.
_os.environ.setdefault("CANU_TPU_NO_COMPILE_CACHE", "1")

__version__ = "0.1.0"
