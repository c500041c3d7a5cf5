"""hast_tpu_torch: the PyTorch and CUDA port of hast_tpu, for NVIDIA Hopper.

A sibling of the JAX package, with its module names so each counterpart
is easy to find; ``hast_tpu`` stays the reference it is held against.
It imports torch and never jax: of ``hast_tpu`` it uses only the jax-free
host modules ``io.native``, ``io.fastq``, ``utils.checkpoint`` and
``utils.profiling``.

  ops/       codec, marker table, k-mer counting and the CUDA kernels
             (csrc/, built by nvcc for sm_90a at first use)
  pipeline/  stage 00 markers; stage 01 classify, barcode splits and
             quartering
  utils/     seeded synthetic marker files and stLFR reads
  cli.py     `build-markers`, `classify` and `classify-reads` with --device
"""

__version__ = "0.1.0"
