"""hast_tpu_torch: the PyTorch and CUDA port of hast_tpu, for NVIDIA Hopper.

A sibling of the JAX package, with its module names so each counterpart
is easy to find; ``hast_tpu`` stays the reference it is held against.
It imports torch, never jax, and nothing of ``hast_tpu``: the host
modules it needs are its own copies.

  io/        fastq/fasta readers; the ctypes binding of native/hastio.cpp
             (built by g++ at first use into build/)
  ops/       codec, marker table, k-mer counting and the CUDA kernels
             (csrc/, built by nvcc for sm_90a at first use)
  pipeline/  stage 00 markers; stage 01 classify, barcode splits and
             quartering; stage 02 fake-10X conversion; stage 03 re-phasing
  parallel/  meshes of torch devices, multi-process runs, merge-results
  models/    the HAST.sh orchestrator (00 -> 01 -> 02 -> 03)
  tools/     HAST's host-only tools (library marks, Hi-C binning, VCF QC,
             heat-align diagrams)
  utils/     checkpoints, phase timers, the bounds plot, seeded synthetic
             inputs
  cli.py     every subcommand of hast_tpu's CLI, `warmup` included
"""

__version__ = "0.1.0"
