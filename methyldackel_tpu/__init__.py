"""methyldackel_tpu — a JAX bisulfite methylation-extraction framework.

A from-scratch re-design of the capabilities of MethylDackel
(C/htslib/pthreads) for JAX/XLA on an NVIDIA GPU:

- Host ingest (methyldackel_tpu.io): pure-Python + native-C++ readers for
  BGZF/BAM/BAI, faidx FASTA, BED, bigWig and the BBM mappability codec.
  Decoded alignments become fixed-width structure-of-arrays tensors.
- Compute core (methyldackel_tpu.ops): the per-read/per-base semantics of the
  reference (strand inference, context classification, methylation calling,
  filtering, trimming, mate-overlap arbitration, conversion efficiency) as
  branch-free vectorized JAX ops, and the pileup as a masked scatter-add over
  reference coordinates (XLA integer scatter-add).
- Engine (methyldackel_tpu.engine): genome-window scheduler, the four
  subcommands (extract / mbias / mergeContext / perRead), byte-compatible
  output formatting, SVG rendering.
- Parallel (methyldackel_tpu.parallel): jax.sharding Mesh data parallelism
  over reads with psum-merged position counters, replacing the reference's
  pthread mutex scheduler (main.c:7-15, extract.c:326-350).
"""

__version__ = "0.1.0"

# The reference version whose behavior this framework reproduces
# (/root/reference/Makefile:14).
REFERENCE_VERSION = "0.6.1"


def _tune_malloc():
    """Keep glibc from mmap()ing every large numpy buffer.

    The window pipeline keeps several ~100 MB padded read batches alive
    at once (pipelined windows + the steal lane). With glibc's default
    M_MMAP_THRESHOLD, each batch allocation is a fresh mmap and each free
    a munmap, so every window re-faults and kernel-zeroes ~100 MB once
    several batches cycle concurrently. Raising the mmap/trim
    thresholds lets freed blocks recycle hot heap pages. mallopt() at
    import covers every entry point (CLI, bench, tests) without needing
    env vars at process start. MDTPU_NO_MALLOC_TUNE=1 disables."""
    import ctypes
    import ctypes.util
    import os

    if os.environ.get("MDTPU_NO_MALLOC_TUNE") == "1":
        return
    try:
        libc = ctypes.CDLL(None)
        mallopt = libc.mallopt
    except (OSError, AttributeError):
        return  # non-glibc platform: defaults stand
    mallopt.argtypes = [ctypes.c_int, ctypes.c_int]
    M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
    GiB = 1 << 30
    mallopt(M_MMAP_THRESHOLD, GiB)
    mallopt(M_TRIM_THRESHOLD, GiB)


_tune_malloc()
del _tune_malloc
