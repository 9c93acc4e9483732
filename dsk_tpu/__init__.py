"""dsk_tpu — a k-mer counting framework for accelerators, in JAX.

A from-scratch re-design of the capabilities of GATB/dsk (reference:
DSK 2.3.1 on gatb-core) as array programs compiled by XLA; it runs on an
NVIDIA H100.  The disk-streaming multi-pass architecture of the
reference (doc/paper.tex Algorithm 1) is re-expressed as:

    host input pipeline  ->  batched (B, L) 2-bit read tensors on device
    ->  canonical k-mer extraction (fused shifted-add sweep)
    ->  minimizer/hash routing to owner chips (shard_map + all_to_all)
    ->  per-chip sort + segment-reduce counting
    ->  collective histogram / statistics merge
    ->  self-describing count store + text dump tools.

Semantics contract (pinned by the reference's golden fixtures, see
SURVEY.md section 0): canonical k-mers under the A<C<T<G alphabet order
(encoding A=0, C=1, T=2, G=3 makes canonical = integer min of the 2-bit
packed forward/revcomp codes), reads split at every non-ACGT character,
abundance histogram over all distinct k-mers, solid k-mers filtered by
an abundance threshold (default min=2).
"""

__version__ = "0.1.0"

from dsk_tpu.kmer import codec  # noqa: F401
