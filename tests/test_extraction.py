"""Parity tests for the kept k-mer extraction (kmer/device.py).

extract_canonical_planes must agree bit-for-bit with the host oracle
kmer/codec.canonical_windows on every window: the canonical packed value
of each valid window, sentinel planes on invalid ones, and the validity
mask.  The reference pins these semantics via test/short.parse_results
and test/readN.histo (reference scripts/simple_test.sh:88-125).
"""

import numpy as np
import pytest

from dsk_tpu.kmer import codec
from dsk_tpu.kmer.device import extract_canonical_planes

# k values crossing every word-split regime: W=1 (k=15,16), W=2 with
# r<16 (k=21,27,31), r=16 (k=32), W=3 r=1 (k=33), W=4 r=15/16 (k=63,64),
# W=5 r=1 (k=65).
KS = [15, 16, 21, 27, 31, 32, 33, 63, 64, 65]


def _rand_batch(rng, B, L, invalid_frac=0.0):
    batch = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    if invalid_frac:
        bad = rng.random((B, L)) < invalid_frac
        batch = np.where(bad, np.uint8(4), batch)
    return batch


def _check(batch, k):
    planes, valid = extract_canonical_planes(batch, k)
    planes, valid = np.asarray(planes), np.asarray(valid)
    W = codec.words_per_kmer(k)
    assert planes.shape == (W, batch.shape[0], batch.shape[1] - k + 1)
    for r in range(batch.shape[0]):
        want, ok = codec.canonical_windows(batch[r], k)
        np.testing.assert_array_equal(valid[r], ok)
        assert np.all(planes[:, r, ~ok] == 0xFFFFFFFF)
        got = [codec.words_to_value(planes[:, r, i]) for i in np.flatnonzero(ok)]
        assert got == [int(v) for v in np.asarray(want)[ok]]


@pytest.mark.parametrize("k", KS)
def test_extraction_matches_oracle_random(k):
    rng = np.random.default_rng(k)
    _check(_rand_batch(rng, 4, 160), k)


@pytest.mark.parametrize("k", [21, 31, 33, 63])
def test_extraction_matches_oracle_invalid_chars(k):
    rng = np.random.default_rng(100 + k)
    _check(_rand_batch(rng, 4, 160, invalid_frac=0.05), k)


@pytest.mark.parametrize("L", [31, 100, 1024])
def test_extraction_matches_oracle_row_lengths(L):
    rng = np.random.default_rng(L)
    _check(_rand_batch(rng, 2, L, invalid_frac=0.02), 31)


def test_extraction_palindrome_and_homopolymer():
    # fwd == rc ties (even-k palindromes) and G-runs (canonical(G^k)=C^k,
    # exercising the word0 high-bit paths)
    k = 32
    row_g = np.full((1, 128), 3, np.uint8)          # GGGG...
    row_pal = np.tile(np.array([0, 2], np.uint8), 64)[None, :]  # ATAT...
    _check(np.concatenate([row_g, row_pal], axis=0), k)
