"""Superkmer-compressed routing on the CPU mesh (SURVEY.md C6;
reference CHANGELOG.md:13 — KMC3-style superkmer rework).

Byte-exactness vs the oracle plus the interconnect-bytes accounting: a routed
record carries (RW+1) u32 words for ~mean-span windows, vs (WK+1) words
PER window for hash routing.
"""

import numpy as np
import pytest

from dsk_tpu import oracle
from dsk_tpu.dist.engine import DistCountEngine
from dsk_tpu.kmer import codec
from dsk_tpu.kmer.minimizer import (
    pack_rows_2bit,
    superkmer_records,
    unpack_records_to_rows,
)


def test_pack_unpack_roundtrip():
    rng = np.random.default_rng(0)
    batch = rng.integers(0, 4, (4, 96)).astype(np.uint8)
    packed = np.asarray(pack_rows_2bit(batch))
    # zero offset: unpack each row fully
    import jax.numpy as jnp

    out = np.asarray(
        unpack_records_to_rows(
            jnp.asarray(packed), jnp.zeros(4, jnp.int32), 96
        )
    )
    np.testing.assert_array_equal(out, batch)


def test_records_partition_windows():
    """Every valid window belongs to exactly one record's span."""
    rng = np.random.default_rng(1)
    batch = rng.integers(0, 4, (8, 128)).astype(np.uint8)
    batch[rng.random(batch.shape) < 0.02] = 0xFF
    k, m, max_span = 31, 10, 16
    import jax.numpy as jnp

    rec_mins, is_rec, span, packed, mins = superkmer_records(
        jnp.asarray(batch), k, m, max_span
    )
    is_rec = np.asarray(is_rec)
    span = np.asarray(span)
    from dsk_tpu.kmer.device import extract_canonical

    _, valid = extract_canonical(jnp.asarray(batch), k)
    valid = np.asarray(valid)
    covered = np.zeros_like(valid, dtype=np.int32)
    B, nw = valid.shape
    for b in range(B):
        for w in range(nw):
            if is_rec[b, w]:
                assert 1 <= span[b, w] <= max_span
                covered[b, w : w + span[b, w]] += 1
    np.testing.assert_array_equal(covered, valid.astype(np.int32))


@pytest.mark.parametrize("k", [21, 31])
def test_superkmer_engine_matches_oracle(data_dir, k):
    uri = str(data_dir / "read50x_ref10K_e001.fasta.gz")
    want = oracle.count_bank(uri, k)
    eng = DistCountEngine(
        k, batch_rows=256, row_len=128, table_cap=1 << 15,
        routing="superkmer", minimizer_size=8, max_span=16,
    )
    assert eng.routing == "superkmer"
    res = eng.count(uri)
    got = {
        codec.words_to_value(r): int(c)
        for r, c in zip(res.kmers, res.counts)
    }
    assert got == want


def test_superkmer_with_repartition_table(data_dir):
    """Frequency-balanced minimizer->partition table as the owner map."""
    from dsk_tpu.kmer import minimizer as mz
    from dsk_tpu.io.bank import open_bank

    uri = str(data_dir / "read50x_ref10K_e001.fasta.gz")
    k, m = 27, 8
    bank = open_bank(uri)
    freq = mz.sample_minimizer_frequencies(bank, k, m)
    table = mz.build_repartition(freq, 8, frequency_aware=True)
    eng = DistCountEngine(
        k, batch_rows=256, row_len=128, table_cap=1 << 15,
        routing="superkmer", minimizer_size=m, max_span=16,
        repartition=table,
    )
    res = eng.count(uri)
    want = oracle.count_bank(uri, k)
    got = {
        codec.words_to_value(r): int(c)
        for r, c in zip(res.kmers, res.counts)
    }
    assert got == want


def test_ici_bytes_drop():
    """Static plan accounting: routed bytes per window shrink vs hash
    routing by ~(mean span)/(records' word overhead)."""
    k = 31
    hash_eng = DistCountEngine(31, batch_rows=256, row_len=128,
                               table_cap=1 << 14)
    sk_eng = DistCountEngine(31, batch_rows=256, row_len=128,
                             table_cap=1 << 14,
                             routing="superkmer", minimizer_size=10,
                             max_span=32)
    n = hash_eng.n
    if n == 1:
        pytest.skip("needs a multi-device mesh")
    WK = hash_eng.WK
    # per batch, bytes over the all_to_all:
    hash_bytes = n * hash_eng.plan.send_cap * (WK + 1) * 4
    SKL = sk_eng.max_span + k - 1
    RW = (SKL + 30) // 16
    sk_bytes = n * sk_eng.plan.send_cap * (RW + 1) * 4
    # same window volume routed; superkmer must cut bytes >= 2x even with
    # its extra slack (real cut on non-deduped streams is ~(k-m)/2)
    assert sk_bytes * 2 <= hash_bytes, (sk_bytes, hash_bytes)
