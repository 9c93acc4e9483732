"""k > 64 spans (W >= 5 words): extraction, engines, planner, store, dump.

The reference compiles spans to k=256 (/root/reference/CMakeLists.txt:42,
README.md:115-122); round 1 stopped testing at k=64 (VERDICT item 5).
"""

import numpy as np
import pytest

from dsk_tpu import oracle
from dsk_tpu.dist.engine import DistCountEngine
from dsk_tpu.engine.counter import CountEngine
from dsk_tpu.engine.planner import plan_resources
from dsk_tpu.kmer import codec

KS = [65, 96, 127, 255]  # 255 = top of the reference's span list (W=16)


@pytest.fixture(scope="module")
def big_fasta(tmp_path_factory):
    rng = np.random.default_rng(3)
    path = tmp_path_factory.mktemp("bigk") / "reads.fasta"
    genome = rng.choice(np.frombuffer(b"ACGT", np.uint8), 4000)
    with open(path, "wb") as f:
        for i in range(300):
            start = int(rng.integers(0, genome.shape[0] - 300))
            read = bytearray(genome[start : start + 300].tobytes())
            if i % 7 == 0:  # sprinkle invalid chars (split semantics)
                read[int(rng.integers(0, len(read)))] = ord("N")
            f.write(b">r%d\n" % i + bytes(read) + b"\n")
    return str(path)


@pytest.mark.parametrize("k", KS)
def test_codec_vectorized_matches_object_path(k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, 600).astype(np.uint8)
    codes[rng.integers(0, 600, 5)] = 0xFF
    words, ok = codec.canonical_window_words(codes, k)
    vals, ok2 = codec.canonical_windows(codes, k)
    np.testing.assert_array_equal(ok, ok2)
    for i in np.nonzero(ok)[0]:
        assert codec.words_to_value(words[i]) == int(vals[i]), i


@pytest.mark.parametrize("k", KS)
def test_engine_matches_oracle(big_fasta, k):
    want = oracle.count_bank(big_fasta, k)
    eng = CountEngine(k, batch_rows=128, row_len=320)
    res = eng.count(big_fasta)
    got = {
        codec.words_to_value(r): int(c)
        for r, c in zip(res.kmers, res.counts)
    }
    assert got == want


@pytest.mark.parametrize("k", [65, 127])
def test_dist_engine_matches_oracle(big_fasta, k):
    want = oracle.count_bank(big_fasta, k)
    eng = DistCountEngine(k, batch_rows=256, row_len=320, table_cap=1 << 15)
    res = eng.count(big_fasta)
    got = {
        codec.words_to_value(r): int(c)
        for r, c in zip(res.kmers, res.counts)
    }
    assert got == want


@pytest.mark.parametrize("k", [96])
def test_dist_engine_bucketized_bigk(big_fasta, k):
    """W=6 word planes through the bucketized flush (partition hash over
    all kmer words; per-bucket batched sorts with 7 operands)."""
    want = oracle.count_bank(big_fasta, k)
    eng = DistCountEngine(
        k, batch_rows=256, row_len=320, table_cap=1 << 15,
        flush_buckets=16,
    )
    assert eng.plan.S > 1
    res = eng.count(big_fasta)
    got = {
        codec.words_to_value(r): int(c)
        for r, c in zip(res.kmers, res.counts)
    }
    assert got == want


@pytest.mark.parametrize("k", [65])
def test_dist_engine_multipass_bigk(big_fasta, k):
    """BASELINE config 4: large-k multi-word kmers WITH multi-pass
    partitioning (pass filter over W=5 word planes)."""
    want = oracle.count_bank(big_fasta, k)
    eng = DistCountEngine(
        k, batch_rows=256, row_len=320, table_cap=1 << 14, n_passes=2,
    )
    res = eng.count(big_fasta, n_passes=2)
    got = {
        codec.words_to_value(r): int(c)
        for r, c in zip(res.kmers, res.counts)
    }
    assert got == want
    assert int(res.histogram[1:].sum()) == len(want)


@pytest.mark.parametrize("k", [127])
def test_spill_bigk(big_fasta, k):
    """W=8 word planes through the SPILL path: 9-word records, host
    split hash over all 8 kmer words, slab drains and count merges at
    the widest span the golden gates pin on hardware."""
    want = oracle.count_bank(big_fasta, k)
    eng = DistCountEngine(
        k, batch_rows=256, row_len=320, table_cap=1 << 13,
        spill_partitions=4, spill_chunk_rows=1 << 13,
    )
    res = eng.count(big_fasta)
    assert res.info["spill"] is True
    got = {
        codec.words_to_value(r): int(c)
        for r, c in zip(res.kmers, res.counts)
    }
    assert got == want


def test_planner_bigk_sampling(big_fasta):
    plan = plan_resources(big_fasta, 96, max_memory_mb=1000)
    # ~300 reads x ~200 windows, high distinctness: the sampled estimate
    # must be in a sane band (not the degenerate windows upper bound x0.2
    # or a python-set timeout path)
    assert 10_000 < plan.est_distinct <= plan.est_bases


def test_end_to_end_store_and_dump(big_fasta, tmp_path):
    from dsk_tpu.engine.run import RunParams, execute
    from dsk_tpu.store.output import OutputStore

    k = 96
    params = RunParams(
        file=big_fasta, kmer_size=k, abundance_min=1,
        out=str(tmp_path / "bigk"), verbose=0, engine="simple",
        batch_rows=128, row_len=320,
    )
    out = execute(params)
    want = oracle.count_bank(big_fasta, k)
    # dsk2ascii round-trip: sorted dump matches the oracle exactly
    from dsk_tpu.cli import dsk2ascii

    txt = tmp_path / "dump.txt"
    dsk2ascii.main(["-file", out.store_path, "-out", str(txt), "-sorted"])
    got = {}
    for line in open(txt):
        s, c = line.split()
        got[codec.string_to_kmer(s)] = int(c)
    assert got == want
    with OutputStore(out.store_path) as store:
        assert store.kmer_size == k
