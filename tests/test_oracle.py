"""Oracle vs the reference's golden fixtures.

These tests convert the reference's end-to-end golden files
(test/k27.histo, rlong.histo, readN.histo, short.parse_results —
see SURVEY.md section 4) into validation of our trusted host oracle,
which then serves as the generative oracle for the device pipeline.
"""

import numpy as np
import pytest

from dsk_tpu import oracle
from dsk_tpu.kmer import codec
from tests.conftest import load_histo_fixture


def assert_histo_matches(counts, fixture_path):
    expected = load_histo_fixture(fixture_path)
    hist = oracle.histogram(counts, nb_bins=10000)
    got = {a: int(hist[a]) for a in range(1, 10001)}
    assert got == expected


def test_k27_single_gz(data_dir):
    # reference: scripts/simple_test.sh:36-39
    counts = oracle.count_bank(str(data_dir / "read50x_ref10K_e001.fasta.gz"), k=27)
    assert_histo_matches(counts, data_dir / "k27.histo")


def test_k27_multifile_comma_list(data_dir):
    # reference: scripts/simple_test.sh:52-55 — same histogram as single file
    uri = ",".join(str(data_dir / f"c{i}.fasta.gz") for i in range(1, 5))
    counts = oracle.count_bank(uri, k=27)
    assert_histo_matches(counts, data_dir / "k27.histo")


def test_long_reads(data_dir):
    # reference: scripts/simple_test.sh:70-73
    counts = oracle.count_bank(str(data_dir / "longread.fasta"), k=27)
    assert_histo_matches(counts, data_dir / "rlong.histo")


def test_reads_with_N(data_dir):
    # reference: scripts/simple_test.sh:122-125 — split-at-N semantics:
    # one distinct kmer (AA...A, k=20) with abundance 152
    counts = oracle.count_bank(str(data_dir / "readN.fasta"), k=20)
    assert_histo_matches(counts, data_dir / "readN.histo")
    assert len(counts) == 1
    assert list(counts.values()) == [152]


def test_k_equals_readlen(data_dir):
    # reference: scripts/simple_test.sh:88-91 — k=15, abundance-min=1
    counts = oracle.count_bank(str(data_dir / "shortread.fasta"), k=15)
    solid = oracle.solid_counts(counts, abundance_min=1)
    lines = oracle.dump_text(solid, k=15)
    with open(data_dir / "short.parse_results") as f:
        expected = [ln.strip() for ln in f if ln.strip()]
    assert lines == expected


def test_k_gt_readlen_yields_nothing(data_dir):
    # reference: scripts/simple_test.sh:106-112
    counts = oracle.count_bank(str(data_dir / "shortread.fasta"), k=16)
    assert counts == {}


def test_iupac_invalid_chars(data_dir):
    # reference: test/IUPAC.fasta — R/Y/M/W are invalid, split like N
    counts = oracle.count_bank(str(data_dir / "IUPAC.fasta"), k=21)
    # only the 22bp A...AY read (one A^21 kmer) and the final A^21+W read
    # contribute; every kmer is AAAAAAAAAAAAAAAAAAAAA
    assert len(counts) == 1
    (v, a), = counts.items()
    assert codec.kmer_to_string(v, 21) == "A" * 21
    assert a == 2


def test_canonical_gta_tac():
    # reference: README.md:112 — canonical of GTA/TAC is TAC under A<C<T<G
    v = codec.string_to_kmer("GTA")
    assert codec.kmer_to_string(codec.canonical_value(v, 3), 3) == "TAC"


def test_revcomp_roundtrip():
    rng = np.random.default_rng(0)
    for k in (1, 4, 15, 31, 32, 33, 63):
        s = "".join(rng.choice(list("ACGT"), size=k))
        v = codec.string_to_kmer(s)
        rc = codec.revcomp_value(v, k)
        assert codec.revcomp_value(rc, k) == v
        # words round trip
        assert codec.words_to_value(codec.value_to_words(v, k)) == v


def test_album_bank(tmp_path, data_dir):
    # file-of-filenames (reference README.md:60-61, test/file_index)
    album = tmp_path / "album.txt"
    album.write_text(
        "\n".join(str(data_dir / f"c{i}.fasta.gz") for i in range(1, 5)) + "\n"
    )
    counts = oracle.count_bank(str(album), k=27)
    assert_histo_matches(counts, data_dir / "k27.histo")


def test_iupac_codes_split_reads(data_dir):
    # IUPAC ambiguity codes (R/Y/M/W...) are invalid chars that split reads
    # (reference test/IUPAC.fasta semantics, scripts/simple_test.sh:122-135)
    from dsk_tpu.engine.counter import CountEngine
    from dsk_tpu.kmer import codec as c

    uri = str(data_dir / "IUPAC.fasta")
    k = 15
    res = CountEngine(k, batch_rows=8, row_len=64).count(uri)
    expected = oracle.count_bank(uri, k)
    got = {c.words_to_value(r): int(a) for r, a in zip(res.kmers, res.counts)}
    assert got == expected
    # cross-check with a hand construction: windows never contain a
    # non-ACGT byte
    from dsk_tpu.io.bank import open_bank

    for _bid, seq in open_bank(uri).iter_sequences():
        data = seq.data.upper()
        for i in range(len(data) - k + 1):
            win = data[i : i + k]
            if all(ch in b"ACGT" for ch in win):
                v = c.canonical_value(c.string_to_kmer(win.decode()), k)
                assert v in got


@pytest.mark.parametrize("k", list(range(1, 33)))
def test_packed_windows_doubling_matches_naive(k):
    # the doubling rewrite (round 2: O(log k) narrow-dtype passes) must be
    # bit-identical to the per-base definition for every k <= 32
    rng = np.random.default_rng(100 + k)
    seq = rng.integers(0, 5, size=257, dtype=np.uint8)  # 4 = invalid
    codes = np.where(seq == 4, codec.INVALID, seq).astype(np.uint8)
    v, ok = codec.canonical_windows(codes, k)
    n = codes.shape[0]
    for i in range(n - k + 1):
        win = codes[i : i + k]
        valid = bool((win <= 3).all())
        assert valid == ok[i]
        if valid:
            f = 0
            for b in win:
                f = (f << 2) | int(b)
            assert int(v[i]) == codec.canonical_value(f, k)


@pytest.mark.parametrize("k", [33, 63, 64, 65, 96, 127])
def test_canonical_windows_large_k_matches_naive(k):
    # the rolled python-int path equals the per-window definition
    rng = np.random.default_rng(200 + k)
    codes = rng.integers(0, 4, size=400, dtype=np.uint8)
    codes[[50, 51, 300]] = codec.INVALID  # a 248-base valid run for k=127
    v, ok = codec.canonical_windows(codes, k)
    assert ok.any()
    for i in range(codes.shape[0] - k + 1):
        win = codes[i : i + k]
        valid = bool((win <= 3).all())
        assert valid == ok[i]
        f = 0
        for b in win:
            f = (f << 2) | int(b)
        assert v[i] == (codec.canonical_value(f, k) if valid else 0)


@pytest.mark.parametrize("k", [5, 27, 31, 32, 33, 63, 65, 96])
def test_hash_canonical_windows_invariance(k):
    # key(kmer) == key(revcomp(kmer)) for any k; distinct keys == distinct
    # canonical kmers on collision-free-scale data
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, size=4000, dtype=np.uint8)
    rc = (codes ^ 2)[::-1].copy()
    kf, okf = codec.hash_canonical_windows(codes, k)
    kr, okr = codec.hash_canonical_windows(rc, k)
    assert np.array_equal(np.sort(kf[okf]), np.sort(kr[okr][::-1]))
    # distinct keys == distinct canonical kmers (oracle comparison)
    if k <= 32:
        v, ok = codec.canonical_windows(codes, k)
        assert np.unique(kf[okf]).shape[0] == np.unique(v[ok]).shape[0]
    # invalid chars mask identically
    codes2 = codes.copy()
    codes2[::97] = codec.INVALID
    _, ok2 = codec.hash_canonical_windows(codes2, k)
    v2, okv2 = codec.canonical_window_words(codes2, k)
    assert np.array_equal(ok2, okv2)


def test_planner_thinned_distinct_estimate_close():
    # the thinning estimator (factor > 1) must stay within a few percent
    # of the exact distinct count on high-duplication data
    from dsk_tpu.engine import planner as P
    from dsk_tpu.io.bank import open_bank
    import tempfile, os

    rng = np.random.default_rng(0)
    genome = rng.integers(0, 4, size=200_000, dtype=np.uint8)
    reads = []
    for i in range(60_000):  # ~6M bases => windows > 4M => factor > 1
        s = int(rng.integers(0, genome.shape[0] - 100))
        reads.append(genome[s : s + 100])
    b = "".join(
        ">r%d\n%s\n" % (i, codec.decode_codes(r)) for i, r in enumerate(reads)
    )
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "x.fasta")
        with open(path, "w") as f:
            f.write(b)
        s1, d1, s2, d2 = P._host_distinct_two_point(
            open_bank(path), 31, limit_bases=20 << 20
        )
    # exact distinct of the whole sample
    cat = np.concatenate(
        [np.concatenate([r, [codec.INVALID]]) for r in reads]
    ).astype(np.uint8)
    v, ok = codec.canonical_windows(cat, 31)
    exact = np.unique(v[ok]).shape[0]
    assert s2 > 4_000_000  # thinning actually engaged
    assert abs(d2 - exact) / exact < 0.05


def test_comma_list_k31_matches_oracle(data_dir):
    """BASELINE config 2: k=31 over the c1-c4 gzipped comma list —
    canonical counts + abundance histogram vs the host oracle."""
    from dsk_tpu import oracle
    from dsk_tpu.dist.engine import DistCountEngine

    files = ",".join(
        str(data_dir / f"c{i}.fasta.gz") for i in (1, 2, 3, 4)
    )
    want = oracle.count_bank(files, 31)
    res = DistCountEngine(
        31, batch_rows=512, row_len=128, table_cap=1 << 14
    ).count(files)
    got = {
        codec.words_to_value(r): int(c)
        for r, c in zip(res.kmers, res.counts)
    }
    assert got == want
    assert int(res.histogram[1:].sum()) == len(want)
