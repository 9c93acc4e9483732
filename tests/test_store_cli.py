"""Store round-trip, processors (solidity kinds, histo2D), and CLI tools."""

import os
import subprocess
import sys

import numpy as np
import pytest

from dsk_tpu import oracle
from dsk_tpu.engine import processors
from dsk_tpu.engine.run import RunParams, execute
from dsk_tpu.kmer import codec
from dsk_tpu.store.output import OutputStore
from tests.conftest import load_histo_fixture


def test_store_roundtrip(tmp_path):
    k = 21
    kmers = np.array(
        [codec.value_to_words(v, k) for v in (5, 99, 2**40 + 7)], dtype=np.uint32
    )
    counts = np.array([3, 1, 9], dtype=np.int32)
    hist = np.zeros(10001, dtype=np.int64)
    hist[1] = 1
    hist[3] = 1
    hist[9] = 1
    path = str(tmp_path / "t.dsk")
    with OutputStore.create(path, k) as store:
        store.write_solid_partition(0, kmers, counts)
        store.write_histogram(hist)
        store.set_run_info({"kmer_size": k, "input": "x.fa"})
    with OutputStore.load(path) as store:
        assert store.kmer_size == k
        assert store.nb_partitions == 1
        assert store.n_solid() == 3
        np.testing.assert_array_equal(store.histogram(), hist)
        items = list(store.iter_items())
        assert items == [(5, 3), (99, 1), (2**40 + 7, 9)]
        assert store.run_info()["input"] == "x.fa"
        assert "<kmer_size>21</kmer_size>" in store.run_info_xml()


def test_end_to_end_run_k27(data_dir, tmp_path):
    # full dsk-equivalent run on the reference's main golden input
    params = RunParams(
        file=str(data_dir / "read50x_ref10K_e001.fasta.gz"),
        kmer_size=27,
        abundance_min=1,
        out=str(tmp_path / "k27"),
        histo=True,
        verbose=0,
        batch_rows=512,
        row_len=128,
    )
    out = execute(params)
    with OutputStore.load(out.store_path) as store:
        hist = store.histogram()
        expected = load_histo_fixture(data_dir / "k27.histo")
        assert {a: int(hist[a]) for a in range(1, 10001)} == expected
        # solid set (min=1) == all distinct kmers from the oracle
        expected_counts = oracle.count_bank(params.file, 27)
        assert dict(store.iter_items()) == expected_counts
    # .histo text file matches the fixture byte-for-byte
    with open(out.histo_path) as f, open(data_dir / "k27.histo") as g:
        assert f.read() == g.read()


def test_solidity_kinds():
    counts = np.array([10, 4, 6, 2])
    bank = np.array([[5, 5], [0, 4], [3, 3], [2, 0]])
    lo, hi = 3, 100
    m = lambda kind, **kw: processors.solidity_mask(
        counts, kind, lo, hi, bank_counts=bank, **kw
    ).tolist()
    assert m("sum") == [True, True, True, False]
    assert m("min") == [True, False, True, False]
    assert m("max") == [True, True, True, False]
    assert m("one") == [True, True, True, False]
    assert m("all") == [True, False, True, False]
    # custom: solid only in bank 1 (absent from bank 0)
    assert m("custom", custom=[0, 1]) == [False, True, False, False]
    assert m("custom", custom=[1, 1]) == [True, False, True, False]


def test_single_bank_solidity_fallback():
    counts = np.array([1, 2, 5])
    assert processors.solidity_mask(counts, "min", 2, 4).tolist() == [
        False, True, False,
    ]


def test_histo2d_matrix():
    # bank 0 = assembly, banks 1-2 = reads
    bank = np.array(
        [
            [1, 3, 2],   # asm=1, reads=5
            [0, 2, 0],   # asm=0, reads=2
            [12, 1, 0],  # asm=12 -> clipped to col 10, reads=1
            [2, 0, 0],   # reads=0 -> row 0 (not written)
        ]
    )
    mat = processors.histo2d_matrix(bank, histo_max=10)
    assert mat[5, 1] == 1
    assert mat[2, 0] == 1
    assert mat[1, 10] == 1
    assert mat[0, 2] == 1
    assert mat.sum() == 4


def test_per_bank_counting_composite(data_dir):
    # c1..c4 composite: per-bank counts must sum to the single-file counts
    from dsk_tpu.engine.counter import CountEngine

    files = ",".join(str(data_dir / f"c{i}.fasta.gz") for i in range(1, 5))
    res = CountEngine(27, batch_rows=512, row_len=128).count(files, per_bank=True)
    assert res.bank_counts is not None and res.bank_counts.shape[1] == 4
    np.testing.assert_array_equal(res.bank_counts.sum(axis=1), res.counts)
    # composite count == whole-file count (reference multi-file test,
    # scripts/simple_test.sh:52-55)
    expected = load_histo_fixture(data_dir / "k27.histo")
    got = {a: int(res.histogram[a]) for a in range(1, 10001)}
    assert got == expected
    # per-bank correctness vs oracle
    expected_pb = oracle.count_bank_per_bank(files, 27)
    got_pb = {
        codec.words_to_value(row): vec
        for row, vec in zip(res.kmers, res.bank_counts)
    }
    assert set(got_pb) == set(expected_pb)
    for v, vec in expected_pb.items():
        np.testing.assert_array_equal(got_pb[v], vec)


def test_cli_dsk_and_dsk2ascii(data_dir, tmp_path):
    out_prefix = str(tmp_path / "short")
    r = subprocess.run(
        [
            sys.executable, "-m", "dsk_tpu.cli.dsk",
            "-file", str(data_dir / "shortread.fasta"),
            "-kmer-size", "15",
            "-abundance-min", "1",
            "-out", out_prefix,
            "-verbose", "0",
        ],
        capture_output=True, text=True,
        env={"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin:/usr/local/bin",
             "PYTHONPATH": "/root/repo"},
    )
    assert r.returncode == 0, r.stderr
    r2 = subprocess.run(
        [
            sys.executable, "-m", "dsk_tpu.cli.dsk2ascii",
            "-file", out_prefix + ".dsk", "-c",
        ],
        capture_output=True, text=True,
        env={"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin:/usr/local/bin",
             "PYTHONPATH": "/root/repo"},
    )
    assert r2.returncode == 0, r2.stderr
    with open(data_dir / "short.parse_results") as f:
        expected = [ln.strip() for ln in f if ln.strip()]
    got = [ln for ln in r2.stdout.splitlines() if ln.strip()]
    assert got == expected


def test_k_longer_than_read(data_dir, tmp_path):
    # k = readlen+1 must produce an empty solid set without failing
    # (reference test scripts/simple_test.sh:106-112)
    params = RunParams(
        file=str(data_dir / "shortread.fasta"),
        kmer_size=16,
        out=str(tmp_path / "k16"),
        verbose=0,
    )
    out = execute(params)
    assert out.n_solid == 0
    with OutputStore.load(out.store_path) as store:
        assert store.n_solid() == 0


def test_histo2d_run(data_dir, tmp_path):
    # assembly-first + reads: histo2D file is produced and consistent
    files = ",".join(
        [str(data_dir / "c1.fasta.gz"), str(data_dir / "c2.fasta.gz")]
    )
    params = RunParams(
        file=files, kmer_size=27, out=str(tmp_path / "h2d"),
        histo2d=True, verbose=0, batch_rows=512, row_len=128,
    )
    out = execute(params)
    assert out.histo2d_path is not None
    rows = []
    with open(out.histo2d_path) as f:
        for line in f:
            parts = line.split()
            assert len(parts) == 12  # row label + 11 assembly-abundance cols
            rows.append([int(x) for x in parts])
    total = sum(sum(r[1:]) for r in rows)
    # every distinct kmer with read-abundance >= 1 appears exactly once
    pb = oracle.count_bank_per_bank(files, 27)
    n_read_kmers = sum(1 for vec in pb.values() if vec[1:].sum() >= 1)
    assert total == n_read_kmers


def test_end_to_end_dist_engine(data_dir, tmp_path):
    # the mesh engine through the full run path (8-device CPU mesh)
    params = RunParams(
        file=str(data_dir / "read50x_ref10K_e001.fasta.gz"),
        kmer_size=27,
        abundance_min=1,
        out=str(tmp_path / "k27d"),
        verbose=0,
        batch_rows=512,
        row_len=128,
        engine="dist",
    )
    out = execute(params)
    with OutputStore.load(out.store_path) as store:
        expected = load_histo_fixture(data_dir / "k27.histo")
        hist = store.histogram()
        assert {a: int(hist[a]) for a in range(1, 10001)} == expected
        # 8 partitions: one per mesh chip
        assert store.nb_partitions == 8
        assert dict(store.iter_items()) == oracle.count_bank(params.file, 27)


def test_dsk2ascii_fasta_fastq_modes(data_dir, tmp_path):
    params = RunParams(
        file=str(data_dir / "shortread.fasta"), kmer_size=15,
        abundance_min=1, out=str(tmp_path / "s"), verbose=0,
    )
    execute(params)
    from dsk_tpu.store import text as store_text
    import io as _io

    with OutputStore.load(str(tmp_path / "s.dsk")) as store:
        buf = _io.BytesIO()
        store_text.dump_ascii(store, buf, fasta=True)
        assert buf.getvalue() == b">0__1\nACTGTACGTATAAGA\n"
        buf = _io.BytesIO()
        store_text.dump_ascii(store, buf, fastq=True)
        lines = buf.getvalue().decode().splitlines()
        assert lines[0].startswith("@") and lines[1] == "ACTGTACGTATAAGA"
        assert lines[2] == "+" and len(lines[3]) == 15


def test_end_to_end_large_k(data_dir, tmp_path):
    # multi-word kmers (k=63, W=4) through run + store + dump round-trip
    params = RunParams(
        file=str(data_dir / "longread.fasta"), kmer_size=63,
        abundance_min=1, out=str(tmp_path / "k63"), verbose=0,
        batch_rows=64, row_len=160,
    )
    out = execute(params)
    expected = oracle.count_bank(params.file, 63)
    with OutputStore.load(out.store_path) as store:
        assert store.nb_words == 4
        assert dict(store.iter_items()) == expected


def test_end_to_end_fastq_gz(tmp_path):
    # FASTQ.gz through the whole run path vs oracle
    import gzip

    recs = [
        ("a", "ACGTACGTAGGTTACGTAAC"),
        ("b", "TTACGTAACGGTTACGTAAC"),
        ("c", "ACGTNNGTAGGTTACGTAAC"),
    ]
    fq = tmp_path / "r.fastq.gz"
    with gzip.open(fq, "wt") as f:
        for n, s in recs:
            f.write(f"@{n}\n{s}\n+\n{'F' * len(s)}\n")
    params = RunParams(
        file=str(fq), kmer_size=11, abundance_min=1,
        out=str(tmp_path / "fq"), verbose=0, batch_rows=8, row_len=32,
    )
    out = execute(params)
    with OutputStore.load(out.store_path) as store:
        assert dict(store.iter_items()) == oracle.count_bank(str(fq), 11)


def test_album_file_end_to_end(data_dir, tmp_path):
    # file-of-filenames (album) input through the run path
    album = tmp_path / "album_list"
    with open(album, "w") as f:
        f.write(f"{data_dir}/c1.fasta.gz\n{data_dir}/c2.fasta.gz\n")
    params = RunParams(
        file=str(album), kmer_size=27, abundance_min=1,
        out=str(tmp_path / "alb"), verbose=0, batch_rows=256, row_len=128,
    )
    out = execute(params)
    files = f"{data_dir}/c1.fasta.gz,{data_dir}/c2.fasta.gz"
    with OutputStore.load(out.store_path) as store:
        assert dict(store.iter_items()) == oracle.count_bank(files, 27)


def test_solid_kmers_out_and_out_compress(data_dir, tmp_path):
    """-solid-kmers-out redirects the store; -out-compress compresses its
    datasets; both leave the dump byte-identical (the reference's
    upstream parser defines both flags, SURVEY.md §2.2 CLI surface)."""
    from dsk_tpu.store import text as store_text

    def dump_lines(store_path):
        import io as _io

        with OutputStore.load(store_path) as store:
            buf = _io.BytesIO()
            store_text.dump_ascii(store, buf, False, False)
            return sorted(buf.getvalue().decode().splitlines())

    plain = RunParams(
        file=str(data_dir / "longread.fasta"), kmer_size=27,
        out=str(tmp_path / "plain"), verbose=0,
        batch_rows=256, row_len=256,
    )
    execute(plain)

    custom_store = str(tmp_path / "elsewhere" / "custom.dsk")
    os.makedirs(os.path.dirname(custom_store))
    redirected = RunParams(
        file=str(data_dir / "longread.fasta"), kmer_size=27,
        out=str(tmp_path / "redir"), solid_kmers_out=custom_store,
        out_compress=True, verbose=0, batch_rows=256, row_len=256,
    )
    out = execute(redirected)
    assert out.store_path == custom_store
    assert os.path.exists(custom_store)
    assert not os.path.exists(str(tmp_path / "redir") + ".dsk")

    with OutputStore.load(custom_store) as store:
        f = store._f
        parts = [n for n in f["dsk/solid"]]
        assert parts, "no solid partitions written"
        for n in parts:
            ds = f["dsk/solid"][n]
            if ds.shape[0]:
                assert ds.compression == "zlib"
        assert f["histogram/histogram"].compression == "zlib"

    assert dump_lines(custom_store) == dump_lines(str(tmp_path / "plain") + ".dsk")


def test_out_tmp_places_cache(data_dir, tmp_path, monkeypatch):
    """-out-tmp points the multipass 2-bit batch cache at a chosen
    directory (the reference's temp-partition dir, README.md:127)."""
    from dsk_tpu.engine.counter import CountEngine
    from dsk_tpu.io import cache as bcache

    tmpdir = tmp_path / "scratch"
    tmpdir.mkdir()
    seen = []
    orig = bcache.BatchCacheWriter

    def recorder(path, *a, **kw):
        seen.append(path)
        return orig(path, *a, **kw)

    monkeypatch.setattr(bcache, "BatchCacheWriter", recorder)
    uri = str(data_dir / "read50x_ref10K_e001.fasta.gz")
    eng = CountEngine(27, batch_rows=512, row_len=128)
    res = eng.count(uri, n_passes=2, cache_dir=str(tmpdir))
    got = {codec.words_to_value(r): int(a) for r, a in zip(res.kmers, res.counts)}
    assert got == oracle.count_bank(uri, 27)
    assert seen and all(os.path.dirname(p) == str(tmpdir) for p in seen)
    assert list(tmpdir.iterdir()) == []  # cache cleaned up after the run


def test_dsk2ascii_imports_no_jax():
    """dsk2ascii's parallel dump spawns worker processes that import its
    module; that import chain must never import jax (a worker that
    initialised a device backend would contend for the card)."""
    code = (
        "import sys, dsk_tpu.cli.dsk2ascii, dsk_tpu.cli.dskdump; "
        "sys.exit(1 if 'jax' in sys.modules else 0)"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=root,
        capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": root},
    )
    assert r.returncode == 0, r.stderr
