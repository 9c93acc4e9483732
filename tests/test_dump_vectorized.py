"""Vectorized text-dump paths (VERDICT r3 weak #4).

The per-row python decode (codec.kmer_to_string over words_to_value)
runs ~100k rows/s — hours at reference-flagship table sizes
(utils/dsk2ascii.cpp:77-107 streams the same dump in C).  The chunked
numpy paths must be byte-identical to it.
"""

import io

import numpy as np
import pytest

from dsk_tpu.kmer import codec
from dsk_tpu.store import text as store_text


def _random_words(n, k, seed):
    rng = np.random.default_rng(seed)
    W = codec.words_per_kmer(k)
    vals = [
        int(rng.integers(0, 4))
        + (int(rng.integers(0, 1 << 62)) << 2) & ((1 << (2 * k)) - 1)
        for _ in range(n)
    ]
    words = np.stack([codec.value_to_words(v, k) for v in vals])
    return words, vals


@pytest.mark.parametrize("k", [15, 27, 31, 33, 63, 96, 127])
def test_words_to_letters_matches_scalar(k):
    words, vals = _random_words(64, k, seed=k)
    letters = codec.words_to_letters(words, k)
    assert letters.shape == (64, k)
    for i, v in enumerate(vals):
        assert letters[i].tobytes().decode() == codec.kmer_to_string(v, k)


def test_format_count_lines_matches_fstring():
    k = 27
    rng = np.random.default_rng(3)
    words, vals = _random_words(200, k, seed=5)
    # counts crossing every digit-length boundary incl. the int32 max
    counts = np.array(
        [1, 9, 10, 99, 100, 101, 2**31 - 1]
        + list(rng.integers(1, 2**31 - 1, size=193)),
        dtype=np.int64,
    )
    got = store_text.format_count_lines(
        codec.words_to_letters(words, k), counts
    )
    want = "".join(
        f"{codec.kmer_to_string(v, k)} {int(c)}\n"
        for v, c in zip(vals, counts)
    )
    assert got.decode() == want


def test_format_count_lines_empty():
    assert store_text.format_count_lines(
        np.empty((0, 5), np.uint8), np.empty((0,), np.int64)
    ) == b""


def test_dump_ascii_vectorized_matches_per_row(data_dir, tmp_path):
    """End-to-end: the chunk-vectorized plain dump equals the per-row
    decode of the same store, byte for byte."""
    from dsk_tpu.engine.run import RunParams, execute
    from dsk_tpu.store.output import OutputStore

    params = RunParams(
        file=str(data_dir / "read50x_ref10K_e001.fasta.gz"),
        kmer_size=27, abundance_min=1, out=str(tmp_path / "d"),
        verbose=0, batch_rows=256, row_len=128,
    )
    execute(params)
    with OutputStore.load(str(tmp_path / "d.dsk")) as store:
        buf = io.BytesIO()
        n = store_text.dump_ascii(store, buf)
        k = store.kmer_size
        want = "".join(
            f"{codec.kmer_to_string(v, k)} {a}\n"
            for v, a in store.iter_items()
        )
        assert n == 93948
        assert buf.getvalue().decode() == want


def test_iter_sorted_rows_matches_heapq_merge(data_dir, tmp_path):
    """The vectorized k-way merge equals the per-row heapq merge on a
    multi-pass store (several sorted runs per partition)."""
    from dsk_tpu.engine.run import RunParams, execute
    from dsk_tpu.store.output import OutputStore

    params = RunParams(
        file=str(data_dir / "read50x_ref10K_e001.fasta.gz"),
        kmer_size=27, abundance_min=1, out=str(tmp_path / "m"),
        verbose=0, batch_rows=256, row_len=128, engine="dist",
    )
    execute(params)
    with OutputStore.load(str(tmp_path / "m.dsk")) as store:
        want = list(store.iter_items_sorted())
        got = []
        for kk, cc in store.iter_sorted_rows(pool_rows=1 << 12):
            for row, c in zip(kk, cc):
                got.append((codec.words_to_value(row), int(c)))
        assert got == want
        vals = [v for v, _ in got]
        assert vals == sorted(vals)


def test_sorted_dump_with_bucketized_tables(data_dir, tmp_path):
    """flush_buckets > 1 gathers BUCKET-MAJOR tables (ascending only
    within each hash bucket); the store's run map must split appends at
    descents or the sorted merge emits out of order (latent round-3
    bug, fixed with _ascending_runs)."""
    from dsk_tpu.engine.run import RunParams, execute
    from dsk_tpu.store.output import OutputStore, _ascending_runs

    params = RunParams(
        file=str(data_dir / "read50x_ref10K_e001.fasta.gz"),
        kmer_size=27, abundance_min=1, out=str(tmp_path / "b"),
        verbose=0, batch_rows=256, row_len=128, engine="dist",
        flush_buckets=8,
    )
    execute(params)
    with OutputStore.load(str(tmp_path / "b.dsk")) as store:
        # run maps hold >1 run per partition (bucket-major appends)
        solid = store._f["dsk/solid"]
        n_runs = sum(
            len(solid[p].attrs["run_sizes"]) for p in solid
        )
        assert n_runs > store.nb_partitions
        vals = []
        for kk, cc in store.iter_sorted_rows(pool_rows=1 << 12):
            for row in kk:
                vals.append(codec.words_to_value(row))
    assert vals == sorted(vals)
    assert len(vals) == 93948


def test_external_sort_fallback_bounded_and_identical(data_dir, tmp_path):
    """A store WITHOUT a run map (legacy/truncated) must still produce
    the byte-identical sorted dump through the external-sort fallback
    (chunk-sorted temp runs + the k-way merge) — the materializing
    lexsort is retired (VERDICT r4 weak #3)."""
    from dsk_tpu.cli import dsk2ascii
    from dsk_tpu.engine.run import RunParams, execute
    from dsk_tpu.store.output import OutputStore

    params = RunParams(
        file=str(data_dir / "read50x_ref10K_e001.fasta.gz"),
        kmer_size=27, abundance_min=1, out=str(tmp_path / "x"),
        verbose=0, batch_rows=256, row_len=128, engine="dist",
    )
    execute(params)
    path = str(tmp_path / "x.dsk")
    assert dsk2ascii.main(
        ["-file", path, "-sorted", "-out", str(tmp_path / "with_map.txt"),
         "-verbose", "0"]
    ) == 0
    # strip every run map -> the run-map merge must refuse, the
    # external fallback must take over
    with OutputStore(path, "a") as store:
        for name in list(store._f["dsk/solid"]):
            ds = store._f["dsk/solid"][name]
            if "run_sizes" in ds.attrs:
                del ds.attrs["run_sizes"]
    with OutputStore.load(path) as store:
        import pytest as _pytest

        with _pytest.raises(ValueError):
            next(iter(store.iter_sorted_rows()))
        # tiny chunk/pool: many temp runs, several merge rounds
        rows = 0
        vals = []
        for kk, cc in store.iter_sorted_rows_external(
            pool_rows=1 << 12, chunk_rows=1 << 10
        ):
            rows += kk.shape[0]
            for row in kk[:: max(kk.shape[0] // 7, 1)]:
                vals.append(codec.words_to_value(row))
        assert rows == 93948
        assert vals == sorted(vals)
    assert dsk2ascii.main(
        ["-file", path, "-sorted", "-out", str(tmp_path / "no_map.txt"),
         "-verbose", "0"]
    ) == 0
    assert (
        (tmp_path / "no_map.txt").read_bytes()
        == (tmp_path / "with_map.txt").read_bytes()
    )


def test_dskdump_streams_partitions(data_dir, tmp_path, capsys):
    """dskdump dsk/solid[/<i>] goes through the chunked iterator: the
    full dump equals the concatenation of the per-partition dumps, and
    per-partition selection still works."""
    from dsk_tpu.cli import dskdump
    from dsk_tpu.engine.run import RunParams, execute
    from dsk_tpu.store.output import OutputStore

    params = RunParams(
        file=str(data_dir / "read50x_ref10K_e001.fasta.gz"),
        kmer_size=27, abundance_min=1, out=str(tmp_path / "p"),
        verbose=0, batch_rows=256, row_len=128, engine="dist",
    )
    execute(params)
    path = str(tmp_path / "p.dsk")
    with OutputStore.load(path) as store:
        nparts = store.nb_partitions
    assert nparts > 1
    assert dskdump.main(["-d", "dsk/solid", path]) == 0
    full = capsys.readouterr().out
    pieces = []
    for i in range(nparts):
        assert dskdump.main(["-d", f"dsk/solid/{i}", path]) == 0
        pieces.append(capsys.readouterr().out)
    assert "".join(pieces) == full
    assert full.count("\n") == 93948


def test_parallel_sorted_dump_byte_identical(tmp_path):
    """The range-sharded parallel sorted dump (VERDICT r4 weak #4) must
    be byte-identical to the serial merge — segment boundaries land
    between rows, equal-to-threshold rows go to exactly one segment."""
    from dsk_tpu.cli import dsk2ascii
    from dsk_tpu.store.output import OutputStore

    rng = np.random.default_rng(0)
    path = str(tmp_path / "big.dsk")
    store = OutputStore.create(path, 15)  # W=1
    for p in range(3):  # 3 partitions x 3 runs: many merge sources
        for _r in range(3):
            vals = np.unique(
                rng.integers(0, 1 << 30, size=300_000, dtype=np.uint32)
            )
            store.append_solid_partition(
                p, vals.reshape(-1, 1), np.ones(vals.size, np.int32)
            )
    store.close()
    out_par = tmp_path / "par.txt"
    out_ser = tmp_path / "ser.txt"
    assert dsk2ascii.main(
        ["-file", path, "-sorted", "-nb-cores", "4",
         "-out", str(out_par), "-verbose", "0"]
    ) == 0
    assert dsk2ascii.main(
        ["-file", path, "-sorted", "-nb-cores", "1",
         "-out", str(out_ser), "-verbose", "0"]
    ) == 0
    assert out_par.stat().st_size > (1 << 21)  # really above threshold
    assert out_par.read_bytes() == out_ser.read_bytes()


def test_ascending_runs_unit():
    from dsk_tpu.store.output import _ascending_runs

    kk = np.array(
        [[0, 5], [0, 9], [1, 2], [0, 0], [2, 2], [1, 1]], np.uint32
    )
    assert _ascending_runs(kk, 2) == [3, 2, 1]
    assert _ascending_runs(kk[:1], 2) == [1]
    assert _ascending_runs(kk[:0], 2) == []
