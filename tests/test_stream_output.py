"""Bounded-memory streaming output (VERDICT r2 missing #2).

The dist engine's pass_sink path must hand tables to the store ONE CHIP
AT A TIME (never materializing the global distinct table), pass appends
must be a complete multi-pass merge (pass tables are disjoint), and the
crash-resume truncation must drop partial writes.  Reference contract:
"memory exactly M" (doc/paper.tex:106-115); 2.7B kmers counted in 4 GB
(doc/human_log:4,23).
"""

import numpy as np
import pytest

from dsk_tpu import oracle
from dsk_tpu.dist.engine import DistCountEngine
from dsk_tpu.engine.run import RunParams, execute
from dsk_tpu.kmer import codec
from dsk_tpu.store.output import OutputStore


def store_as_dict(path):
    out = {}
    with OutputStore.load(path) as store:
        for v, a in store.iter_items():
            out[v] = out.get(v, 0) + a
    return out


def test_pass_sink_bounded_chunks_and_parity(data_dir, tmp_path):
    uri = str(data_dir / "read50x_ref10K_e001.fasta.gz")
    cap = 1 << 14
    eng = DistCountEngine(
        27, batch_rows=512, row_len=128, table_cap=cap, n_passes=2,
    )
    got = {}
    max_chunk = 0

    def sink(pass_id, pid, kk, cc):
        nonlocal max_chunk
        max_chunk = max(max_chunk, kk.shape[0])
        assert kk.shape[0] <= cap  # one chip's table, never the union
        for row, a in zip(kk, cc):
            v = codec.words_to_value(row)
            assert v not in got  # passes disjoint, chips disjoint
            got[v] = int(a)

    res = eng.count(uri, pass_sink=sink)
    assert res.kmers.size == 0  # slim result: nothing materialized
    assert got == oracle.count_bank(uri, 27)
    assert max_chunk > 0
    assert int(res.histogram[1:].sum()) == len(got)


def _force_passes(monkeypatch, n):
    """Pin the plan to n passes (the fixture is too small for the
    mesh-aware planner to multipass it on its own)."""
    import dsk_tpu.engine.run as runmod

    orig = runmod.plan_resources

    def plan(*a, **kw):
        p = orig(*a, **kw)
        p.n_passes = n
        return p

    monkeypatch.setattr(runmod, "plan_resources", plan)


def test_execute_streaming_multipass_matches_oracle(
    data_dir, tmp_path, monkeypatch
):
    uri = str(data_dir / "read50x_ref10K_e001.fasta.gz")
    _force_passes(monkeypatch, 3)
    params = RunParams(
        file=uri, kmer_size=27, abundance_min=1,
        out=str(tmp_path / "mp"), verbose=0, batch_rows=512, row_len=128,
    )
    out = execute(params)
    assert out.result.kmers.size == 0  # streaming: slim in-memory result
    expect = oracle.count_bank(uri, 27)
    assert store_as_dict(out.store_path) == expect
    assert out.n_solid == len(expect)
    assert out.info["config"]["nb_passes"] >= 2


def test_streaming_solidity_threshold(data_dir, tmp_path):
    uri = str(data_dir / "read50x_ref10K_e001.fasta.gz")
    params = RunParams(
        file=uri, kmer_size=27, abundance_min=3,
        out=str(tmp_path / "s"), verbose=0, batch_rows=512, row_len=128,
    )
    out = execute(params)
    expect = {
        v: a for v, a in oracle.count_bank(uri, 27).items() if a >= 3
    }
    assert store_as_dict(out.store_path) == expect
    assert out.n_solid == len(expect)
    # histogram still counts ALL distinct kmers (reference semantics)
    full = oracle.count_bank(uri, 27)
    assert int(out.result.histogram[1:].sum()) == len(full)


def test_truncate_partitions_drops_partial_pass(tmp_path):
    path = str(tmp_path / "t.dsk")
    store = OutputStore.create(path, 15)
    k0 = np.arange(8, dtype=np.uint32).reshape(8, 1)
    store.append_solid_partition(0, k0, np.ones(8, np.int32))
    store.append_solid_partition(1, k0[:4], np.ones(4, np.int32))
    sizes = store.partition_sizes()
    assert sizes == {0: 8, 1: 4}
    # partial later-pass writes: more rows in 0, a brand-new partition 2
    store.append_solid_partition(0, k0[:3] + 100, np.ones(3, np.int32))
    store.append_solid_partition(2, k0[:2], np.ones(2, np.int32))
    store.truncate_partitions(sizes)
    assert store.partition_sizes() == sizes
    store.close()
    with OutputStore.load(path) as s2:
        parts = list(s2.iter_solid())
        assert parts[0][0].shape[0] == 8
        assert (parts[0][0].reshape(-1) == np.arange(8)).all()


def test_streaming_resume_skips_done_passes(data_dir, tmp_path, monkeypatch):
    """Crash after pass 0 (streaming store + checkpoint on disk), then
    resume: only the remaining passes are recounted and the final store
    matches the oracle."""
    uri = str(data_dir / "read50x_ref10K_e001.fasta.gz")
    _force_passes(monkeypatch, 3)
    common = dict(
        file=uri, kmer_size=27, abundance_min=1,
        out=str(tmp_path / "r"), verbose=0, batch_rows=512, row_len=128,
    )

    class _Crash(Exception):
        pass

    orig = DistCountEngine.count_stream
    calls = []

    def crashing(self, *a, **kw):
        calls.append(kw.get("pass_id", 0))
        if len(calls) == 2:  # let pass 0 finish, die inside pass 1
            raise _Crash()
        return orig(self, *a, **kw)

    monkeypatch.setattr(DistCountEngine, "count_stream", crashing)
    with pytest.raises(_Crash):
        execute(RunParams(**common))
    monkeypatch.setattr(DistCountEngine, "count_stream", orig)

    import os

    ck = RunParams(**common).out_prefix() + ".ckpt"
    assert os.path.exists(ck)

    recounted = []

    def counting(self, *a, **kw):
        recounted.append(kw.get("pass_id", 0))
        return orig(self, *a, **kw)

    monkeypatch.setattr(DistCountEngine, "count_stream", counting)
    out = execute(RunParams(resume=True, **common))
    n_passes = out.info["config"]["nb_passes"]
    assert n_passes >= 2
    assert 0 not in recounted  # pass 0 came from the checkpointed store
    assert len(recounted) == n_passes - 1
    assert store_as_dict(out.store_path) == oracle.count_bank(uri, 27)
    assert not os.path.exists(ck)


def test_streaming_peak_rss_independent_of_distinct(data_dir, tmp_path):
    """The bounded-memory contract, probed: counting a 4x-larger
    distinct set through the streaming sink must not grow peak RSS by
    anywhere near the table-size ratio (the reference counts 2.7B kmers
    in exactly 4 GB because partitions stream to disk,
    doc/paper.tex:106-115).  ru_maxrss is a high-water mark, so the
    small run is measured first and the assertion is one-sided with
    generous slack for allocator noise."""
    import resource

    import dsk_tpu.oracle  # noqa: F401  (import before baseline RSS)

    uri = str(data_dir / "read50x_ref10K_e001.fasta.gz")

    def run(tag, cap, n_passes):
        eng = DistCountEngine(
            27, batch_rows=256, row_len=128, table_cap=cap,
            n_passes=n_passes,
        )
        seen = [0]

        def sink(pass_id, pid, kk, cc):
            seen[0] += kk.shape[0]

        eng.count(uri, pass_sink=sink)
        return seen[0]

    # 93948 distinct over the mesh: tiny tables need 4 passes to fit
    small = run("small", 1 << 12, 4)
    rss_after_small = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    big = run("big", 1 << 16, 1)
    rss_after_big = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    assert big == small  # same input, same distinct set, finer chunks
    # 16x larger per-chip tables: RSS may grow by device-side jax noise
    # but must stay far under the 16x a materializing path would show
    assert rss_after_big < rss_after_small * 2 + (200 << 10)  # +200 MB


def test_iter_items_sorted_streaming_merge(data_dir, tmp_path, monkeypatch):
    """The run-map streaming merge must equal the materializing sort on
    a multipass streamed store (many (partition, run) pairs)."""
    uri = str(data_dir / "read50x_ref10K_e001.fasta.gz")
    _force_passes(monkeypatch, 3)
    out = execute(RunParams(
        file=uri, kmer_size=27, abundance_min=1,
        out=str(tmp_path / "sm"), verbose=0, batch_rows=512, row_len=128,
    ))
    with OutputStore.load(out.store_path) as store:
        merged = list(store.iter_items_sorted())
        full = sorted(store.iter_items())
    assert merged == full
    assert [v for v, _ in merged] == sorted(v for v, _ in merged)


def test_iter_items_sorted_raises_without_run_map(tmp_path):
    path = str(tmp_path / "legacy.dsk")
    store = OutputStore.create(path, 15)
    k0 = np.arange(8, dtype=np.uint32).reshape(8, 1)
    store.append_solid_partition(0, k0, np.ones(8, np.int32))
    del store._f["dsk/solid/0"].attrs["run_sizes"]  # legacy store
    with pytest.raises(ValueError):
        list(store.iter_items_sorted())
    store.close()


def test_truncate_keeps_run_map_at_pass_boundary(tmp_path):
    path = str(tmp_path / "t.dsk")
    store = OutputStore.create(path, 15)
    k0 = np.arange(8, dtype=np.uint32).reshape(8, 1)
    store.append_solid_partition(0, k0, np.ones(8, np.int32))
    store.append_solid_partition(0, k0 + 100, np.ones(8, np.int32))
    store.truncate_partitions({0: 8})  # drop the second pass's run
    assert list(store._f["dsk/solid/0"].attrs["run_sizes"]) == [8]
    got = list(store.iter_items_sorted())
    assert [v for v, _ in got] == list(range(8))
    # truncation INSIDE a run invalidates the map
    store.append_solid_partition(0, k0 + 200, np.ones(8, np.int32))
    store.truncate_partitions({0: 12})
    assert "run_sizes" not in store._f["dsk/solid/0"].attrs
    store.close()


def test_per_bank_pass_sink_bounded_and_grouped(data_dir):
    """Per-bank streaming (VERDICT r3 weak #5): the sink receives each
    chip's GROUPED (kmer, total, bank matrix) rows, bounded by one
    chip's table, and the union reproduces the per-bank oracle."""
    files = ",".join(
        str(data_dir / f"c{i}.fasta.gz") for i in (1, 2, 3, 4)
    )
    cap = 1 << 14
    eng = DistCountEngine(
        27, batch_rows=512, row_len=128, table_cap=cap, per_bank=True,
    )
    got = {}

    def sink(pass_id, pid, kk, cc, bmat):
        assert kk.shape[0] <= cap
        assert bmat.shape == (kk.shape[0], 4)
        np.testing.assert_array_equal(bmat.sum(axis=1), cc)
        for row, vec in zip(kk, bmat):
            v = codec.words_to_value(row)
            assert v not in got  # chips disjoint in kmer space
            got[v] = tuple(int(x) for x in vec)

    res = eng.count(files, per_bank=True, pass_sink_per_bank=sink)
    assert res.kmers.size == 0  # slim: nothing materialized
    expect = {
        v: tuple(int(x) for x in vec)
        for v, vec in oracle.count_bank_per_bank(files, 27).items()
    }
    assert got == expect
    assert int(res.histogram[1:].sum()) == len(expect)


def test_execute_per_bank_solidity_streams(data_dir, tmp_path):
    """-solidity-kind min over multiple banks runs through the
    streaming store path on the dist engine and matches the oracle's
    per-bank minima."""
    files = ",".join(
        str(data_dir / f"c{i}.fasta.gz") for i in (1, 2)
    )
    params = RunParams(
        file=files, kmer_size=27, abundance_min=1,
        solidity_kind="min", out=str(tmp_path / "mn"), verbose=0,
        batch_rows=512, row_len=128, engine="dist",
    )
    execute(params)
    got = store_as_dict(str(tmp_path / "mn.dsk"))
    pb = oracle.count_bank_per_bank(files, 27)
    want = {
        v: int(vec.sum())
        for v, vec in pb.items()
        if int(vec.min()) >= 1  # min-solidity at abundance-min 1
    }
    assert got == want
