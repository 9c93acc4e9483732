"""Host-side partition spill (dist/spill.py + engine spill mode).

The disk half of DSK's fill/count split (reference doc/paper.tex:71-91:
routed kmers live in disk partitions, counted one at a time, so memory
stays exactly M regardless of scale — doc/human_log:4's 7 passes x 86
partitions in 4 GB).  VERDICT r3 missing #2.
"""

import os

import numpy as np
import pytest

from dsk_tpu import oracle
from dsk_tpu.dist.spill import (
    SpillDiskOverflow,
    SpillStore,
    kmer_hash_planes_np,
)
from dsk_tpu.engine.run import RunParams, execute
from dsk_tpu.kmer import codec

URI = os.path.join(os.path.dirname(__file__), "data", "read50x_ref10K_e001.fasta.gz")
K = 27


def test_hash_parity_np_vs_device():
    """The host split must agree bit-exactly with the device's pid
    assignment (kmer/device.py kmer_hash_planes)."""
    import jax.numpy as jnp

    from dsk_tpu.kmer.device import kmer_hash_planes

    rng = np.random.default_rng(7)
    planes = [rng.integers(0, 2**32, size=257, dtype=np.uint32) for _ in range(3)]
    dev = np.asarray(kmer_hash_planes(tuple(jnp.asarray(p) for p in planes)))
    host = kmer_hash_planes_np(planes)
    np.testing.assert_array_equal(dev, host)


def test_spill_store_roundtrip(tmp_path):
    st = SpillStore(str(tmp_path / "sp"), wk=2)
    rows = np.arange(30, dtype=np.uint32).reshape(10, 3)
    st.append(3, rows[:6])
    st.append(3, rows[6:])
    st.append(1, rows[:2])
    assert st.rows(3) == 10 and st.rows(1) == 2
    assert st.partitions() == [1, 3]
    np.testing.assert_array_equal(st.read_chunk(3, 0, 10), rows)
    np.testing.assert_array_equal(st.read_chunk(3, 8, 10), rows[8:])
    assert st.read_chunk(3, 10, 5).shape == (0, 3)
    st.delete()
    assert not os.path.exists(st._path(3))


def test_spill_store_handle_pool(tmp_path):
    """More partitions than MAX_OPEN handles: appends/reads stay correct
    (the reference's figure-1 sweep dies on open-file exhaustion,
    doc/figure-1/droso_log:7 — the LRU pool prevents that here)."""
    st = SpillStore(str(tmp_path / "sp"), wk=1)
    n_parts = SpillStore.MAX_OPEN + 9
    for pid in range(n_parts):
        st.append(pid, np.full((2, 2), pid, np.uint32))
        st.append(pid, np.full((1, 2), pid + 1000, np.uint32))
    assert len(st._open) <= SpillStore.MAX_OPEN
    for pid in range(n_parts):
        got = st.read_chunk(pid, 0, 3)
        assert got.shape == (3, 2)
        assert int(got[0, 0]) == pid and int(got[2, 0]) == pid + 1000
    st.delete()


def test_spill_store_split(tmp_path):
    """Modulus-doubling split: children partition the parent exactly by
    the routing hash, nothing lost or duplicated."""
    st = SpillStore(str(tmp_path / "sp"), wk=2)
    rng = np.random.default_rng(11)
    rows = rng.integers(0, 2**32, size=(500, 3), dtype=np.uint32)
    P, pid = 4, 2
    h = kmer_hash_planes_np([rows[:, 0], rows[:, 1]])
    mine = rows[h % P == pid]
    st.append(pid, mine)
    st.split(pid, P, pid, new_pid=7)
    lo = st.read_chunk(pid, 0, st.rows(pid))
    hi = st.read_chunk(7, 0, st.rows(7))
    assert lo.shape[0] + hi.shape[0] == mine.shape[0]
    hlo = kmer_hash_planes_np([lo[:, 0], lo[:, 1]])
    hhi = kmer_hash_planes_np([hi[:, 0], hi[:, 1]])
    assert (hlo % (2 * P) == pid).all()
    assert (hhi % (2 * P) == pid + P).all()
    both = np.concatenate([lo, hi])
    assert {tuple(r) for r in both} == {tuple(r) for r in mine}
    st.delete()


def test_spill_store_disk_budget(tmp_path):
    st = SpillStore(str(tmp_path / "sp"), wk=2, max_disk_mb=1)
    big = np.zeros((50000, 3), np.uint32)  # 600 KB per append
    st.append(0, big)
    with pytest.raises(SpillDiskOverflow):
        st.append(1, big)
    st.delete()


def _spill_engine(n_chips, **kw):
    import jax

    from dsk_tpu.dist.engine import DistCountEngine, Mesh

    mesh = Mesh(np.array(jax.devices()[:n_chips]), ("chips",))
    args = dict(
        batch_rows=512, row_len=128, table_cap=1 << 14, buf_batches=8,
        spill_partitions=8, spill_chunk_rows=1 << 14,
    )
    args.update(kw)
    return DistCountEngine(K, mesh=mesh, **args)


def _as_table(res):
    return {
        codec.words_to_value(r): int(c)
        for r, c in zip(res.kmers, res.counts)
    }


@pytest.fixture(scope="module")
def expect():
    return oracle.count_bank(URI, K)


def test_spill_single_chip_oracle(expect):
    res = _spill_engine(1).count(URI)
    assert res.info["spill"] is True
    assert _as_table(res) == expect
    assert int(res.histogram[1:].sum()) == len(expect)


def test_spill_multi_chip_oracle(expect):
    res = _spill_engine(4).count(URI)
    assert _as_table(res) == expect


def test_spill_overflow_splits_locally(expect):
    """A partition whose distinct count exceeds the table splits in
    place (modulus doubling) — the input is never re-read."""
    res = _spill_engine(
        1, table_cap=1 << 13, spill_partitions=4, spill_chunk_rows=1 << 13
    ).count(URI)
    assert res.info["spill_splits"] > 0
    assert _as_table(res) == expect


def test_spill_multipass(expect):
    """Spill composes with multi-pass (pass filter upstream of the
    partition hash; per-pass buckets are deleted at pass end)."""
    res = _spill_engine(2, n_passes=2).count(URI, n_passes=2)
    assert _as_table(res) == expect


def test_spill_pass_sink_bounded(expect, tmp_path):
    """The bounded-memory sink contract: every (partition, kmer, count)
    lands through pass_sink; the result is slim (no materialized
    table)."""
    got = {}

    def sink(pass_id, pid, kk, cc):
        for row, c in zip(kk, cc):
            v = codec.words_to_value(row)
            assert v not in got  # partitions are disjoint
            got[v] = int(c)

    res = _spill_engine(1).count(URI, pass_sink=sink)
    assert res.kmers.shape[0] == 0
    assert got == expect
    assert int(res.histogram[1:].sum()) == len(expect)


# -- per-bank spill (VERDICT r4 missing #3): DSK's fixed-memory contract
# must cover histo2D / non-sum solidity too (reference README.md:96-99,
# doc/paper.tex:71-91 — the per-partition processor chain sees every
# bank's copies of a kmer together) -------------------------------------


def _bank_files(data_dir, n=4):
    return ",".join(str(data_dir / f"c{i}.fasta.gz") for i in range(1, n + 1))


def test_spill_per_bank_sink_grouped(data_dir):
    """Per-bank spill sink: each partition arrives GROUPED per kmer
    (total + bank matrix), the union reproduces the per-bank oracle,
    and the histogram counts kmers (not (kmer, bank) rows)."""
    files = _bank_files(data_dir)
    eng = _spill_engine(1, per_bank=True)
    got = {}

    def sink(pass_id, pid, kk, cc, bmat):
        assert bmat.shape == (kk.shape[0], 4)
        np.testing.assert_array_equal(bmat.sum(axis=1), cc)
        for row, vec in zip(kk, bmat):
            v = codec.words_to_value(row)
            assert v not in got  # partitions disjoint in kmer space
            got[v] = tuple(int(x) for x in vec)

    res = eng.count(files, per_bank=True, pass_sink_per_bank=sink)
    assert res.kmers.size == 0  # slim: nothing materialized
    expect = {
        v: tuple(int(x) for x in vec)
        for v, vec in oracle.count_bank_per_bank(files, K).items()
    }
    assert got == expect
    assert int(res.histogram[1:].sum()) == len(expect)


def test_spill_per_bank_collect_multichip(data_dir):
    """Collect mode over a 4-chip mesh: grouped kmers + bank_counts."""
    files = _bank_files(data_dir)
    res = _spill_engine(4, per_bank=True).count(files, per_bank=True)
    expect = oracle.count_bank_per_bank(files, K)
    got = {
        codec.words_to_value(row): tuple(int(x) for x in vec)
        for row, vec in zip(res.kmers, res.bank_counts)
    }
    assert got == {
        v: tuple(int(x) for x in vec) for v, vec in expect.items()
    }
    np.testing.assert_array_equal(
        res.bank_counts.sum(axis=1), res.counts.astype(np.int64)
    )
    assert int(res.histogram[1:].sum()) == len(expect)


def test_spill_per_bank_split_keeps_banks_together(data_dir):
    """A forced partition split must hash the W kmer words ONLY (never
    the bank plane) so grouping stays complete after modulus doubling."""
    files = _bank_files(data_dir)
    eng = _spill_engine(
        1, per_bank=True, table_cap=1 << 12, spill_partitions=2,
        spill_chunk_rows=1 << 12,
    )
    got = {}

    def sink(pass_id, pid, kk, cc, bmat):
        for row, vec in zip(kk, bmat):
            v = codec.words_to_value(row)
            assert v not in got  # a split must not tear a kmer's banks apart
            got[v] = tuple(int(x) for x in vec)

    res = eng.count(files, per_bank=True, pass_sink_per_bank=sink)
    assert res.info["spill_splits"] > 0
    expect = {
        v: tuple(int(x) for x in vec)
        for v, vec in oracle.count_bank_per_bank(files, K).items()
    }
    assert got == expect


def test_execute_spill_per_bank_matches_table_engine(data_dir, tmp_path):
    """-spill on with -histo2D + -solidity-kind min produces the same
    store, .histo and .histo2D as the table engine — the full CLI-level
    per-bank spill path (planner, per-bank sink, store)."""
    from dsk_tpu.store.output import OutputStore

    files = _bank_files(data_dir, n=2)

    def run(tag, **kw):
        params = RunParams(
            file=files, kmer_size=K, abundance_min=1,
            solidity_kind="min", histo=True, histo2d=True,
            out=str(tmp_path / tag), engine="dist",
            batch_rows=256, row_len=128, verbose=0, checkpoint=False,
            **kw,
        )
        out = execute(params)
        with OutputStore.load(out.store_path) as st:
            items = sorted(st.iter_items())
        return out, items

    out_s, items_s = run("spill", spill="on", spill_partitions=4)
    out_d, items_d = run("plain", spill="off")
    assert out_s.result.info.get("spill") is True
    assert items_s == items_d
    for suffix in (".histo", ".histo2D"):
        assert (
            open(str(tmp_path / "spill") + suffix).read()
            == open(str(tmp_path / "plain") + suffix).read()
        )


# -- planner decision + execute() wiring ---------------------------------


def _plan(f, rates, monkeypatch, spill="auto", mem=1):
    from dsk_tpu.engine import planner

    monkeypatch.setattr(planner, "_WIRE_RATES", None)
    monkeypatch.setenv("DSK_TPU_SPILL_RATES", rates)
    return planner.plan_resources(
        f, K, max_memory_mb=mem, n_chips=1, sample=False, spill=spill
    )


def test_planner_spill_decision_follows_measured_rates(
    data_dir, monkeypatch
):
    """Fast wire (PCIe metal) -> spill replaces the pass ladder; slow
    wire (a few MB/s) -> passes stay cheaper.  The decision is the
    measured-cost inequality of VERDICT r3 next-item 1."""
    f = str(data_dir / "read50x_ref10K_e001.fasta.gz")
    fast = _plan(f, "100000,100000", monkeypatch)
    assert fast.spill and fast.n_partitions >= 1
    assert fast.n_passes == 1  # disk is plentiful: one stream suffices
    slow = _plan(f, "0.001,0.001", monkeypatch)
    assert not slow.spill
    assert slow.n_passes > 1  # HBM-bound ladder retained
    off = _plan(f, "100000,100000", monkeypatch, spill="off")
    assert not off.spill
    on = _plan(f, "0.001,0.001", monkeypatch, spill="on")
    assert on.spill  # pinned on wins regardless of rates


def test_execute_spill_matches_default(data_dir, tmp_path):
    """-spill on produces a byte-identical histogram and the same solid
    set as the default table engine, through the full CLI-level path
    (planner, store, sink)."""
    from dsk_tpu.store.output import OutputStore

    f = str(data_dir / "read50x_ref10K_e001.fasta.gz")

    def run(tag, **kw):
        params = RunParams(
            file=f, kmer_size=K, abundance_min=1,
            out=str(tmp_path / tag), histo=True, engine="dist",
            batch_rows=256, row_len=128, verbose=0, checkpoint=False,
            **kw,
        )
        out = execute(params)
        with OutputStore.load(out.store_path) as st:
            items = sorted(st.iter_items())
        return out, items

    out_s, items_s = run("spill", spill="on", spill_partitions=4)
    out_d, items_d = run("plain", spill="off")
    assert items_s == items_d
    assert (
        open(tmp_path / "spill.histo").read()
        == open(tmp_path / "plain.histo").read()
    )
    assert out_s.result.info.get("spill") is True


def test_execute_spill_disk_valve(data_dir, tmp_path, monkeypatch):
    """A spill store that exceeds -max-disk raises the typed
    SpillDiskOverflow and the execute() valve doubles the passes —
    the reference's n_iters = ceil(v*b/D) rule (doc/paper.tex:66)."""
    from dsk_tpu.engine import run as run_mod
    from dsk_tpu.engine.planner import ResourcePlan

    f = str(data_dir / "read50x_ref10K_e001.fasta.gz")
    # the fixture spills ~1.26 MB of records in one pass; a 1 MB budget
    # must overflow, and 2+ passes must fit
    tiny = ResourcePlan(
        n_passes=1, table_cap=1 << 15, flush_items=1 << 18,
        buf_batches=8, batch_rows=256, row_len=128,
        est_bases=500_000, est_distinct=1 << 15,
        est_distinct_per_pass=1 << 15, spill=True, n_partitions=4,
    )
    monkeypatch.setattr(run_mod, "plan_resources", lambda *a, **kw: tiny)
    params = RunParams(
        file=f, kmer_size=K, abundance_min=1,
        out=str(tmp_path / "v"), histo=True, engine="dist",
        batch_rows=256, row_len=128, verbose=0, checkpoint=False,
        max_disk=1, spill="on",
    )
    out = execute(params)
    assert out.result.info.get("n_passes", 1) >= 2  # the valve fired
    got = {
        i: int(c)
        for i, c in enumerate(out.result.histogram)
        if c and i > 0
    }
    from tests.conftest import load_histo_fixture

    want = {
        a: c
        for a, c in load_histo_fixture(data_dir / "k27.histo").items()
        if c
    }
    assert got == want


def test_spill_multi_slab_drain(expect, monkeypatch):
    """The drain's slab loop (bounded fetches with a runtime offset;
    the last slab overlaps and is host-skipped) must be value-exact —
    force tiny slabs so every group drains in several."""
    from dsk_tpu.dist import engine as eng_mod

    monkeypatch.setattr(eng_mod, "_SPILL_SLAB_ROWS", 1 << 12)
    res = _spill_engine(1).count(URI)
    assert _as_table(res) == expect


# -- mid-pass resume (VERDICT r4 weak #6): the fill's bucket files are
# durable, so a crash mid-count must resume with ZERO input re-reads ---


class _Boom(Exception):
    pass


def test_spill_midpass_resume_engine(expect, tmp_path, monkeypatch):
    """Crash after 2 counted partitions; the resumed run never calls
    the reader (fill skipped), never re-emits counted partitions, and
    the union + histogram match the oracle."""
    from dsk_tpu.dist import engine as eng_mod
    from dsk_tpu.dist.spill import SpillCheckpoint

    got = {}
    calls = [0]

    def sink(pass_id, pid, kk, cc):
        calls[0] += 1
        if calls[0] == 3:
            raise _Boom()
        for row, c in zip(kk, cc):
            v = codec.words_to_value(row)
            assert v not in got  # no re-emits across the crash
            got[v] = int(c)

    ck = SpillCheckpoint(str(tmp_path / "sck"), "fp-test")
    with pytest.raises(_Boom):
        _spill_engine(1).count(URI, pass_sink=sink, spill_ckpt=ck)
    assert len(got) > 0  # some partitions landed before the crash

    # resume: a fresh engine + checkpoint with the same fingerprint.
    # batch_iterator must never be called (zero input re-reads).
    monkeypatch.setattr(
        eng_mod, "batch_iterator",
        lambda *a, **k: (_ for _ in ()).throw(
            AssertionError("input was re-read on resume")
        ),
    )
    ck2 = SpillCheckpoint(str(tmp_path / "sck"), "fp-test")

    def sink2(pass_id, pid, kk, cc):
        for row, c in zip(kk, cc):
            v = codec.words_to_value(row)
            assert v not in got
            got[v] = int(c)

    res = _spill_engine(1).count(URI, pass_sink=sink2, spill_ckpt=ck2)
    assert res.info["spill_resumed"] is True
    assert got == expect
    assert int(res.histogram[1:].sum()) == len(expect)
    # success cleans the checkpoint: a third run would start fresh
    import os as _os

    assert not _os.path.exists(ck2._fill_path(0))


def test_spill_midpass_resume_with_split(expect, tmp_path, monkeypatch):
    """Crash right AFTER a split's intent mark but BEFORE the files
    move: the resume redoes the (idempotent) split and nothing is lost
    or duplicated — the orphaned-child crash window."""
    from dsk_tpu.dist import engine as eng_mod
    from dsk_tpu.dist.spill import SpillCheckpoint, SpillStore

    ck = SpillCheckpoint(str(tmp_path / "sck"), "fp-split")
    orig_split = SpillStore.split

    def crashing_split(self, *a, **kw):
        raise _Boom()  # dies after the intent mark, before any file moves

    monkeypatch.setattr(SpillStore, "split", crashing_split)
    got = {}

    def sink(pass_id, pid, kk, cc):
        for row, c in zip(kk, cc):
            v = codec.words_to_value(row)
            assert v not in got
            got[v] = int(c)

    mk = lambda: _spill_engine(  # noqa: E731
        1, table_cap=1 << 13, spill_partitions=4,
        spill_chunk_rows=1 << 13,
    )
    with pytest.raises(_Boom):
        mk().count(URI, pass_sink=sink, spill_ckpt=ck)
    monkeypatch.setattr(SpillStore, "split", orig_split)
    monkeypatch.setattr(
        eng_mod, "batch_iterator",
        lambda *a, **k: (_ for _ in ()).throw(
            AssertionError("input was re-read on resume")
        ),
    )
    ck2 = SpillCheckpoint(str(tmp_path / "sck"), "fp-split")
    res = mk().count(URI, pass_sink=sink, spill_ckpt=ck2)
    assert res.info["spill_resumed"] is True
    assert res.info["spill_splits"] > 0
    assert got == expect


def test_execute_spill_midpass_resume(data_dir, tmp_path, monkeypatch):
    """CLI-level kill-mid-count + -resume: the store is truncated to the
    last durable mark, the fill is never re-streamed, and the final
    store/histogram match a clean run."""
    from dsk_tpu.dist.engine import DistCountEngine
    from dsk_tpu.store.output import OutputStore

    f = str(data_dir / "read50x_ref10K_e001.fasta.gz")
    common = dict(
        file=f, kmer_size=K, abundance_min=1, histo=True,
        out=str(tmp_path / "mr"), engine="dist",
        batch_rows=256, row_len=128, verbose=0,
        spill="on", spill_partitions=24,
    )
    orig_append = OutputStore.append_solid_partition
    n_appends = [0]

    def crashing(self, idx, kk, cc):
        n_appends[0] += 1
        if n_appends[0] == 10:  # past the first durable marks
            raise _Boom()
        return orig_append(self, idx, kk, cc)

    monkeypatch.setattr(OutputStore, "append_solid_partition", crashing)
    with pytest.raises(_Boom):
        execute(RunParams(**common))
    monkeypatch.setattr(OutputStore, "append_solid_partition", orig_append)
    import os as _os

    assert _os.path.isdir(str(tmp_path / "mr.spillckpt"))

    fills = [0]
    orig_fill = DistCountEngine._spill_stream

    def counting_fill(self, *a, **kw):
        fills[0] += 1
        return orig_fill(self, *a, **kw)

    monkeypatch.setattr(DistCountEngine, "_spill_stream", counting_fill)
    out = execute(RunParams(resume=True, **common))
    assert fills[0] == 0  # the input was NEVER re-streamed
    assert not _os.path.isdir(str(tmp_path / "mr.spillckpt"))
    with OutputStore.load(out.store_path) as st:
        items = {v: c for v, c in st.iter_items()}
    from dsk_tpu import oracle as _oracle

    assert items == _oracle.count_bank(f, K)
    from tests.conftest import load_histo_fixture

    got_h = load_histo_fixture(tmp_path / "mr.histo")
    want_h = {
        a: c
        for a, c in load_histo_fixture(
            data_dir / "k27.histo"
        ).items()
        if c
    }
    assert {a: c for a, c in got_h.items() if c} == want_h


def _pin_2pass_plan(run_mod):
    """Pin a 2-pass spill plan (the fixture is too small for the
    planner to choose either on its own).  Returns an undo closure."""
    from dsk_tpu.engine.planner import ResourcePlan

    plan = ResourcePlan(
        n_passes=2, table_cap=1 << 15, flush_items=1 << 18,
        buf_batches=8, batch_rows=512, row_len=128,
        est_bases=500_000, est_distinct=1 << 16,
        est_distinct_per_pass=1 << 15, spill=True, n_partitions=6,
    )
    orig = run_mod.plan_resources
    run_mod.plan_resources = lambda *a, **kw: plan
    return lambda: setattr(run_mod, "plan_resources", orig)


def _crash_on_emit(pass_id, at_call):
    """Patch _spill_emit_prepared to raise _Boom on the at_call-th emit
    of `pass_id`.  Returns (calls, undo)."""
    from dsk_tpu.dist.engine import DistCountEngine

    orig = DistCountEngine._spill_emit_prepared
    calls = [0]

    def crashing(self, p, pid, prep, *a):
        if p == pass_id:
            calls[0] += 1
            if calls[0] == at_call:
                raise _Boom()
        return orig(self, p, pid, prep, *a)

    DistCountEngine._spill_emit_prepared = crashing
    return calls, lambda: setattr(
        DistCountEngine, "_spill_emit_prepared", orig
    )


def _mp_params(out_prefix):
    return RunParams(
        file=URI, kmer_size=K, abundance_min=1, histo=True,
        out=out_prefix, engine="dist", verbose=0,
        batch_rows=512, row_len=128, spill="on",
    )


@pytest.fixture(scope="module")
def multipass_crashed(tmp_path_factory):
    """ONE crashed 2-pass spill run (pass 0 checkpointed, killed on
    pass 1's 3rd partition emit) shared by the resume tests — each
    consumer copies the artifacts into its own directory."""
    base = tmp_path_factory.mktemp("mpcrash")
    from dsk_tpu.engine import run as run_mod

    undo_plan = _pin_2pass_plan(run_mod)
    calls, undo_emit = _crash_on_emit(pass_id=1, at_call=3)
    try:
        with pytest.raises(_Boom):
            execute(_mp_params(str(base / "mp")))
    finally:
        undo_emit()
        undo_plan()
    assert calls[0] == 3  # the crash really hit mid-pass-1
    return base


def _copy_crashed(base, dest):
    import shutil

    dest.mkdir(exist_ok=True)
    for name in ("mp.dsk", "mp.ckpt", "mp.spillckpt"):
        shutil.copytree(base / name, dest / name)
    return str(dest / "mp")


def _assert_no_dup_oracle(store_path):
    from dsk_tpu.store.output import OutputStore

    with OutputStore.load(store_path) as st:
        items = {}
        for v, c in st.iter_items():
            assert v not in items  # a duplicate = the alignment bug
            items[v] = c
    assert items == oracle.count_bank(URI, K)


def test_execute_spill_multipass_midpass_resume(
    multipass_crashed, tmp_path, monkeypatch
):
    """Resume after a crash during pass 1's count: pass 0 comes from
    the pass checkpoint AND pass 1 resumes from its marks (the store
    alignment is gated on exactly this coverage), with zero fill
    re-streams and oracle parity."""
    from dsk_tpu.dist.engine import DistCountEngine
    from dsk_tpu.engine import run as run_mod

    prefix = _copy_crashed(multipass_crashed, tmp_path / "a")
    undo_plan = _pin_2pass_plan(run_mod)
    fills = [0]
    orig_fill = DistCountEngine._spill_stream

    def counting_fill(self, *a, **kw):
        fills[0] += 1
        return orig_fill(self, *a, **kw)

    monkeypatch.setattr(DistCountEngine, "_spill_stream", counting_fill)
    try:
        params = _mp_params(prefix)
        params.resume = True
        out = execute(params)
    finally:
        undo_plan()
    assert fills[0] == 0  # pass 0 from ckpt, pass 1's fill from disk
    _assert_no_dup_oracle(out.store_path)


def test_execute_spill_multipass_resume_without_pass_ckpt(
    multipass_crashed, tmp_path
):
    """Same crash, but the PASS checkpoint is gone before the resume:
    the mid-pass marks must NOT align the store (their sizes include
    pass 0's rows, which will be recounted) — the run falls back to a
    full recount with zero duplicates (review finding #1)."""
    import shutil

    from dsk_tpu.engine import run as run_mod

    prefix = _copy_crashed(multipass_crashed, tmp_path / "b")
    shutil.rmtree(prefix + ".ckpt")  # the pass checkpoint is lost
    undo_plan = _pin_2pass_plan(run_mod)
    try:
        params = _mp_params(prefix)
        params.resume = True
        out = execute(params)
    finally:
        undo_plan()
    _assert_no_dup_oracle(out.store_path)


def test_fill_only_resume_invalidated_by_split(
    tmp_path, monkeypatch, expect
):
    """Fill-only resume (collect mode / multi-process semantics): a
    count-phase split rewrites bucket files in place, so the fill
    manifest must die BEFORE the split — a crash right after the split
    must REFILL on resume, never skip over mutated buckets (whose
    children a fresh work list would silently drop)."""
    from dsk_tpu.dist import engine as eng_mod
    from dsk_tpu.dist.spill import SpillCheckpoint, SpillStore

    mk = lambda: _spill_engine(  # noqa: E731
        1, table_cap=1 << 13, spill_partitions=4,
        spill_chunk_rows=1 << 13,  # small cap: splits guaranteed
    )
    ck = SpillCheckpoint(str(tmp_path / "fo"), "fp-fo")
    orig_split = SpillStore.split

    def crash_after_split(self, *a, **kw):
        orig_split(self, *a, **kw)
        raise _Boom()  # worst case: the buckets are already mutated

    monkeypatch.setattr(SpillStore, "split", crash_after_split)
    with pytest.raises(_Boom):
        mk().count(URI, spill_ckpt=ck)  # no sink -> fill-only ckpt
    monkeypatch.setattr(SpillStore, "split", orig_split)
    assert ck.fill_done(0) is None  # invalidated BEFORE the split

    fills = [0]
    orig_fill = eng_mod.DistCountEngine._spill_stream

    def counting_fill(self, *a, **kw):
        fills[0] += 1
        return orig_fill(self, *a, **kw)

    monkeypatch.setattr(
        eng_mod.DistCountEngine, "_spill_stream", counting_fill
    )
    ck2 = SpillCheckpoint(str(tmp_path / "fo"), "fp-fo")
    res = mk().count(URI, spill_ckpt=ck2)
    assert fills[0] == 1  # REFILLED (stale mutated buckets discarded)
    assert res.info["spill_splits"] > 0
    assert _as_table(res) == expect


def test_execute_spill_per_bank_histo2d_midpass_resume(
    data_dir, tmp_path, monkeypatch
):
    """Per-bank spill (histo2D) killed mid-count, then -resume: the
    checkpoint restores the partial histo2D matrix along with the
    store, so the final .histo2D equals a clean run's byte-for-byte
    and the fill never re-streams."""
    from dsk_tpu.dist.engine import DistCountEngine
    from dsk_tpu.store.output import OutputStore

    files = _bank_files(data_dir, n=2)
    common = dict(
        file=files, kmer_size=K, abundance_min=1, histo=True,
        histo2d=True, solidity_kind="min", engine="dist", verbose=0,
        batch_rows=512, row_len=128, spill="on", spill_partitions=12,
    )
    out_clean = execute(
        RunParams(out=str(tmp_path / "clean"), **common)
    )
    calls, undo_emit = _crash_on_emit(pass_id=0, at_call=4)
    try:
        with pytest.raises(_Boom):
            execute(RunParams(out=str(tmp_path / "r"), **common))
    finally:
        undo_emit()

    fills = [0]
    orig_fill = DistCountEngine._spill_stream

    def counting_fill(self, *a, **kw):
        fills[0] += 1
        return orig_fill(self, *a, **kw)

    monkeypatch.setattr(DistCountEngine, "_spill_stream", counting_fill)
    out = execute(RunParams(resume=True, out=str(tmp_path / "r"), **common))
    assert fills[0] == 0
    for suffix in (".histo", ".histo2D"):
        assert (
            (tmp_path / ("r" + suffix)).read_bytes()
            == (tmp_path / ("clean" + suffix)).read_bytes()
        )
    with OutputStore.load(out.store_path) as sr, OutputStore.load(
        out_clean.store_path
    ) as sc:
        assert sorted(sr.iter_items()) == sorted(sc.iter_items())


def test_spill_multipass_resume(expect):
    """_count_spilled's done_passes path: a preloaded pass is skipped
    (its batches only tee the cache) and the merged result still equals
    the oracle — the crash-resume contract for spill runs."""
    eng = _spill_engine(1, n_passes=2)
    saved = {}
    full = eng.count(
        URI, n_passes=2, on_pass=lambda p, r: saved.setdefault(p, r)
    )
    assert _as_table(full) == expect
    eng2 = _spill_engine(1, n_passes=2)
    res = eng2.count(URI, n_passes=2, done_passes={0: saved[0]})
    assert _as_table(res) == expect
