"""Work-preserving overflow retry (VERDICT r2 weak #2).

count_stream snapshots the device tables at every passing periodic
overflow check (every 8 groups); when a later check raises, the retry
valve resumes from the snapshot instead of re-streaming from zero —
the reference never re-reads counted partitions (doc/paper.tex:71-76).
An overflow at 90% progress must cost <= ~10% re-work.

Depends on the deterministic batch order of the (parallel) reader
(io/batch.py): the resume skips exactly the batches the snapshot
already consumed.
"""

import numpy as np
import pytest

from dsk_tpu import oracle
from dsk_tpu.dist.engine import DistCountEngine, RoutingOverflow
from dsk_tpu.engine.run import RunParams, execute
from dsk_tpu.io.bank import open_bank
from dsk_tpu.io.batch import batch_iterator
from dsk_tpu.kmer import codec
from dsk_tpu.store.output import OutputStore


def _result_dict(res):
    return {
        codec.words_to_value(row): int(c)
        for row, c in zip(res.kmers, res.counts)
    }


def test_parallel_reader_deterministic_order(data_dir):
    """Skip-by-count resume is sound only if the parallel reader yields
    batches in a reproducible order for fixed params."""
    bank = open_bank(str(data_dir / "read50x_ref10K_e001.fasta.gz"))
    runs = []
    for _ in range(2):
        sig = []
        for b in batch_iterator(bank, 27, 64, 128, n_workers=4):
            sig.append(
                (b.n_rows, b.n_bases, int(b.codes.sum(dtype=np.int64)))
            )
        runs.append(sig)
    assert runs[0] == runs[1]


def test_count_stream_snapshot_resume_equivalence(data_dir):
    """Inject a RoutingOverflow at the final check: the snapshot from the
    group-8 periodic check + a resumed stream over the remaining batches
    must reproduce the uninterrupted result exactly."""
    uri = str(data_dir / "read50x_ref10K_e001.fasta.gz")
    bank = open_bank(uri)
    k, rows, row_len = 27, 32, 128
    batches = list(batch_iterator(bank, k, rows, row_len))
    assert len(batches) > 8 * 8  # at least one periodic check fires

    def make():
        return DistCountEngine(
            k, batch_rows=rows, row_len=row_len, table_cap=1 << 17,
            buf_batches=8,
        )

    full = make().count_stream(iter(batches))
    expect = _result_dict(full)
    assert expect == oracle.count_bank(uri, k)

    eng = make()
    orig = DistCountEngine._check_overflow
    calls = []

    def failing(self, over, tover):
        orig(self, over, tover)
        calls.append(1)
        if len(calls) == 2:  # after the group-8 snapshot exists
            raise RoutingOverflow("injected")

    DistCountEngine._check_overflow = failing
    try:
        with pytest.raises(RoutingOverflow):
            eng.count_stream(iter(batches))
    finally:
        DistCountEngine._check_overflow = orig
    snap = eng._retry_snapshot
    assert snap is not None and snap["groups"] == 8

    eng2 = make()
    res = eng2.count_stream(iter(batches[8 * 8:]), resume_state=snap)
    assert _result_dict(res) == expect
    assert res.info["resumed_groups"] == 8
    assert res.info["n_bases"] == full.info["n_bases"]
    assert res.info["n_reads"] == full.info["n_reads"]
    assert (res.histogram == full.histogram).all()


def test_execute_routing_overflow_resumes(data_dir, tmp_path, monkeypatch):
    """End-to-end valve: a late injected RoutingOverflow retries with
    doubled send_slack AND a resume_state snapshot (not a restart), and
    the final store still matches the oracle."""
    uri = str(data_dir / "read50x_ref10K_e001.fasta.gz")

    import dsk_tpu.engine.run as runmod

    origp = runmod.plan_resources

    def plan(*a, **kw):
        p = origp(*a, **kw)
        p.buf_batches = 8  # small groups: periodic checks fire
        return p

    monkeypatch.setattr(runmod, "plan_resources", plan)

    orig_check = DistCountEngine._check_overflow
    state = {"checks": 0, "failed": False}

    def check(self, over, tover):
        orig_check(self, over, tover)
        if not state["failed"]:
            state["checks"] += 1
            if state["checks"] == 2:
                state["failed"] = True
                raise RoutingOverflow("injected skew")

    monkeypatch.setattr(DistCountEngine, "_check_overflow", check)

    seen = []
    orig_count = DistCountEngine.count

    def counting(self, bank, **kw):
        seen.append(kw.get("resume_state"))
        return orig_count(self, bank, **kw)

    monkeypatch.setattr(DistCountEngine, "count", counting)

    out = execute(RunParams(
        file=uri, kmer_size=27, abundance_min=1,
        out=str(tmp_path / "rr"), verbose=0, batch_rows=32, row_len=128,
    ))
    assert state["failed"]
    assert len(seen) == 2
    assert seen[0] is None
    assert seen[1] is not None and seen[1]["groups"] >= 8

    expect = oracle.count_bank(uri, 27)
    got = {}
    with OutputStore.load(out.store_path) as store:
        for v, a in store.iter_items():
            got[v] = got.get(v, 0) + a
    assert got == expect
    assert out.n_solid == len(expect)


def test_execute_wire_overflow_resumes(tmp_path, monkeypatch):
    """A LATE N-dense read (single chunk with > EXC_E internal N's, the
    one case the batcher event cap cannot absorb) must ride the
    WireOverflow -> bitmap valve WITH a snapshot resume, not a restart,
    and the final counts must match the oracle."""
    from collections import defaultdict

    import dsk_tpu.engine.run as runmod

    # 3000 clean 100bp reads, then the poisoned read, then a tail:
    # with batch_rows=32 / row_len=128 / G=8 the poison lands ~group 12,
    # past the group-8 snapshot
    rng = np.random.default_rng(5)
    acgt = "ACGT"
    reads = [
        "".join(acgt[c] for c in rng.integers(0, 4, 100))
        for _ in range(3000)
    ]
    poison = "ACGTACGTACGTACGTACGT" + "NA" * 20 + "CCGTACGTACGTACGT"
    reads.append(poison)
    reads += [
        "".join(acgt[c] for c in rng.integers(0, 4, 100))
        for _ in range(100)
    ]
    fa = tmp_path / "late_ndense.fasta"
    with open(fa, "w") as fh:
        for i, r in enumerate(reads):
            fh.write(f">r{i}\n{r}\n")

    origp = runmod.plan_resources

    def plan(*a, **kw):
        p = origp(*a, **kw)
        p.buf_batches = 8  # small groups: the periodic snapshot fires
        return p

    monkeypatch.setattr(runmod, "plan_resources", plan)
    # one put stream: the prefetch pipeline packs at most ~2 groups
    # ahead of the dispatch loop, so the pack-side raise happens after
    # the group-8 snapshot was taken
    monkeypatch.setenv("DSK_TPU_PUT_STREAMS", "1")

    wires, snaps = [], []
    orig_sel = runmod._select_engine

    def sel(*a, **kw):
        wires.append(kw.get("wire"))
        return orig_sel(*a, **kw)

    monkeypatch.setattr(runmod, "_select_engine", sel)
    orig_count = DistCountEngine.count

    def counting(self, bank, **kw):
        snaps.append(kw.get("resume_state"))
        return orig_count(self, bank, **kw)

    monkeypatch.setattr(DistCountEngine, "count", counting)

    out = execute(RunParams(
        file=str(fa), kmer_size=27, abundance_min=1,
        out=str(tmp_path / "wo"), verbose=0,
        batch_rows=32, row_len=128, checkpoint=False,
    ))
    assert wires == [None, "bitmap"]
    assert snaps[0] is None
    assert snaps[1] is not None and snaps[1]["groups"] >= 8  # resumed

    want: dict[int, int] = defaultdict(int)
    for r in reads:
        oracle.count_sequence(want, r.encode(), 27)
    got = {}
    with OutputStore.load(out.store_path) as store:
        for v, a in store.iter_items():
            got[v] = got.get(v, 0) + a
    assert got == dict(want)
