"""Per-pass checkpoint/resume of multi-pass runs."""

import os

import numpy as np
import pytest

from dsk_tpu import oracle
from dsk_tpu.engine.checkpoint import PassCheckpoint
from dsk_tpu.engine.counter import CountEngine
from dsk_tpu.engine.run import RunParams, execute
from dsk_tpu.kmer import codec


class _Abort(Exception):
    pass


def result_as_dict(res):
    return {codec.words_to_value(r): int(a) for r, a in zip(res.kmers, res.counts)}


def test_checkpoint_roundtrip(data_dir, tmp_path):
    uri = str(data_dir / "readN.fasta")
    params = RunParams(file=uri, kmer_size=20, batch_rows=8, row_len=64)
    eng = CountEngine(20, batch_rows=8, row_len=64)
    saved = {}
    full = eng.count(
        uri, n_passes=3, on_pass=lambda p, r: saved.setdefault(p, r)
    )
    ck = PassCheckpoint(str(tmp_path / "c.ckpt"), params, 3)
    for p, r in saved.items():
        ck.save_pass(p, r)
    loaded = ck.load()
    assert sorted(loaded) == [0, 1, 2]
    for p in loaded:
        np.testing.assert_array_equal(loaded[p].kmers, saved[p].kmers)
        np.testing.assert_array_equal(loaded[p].counts, saved[p].counts)
        np.testing.assert_array_equal(loaded[p].histogram, saved[p].histogram)
    # resumed count with all passes preloaded must equal the full result
    resumed = eng.count(uri, n_passes=3, done_passes=loaded)
    assert result_as_dict(resumed) == result_as_dict(full)
    # fingerprint mismatch discards the checkpoint
    params2 = RunParams(file=uri, kmer_size=21, batch_rows=8, row_len=64)
    ck2 = PassCheckpoint(str(tmp_path / "c.ckpt"), params2, 3)
    assert ck2.load() == {}


def test_resume_after_crash(data_dir, tmp_path):
    # abort after the first completed pass, then resume: final output must
    # match and only the remaining passes are recounted
    uri = str(data_dir / "readN.fasta")
    params = RunParams(
        file=uri, kmer_size=20, batch_rows=8, row_len=64,
        out=str(tmp_path / "r"),
    )
    eng = CountEngine(20, batch_rows=8, row_len=64)
    ck = PassCheckpoint(params.out_prefix() + ".ckpt", params, 3)

    def crash_after_first(p, r):
        ck.save_pass(p, r)
        if p == 0:
            raise _Abort()

    with pytest.raises(_Abort):
        eng.count(uri, n_passes=3, on_pass=crash_after_first)
    assert os.path.exists(ck.path)

    done = ck.load()
    assert sorted(done) == [0]
    recounted = []
    res = eng.count(
        uri, n_passes=3, done_passes=done,
        on_pass=lambda p, r: recounted.append(p),
    )
    assert recounted == [1, 2]
    assert result_as_dict(res) == oracle.count_bank(uri, 20)


def test_execute_resume_end_to_end(data_dir, tmp_path):
    # forced multipass via tiny memory; second run resumes from checkpoint
    uri = str(data_dir / "read50x_ref10K_e001.fasta.gz")
    params = RunParams(
        file=uri, kmer_size=27, abundance_min=1, max_memory=1,
        out=str(tmp_path / "mp"), verbose=0,
        batch_rows=512, row_len=128, resume=True,
    )
    out = execute(params)
    assert out.n_solid == 93948
    # checkpoint removed on success
    assert not os.path.exists(params.out_prefix() + ".ckpt")
