"""CPU tests of chip_smoke.py's host pieces (read generator, FASTQ.gz
writer, numpy oracle) and of its refusal to run without a GPU.  The
device phases themselves run on the card (`python chip_smoke.py`)."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs
from dsk_tpu import oracle
from dsk_tpu.io.bank import open_bank
from dsk_tpu.kmer import codec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_make_reads_is_seeded_and_shaped():
    a = cs.make_reads(500, 10_000, 0.005, seed=3)
    b = cs.make_reads(500, 10_000, 0.005, seed=3)
    c = cs.make_reads(500, 10_000, 0.005, seed=4)
    assert a.shape == (500, cs.READ_LEN) and a.dtype == np.uint8
    assert a.max() <= 3
    assert np.array_equal(a, b) and not np.array_equal(a, c)


def test_make_reads_substitution_rate_and_strands():
    clean = cs.make_reads(2000, 50_000, 0.0, seed=1)
    noisy = cs.make_reads(2000, 50_000, 0.02, seed=1)
    # same draws but substitutions: ~2% of bases differ, never equal
    # after a substitution (sub = +1..3 mod 4)
    frac = float((clean != noisy).mean())
    assert 0.015 < frac < 0.025
    # reads come from both strands: a reverse-complemented copy of a
    # genome window is counted as the same canonical k-mers
    kk, cc = cs.oracle_counts(clean, 27)
    assert int(cc.sum()) == clean.shape[0] * (cs.READ_LEN - 27 + 1)


def test_fastq_gz_round_trips_through_the_bank_reader(tmp_path):
    reads = cs.make_reads(3000, 20_000, 0.005, seed=7)
    path = str(tmp_path / "r.fastq.gz")
    cs.write_fastq_gz(path, reads, threads=2)
    seqs = [s.data for _b, s in open_bank(path).iter_sequences()]
    assert len(seqs) == reads.shape[0]
    got = np.stack([codec.encode_bytes(s) for s in seqs])
    assert np.array_equal(got, reads)


def test_numpy_oracle_matches_dsk_oracle_on_readN(data_dir):
    """readN splits at N: rows padded with invalid codes (4)."""
    path = str(data_dir / "readN.fasta")
    seqs = [codec.encode_bytes(s.data) for _b, s in open_bank(path).iter_sequences()]
    rows = np.full((len(seqs), max(map(len, seqs))), 4, np.uint8)
    for i, s in enumerate(seqs):
        rows[i, : len(s)] = s
    assert (rows > 3).any()
    kk, cc = cs.oracle_counts(rows, 20)
    want = oracle.count_bank(path, 20)
    assert dict(zip(kk.tolist(), cc.tolist())) == want


def test_numpy_oracle_matches_dsk_oracle_on_fastq(tmp_path):
    reads = cs.make_reads(400, 5_000, 0.01, seed=9)
    path = str(tmp_path / "r.fastq.gz")
    cs.write_fastq_gz(path, reads, threads=1)
    kk, cc = cs.oracle_counts(reads, 27)
    assert dict(zip(kk.tolist(), cc.tolist())) == oracle.count_bank(path, 27)
    hist = cs.oracle_histogram(cc)
    assert hist.shape == (cs.HISTO_MAX + 1,)
    assert int((np.arange(hist.shape[0]) * hist).sum()) == int(cc.sum())


def _run(args, cwd, env_extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra)
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def _has_result_line(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if "ok" in json.loads(line):
                return True
        except (ValueError, TypeError):
            continue
    return False


def test_chip_smoke_fails_without_a_gpu():
    r = _run([os.path.join(ROOT, "chip_smoke.py")], ROOT,
             {"JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert not _has_result_line(r.stdout)
    assert "not gpu" in r.stderr


def test_chip_smoke_fails_alone(tmp_path):
    """Copied without the rest of the repo, the script stops at its import
    of the program, before it looks for a device."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], str(tmp_path), {})
    assert r.returncode != 0
    assert not _has_result_line(r.stdout)
    assert "No module named 'dsk_tpu'" in r.stderr
    assert "not gpu" not in r.stderr


@pytest.mark.chip
def test_extraction_parity_on_the_card(gpu):
    """The card's extraction at real width vs the host oracle."""
    cs.phase_extraction(ks=(27, 31, 63))
