"""Full multi-host counting loop on a 2-process CPU mesh.

VERDICT r1 acceptance: a 2-process run (jax.distributed local) reproduces
k27.histo from a SINGLE input file, sharded by byte ranges.  CPU-mesh
simulation per SURVEY.md §4.5 (2 virtual devices per process -> a global
4-chip mesh spanning two processes).
"""

import gzip
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from tests.conftest import load_histo_fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def plain_fixture(tmp_path_factory, ):
    """Uncompressed copy of the k27 fixture (plain files are the ones that
    byte-range-shard; gz members have no random access)."""
    data = os.path.join(REPO, "tests", "data", "read50x_ref10K_e001.fasta.gz")
    out = tmp_path_factory.mktemp("mh") / "read50x.fasta"
    with gzip.open(data, "rb") as f, open(out, "wb") as g:
        g.write(f.read())
    return str(out)


@pytest.mark.slow
def test_two_process_single_file(plain_fixture, tmp_path, data_dir):
    port = _free_port()
    out = str(tmp_path / "mh")
    env = dict(os.environ)
    env.update(
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=2",
        PYTHONPATH=REPO,
    )
    procs = []
    for pid in (0, 1):
        procs.append(
            subprocess.Popen(
                [
                    sys.executable,
                    os.path.join(REPO, "scripts", "multihost_count.py"),
                    "-coordinator", f"localhost:{port}",
                    "-num-processes", "2",
                    "-process-id", str(pid),
                    "-file", plain_fixture,
                    "-kmer-size", "27",
                    "-abundance-min", "1",
                    "-out", out,
                    "-batch-rows", "256",
                    "-row-len", "128",
                    "-table-cap", str(1 << 16),
                ],
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
                cwd=REPO,
            )
        )
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-3000:]

    # the global histogram must be byte-exact vs the reference fixture
    got = {}
    with open(out + ".histo") as f:
        for line in f:
            a, c = line.split()
            got[int(a)] = int(c)
    want = load_histo_fixture(data_dir / "k27.histo")
    assert got == want

    # and the merged partitions must hold the oracle's exact counts
    from dsk_tpu.oracle import count_bank
    from dsk_tpu.kmer import codec

    oracle = count_bank(plain_fixture, 27)
    total = 0
    parts = [np.load(f"{out}.part{i}.npz") for i in (0, 1)]
    seen = {}
    for p in parts:
        for row, c in zip(p["kmers"], p["counts"]):
            v = codec.words_to_value(row)
            assert v not in seen  # partitions are disjoint in kmer space
            seen[v] = int(c)
            total += 1
    assert total == len(oracle)
    assert seen == {v: c for v, c in oracle.items()}


def _launch(pid, port, nproc, out, plain_fixture, extra=(), env_extra=()):
    env = dict(os.environ)
    env.update(
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=2",
        PYTHONPATH=REPO,
    )
    env.update(dict(env_extra))
    return subprocess.Popen(
        [
            sys.executable,
            os.path.join(REPO, "scripts", "multihost_count.py"),
            "-coordinator", f"localhost:{port}",
            "-num-processes", str(nproc),
            "-process-id", str(pid),
            "-file", plain_fixture,
            "-kmer-size", "27",
            "-abundance-min", "1",
            "-out", out,
            "-batch-rows", "256",
            "-row-len", "128",
            "-table-cap", str(1 << 16),
            *extra,
        ],
        env=env,
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        cwd=REPO,
    )


@pytest.mark.slow
def test_four_process_skewed_shards(plain_fixture, tmp_path, data_dir):
    """4 processes x 2 virtual chips = an 8-chip mesh spanning four
    processes (VERDICT r3 next-item 7b).  Byte-range resync makes the
    shards uneven, so processes exhaust at different rounds and the
    lockstep padding path is genuinely exercised; the global histogram
    must still be byte-exact."""
    port = _free_port()
    out = str(tmp_path / "mh4")
    procs = [
        _launch(pid, port, 4, out, plain_fixture) for pid in range(4)
    ]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (_so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-3000:]
    got = {}
    with open(out + ".histo") as f:
        for line in f:
            a, c = line.split()
            got[int(a)] = int(c)
    assert got == load_histo_fixture(data_dir / "k27.histo")


@pytest.mark.slow
def test_peer_death_errors_out_not_hang(plain_fixture, tmp_path):
    """Failure injection (VERDICT r3 next-item 7a): process 1 hard-kills
    itself after 2 flush groups; process 0 must TERMINATE (nonzero exit
    or coordination-service error) within the barrier timeout instead of
    hanging in the lockstep."""
    port = _free_port()
    out = str(tmp_path / "mhfail")
    env_extra = (("DSK_TPU_LOCKSTEP_TIMEOUT_MS", "20000"),)
    p0 = _launch(0, port, 2, out, plain_fixture, env_extra=env_extra)
    p1 = _launch(
        1, port, 2, out, plain_fixture,
        extra=("-selfdestruct-after-groups", "2"),
        env_extra=env_extra,
    )
    try:
        so1, se1 = p1.communicate(timeout=300)
        assert p1.returncode == 13, se1.decode()[-2000:]
        # the survivor must die on its own well before the test timeout:
        # barrier timeout (20 s) + slack for heartbeat detection
        so0, se0 = p0.communicate(timeout=180)
    finally:
        for p in (p0, p1):
            if p.poll() is None:
                p.kill()
    assert p0.returncode != 0, (
        "survivor exited 0 despite a dead peer: "
        + se0.decode()[-2000:]
    )


@pytest.mark.slow
def test_eight_process_lockstep(plain_fixture, tmp_path, data_dir):
    """8 processes x 1 virtual chip each (VERDICT r3 next-item 7b):
    the widest CPU-mesh lockstep this suite runs.  Shards are 1/8th of
    the file with resync-induced skew; global histogram byte-exact."""
    port = _free_port()
    out = str(tmp_path / "mh8")
    env_extra = (("XLA_FLAGS", "--xla_force_host_platform_device_count=1"),)
    procs = [
        _launch(pid, port, 8, out, plain_fixture, env_extra=env_extra)
        for pid in range(8)
    ]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (_so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-3000:]
    got = {}
    with open(out + ".histo") as f:
        for line in f:
            a, c = line.split()
            got[int(a)] = int(c)
    assert got == load_histo_fixture(data_dir / "k27.histo")


@pytest.mark.slow
def test_sixteen_process_lockstep_spill(plain_fixture, tmp_path, data_dir):
    """16 processes x 1 virtual chip (VERDICT r4 next-item 7): the
    widest CPU-mesh run — lockstep streaming + shared-dir SPILL with a
    table cap small enough to force at least one partition split.
    Skewed byte-range shards exercise the padding path; the global
    histogram must stay byte-exact and partition ownership disjoint."""
    port = _free_port()
    out = str(tmp_path / "mh16")
    env_extra = (
        ("XLA_FLAGS", "--xla_force_host_platform_device_count=1"),
        ("DSK_TPU_LOCKSTEP_TIMEOUT_MS", "120000"),
    )
    procs = [
        _launch(pid, port, 16, out, plain_fixture,
                extra=("-spill-partitions", "8",
                       "-table-cap", str(1 << 13)),
                env_extra=env_extra)
        for pid in range(16)
    ]
    outs = [p.communicate(timeout=900) for p in procs]
    for p, (_so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-3000:]
    got = {}
    with open(out + ".histo") as f:
        for line in f:
            a, c = line.split()
            got[int(a)] = int(c)
    assert got == load_histo_fixture(data_dir / "k27.histo")
    from dsk_tpu.kmer import codec
    from dsk_tpu.oracle import count_bank

    oracle = count_bank(plain_fixture, 27)
    seen = {}
    all_ids = []
    for i in range(16):
        part = np.load(f"{out}.part{i}.npz")
        all_ids.extend(int(x) for x in part["partition_ids"])
        for row, c in zip(part["kmers"], part["counts"]):
            v = codec.words_to_value(row)
            assert v not in seen
            seen[v] = int(c)
    assert len(all_ids) == len(set(all_ids))  # split ids globally unique
    assert max(all_ids) >= 8  # at least one split actually happened
    assert seen == {v: c for v, c in oracle.items()}


@pytest.mark.slow
def test_two_process_spill(plain_fixture, tmp_path, data_dir):
    """Multi-process SPILL: per-host bucket files in a shared dir (the
    reference's filesystem-as-interconnect stretched across hosts),
    host-local count of owned partitions, allgather'd histogram —
    byte-exact vs k27.histo and the per-host partitions union the
    oracle."""
    port = _free_port()
    out = str(tmp_path / "mhsp")
    procs = [
        _launch(pid, port, 2, out, plain_fixture,
                extra=("-spill-partitions", "8"))
        for pid in (0, 1)
    ]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (_so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-3000:]
    got = {}
    with open(out + ".histo") as f:
        for line in f:
            a, c = line.split()
            got[int(a)] = int(c)
    assert got == load_histo_fixture(data_dir / "k27.histo")

    from dsk_tpu.kmer import codec
    from dsk_tpu.oracle import count_bank

    oracle = count_bank(plain_fixture, 27)
    seen = {}
    for i in (0, 1):
        part = np.load(f"{out}.part{i}.npz")
        for row, c in zip(part["kmers"], part["counts"]):
            v = codec.words_to_value(row)
            assert v not in seen  # partition ownership is disjoint
            seen[v] = int(c)
    assert seen == {v: c for v, c in oracle.items()}


@pytest.mark.slow
def test_two_process_spill_chip_parallel(plain_fixture, tmp_path, data_dir):
    """Chip-parallel multi-process spill count (VERDICT r4 weak #2):
    with 4 local chips per process and 8+ owned partitions, MULTIPLE
    local chips must receive merge work (the count phase no longer
    serializes on each host's first chip), with oracle parity."""
    port = _free_port()
    out = str(tmp_path / "mhcp")
    procs = [
        _launch(pid, port, 2, out, plain_fixture,
                extra=("-spill-partitions", "16"),
                env_extra=(("XLA_FLAGS",
                            "--xla_force_host_platform_device_count=4"),))
        for pid in (0, 1)
    ]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (_so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-3000:]
    got = {}
    with open(out + ".histo") as f:
        for line in f:
            a, c = line.split()
            got[int(a)] = int(c)
    assert got == load_histo_fixture(data_dir / "k27.histo")

    from dsk_tpu.kmer import codec
    from dsk_tpu.oracle import count_bank

    oracle = count_bank(plain_fixture, 27)
    seen = {}
    for i in (0, 1):
        part = np.load(f"{out}.part{i}.npz")
        # each host owns 8 of the 16 partitions: all 4 local chips must
        # have merged at least one (the parallelism actually engaged)
        assert int(part["spill_count_devices"]) >= 2
        off = 0
        for gid, sz in zip(part["partition_ids"], part["sizes"]):
            for row, c in zip(
                part["kmers"][off : off + sz],
                part["counts"][off : off + sz],
            ):
                v = codec.words_to_value(row)
                assert v not in seen
                seen[v] = int(c)
            off += sz
    assert seen == {v: c for v, c in oracle.items()}


@pytest.mark.slow
def test_two_process_per_bank_spill(plain_fixture, tmp_path, data_dir):
    """Per-bank SPILL across processes (round 5): two plain banks
    byte-range-sharded over 2 hosts; every host's owned partitions
    arrive grouped per kmer with a bank matrix; the union reproduces
    the per-bank oracle exactly (bank ids survive sharding + spill +
    split-free count)."""
    import shutil

    b2 = str(tmp_path / "bank2.fasta")
    shutil.copy(plain_fixture, b2)
    files = f"{plain_fixture},{b2}"
    port = _free_port()
    out = str(tmp_path / "mhpb")
    procs = [
        _launch(pid, port, 2, out, files,
                extra=("-spill-partitions", "8", "-per-bank"))
        for pid in (0, 1)
    ]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (_so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-3000:]

    from dsk_tpu.kmer import codec
    from dsk_tpu.oracle import count_bank_per_bank

    want = {
        v: tuple(int(x) for x in vec)
        for v, vec in count_bank_per_bank(files, 27).items()
    }
    seen = {}
    for i in (0, 1):
        part = np.load(f"{out}.part{i}.npz")
        assert part["banks"].shape[1] == 2
        np.testing.assert_array_equal(
            part["banks"].sum(axis=1), part["counts"]
        )
        for row, vec in zip(part["kmers"], part["banks"]):
            v = codec.words_to_value(row)
            assert v not in seen  # ownership disjoint, grouping complete
            seen[v] = tuple(int(x) for x in vec)
    assert seen == want
    # identical banks: the per-bank vector must be symmetric
    assert all(a == b for a, b in seen.values())

    # the cross-host histo2D (allgather-summed per-host folds) must be
    # byte-identical to a single-process -histo2D run over the same
    # comma list (BASELINE config 5: joint spectrum across 2 hosts)
    from dsk_tpu.engine.run import RunParams, execute

    execute(RunParams(
        file=files, kmer_size=27, abundance_min=1, histo2d=True,
        out=str(tmp_path / "sp1"), verbose=0,
        batch_rows=256, row_len=128, engine="dist",
    ))
    assert (
        open(out + ".histo2D").read()
        == open(str(tmp_path / "sp1") + ".histo2D").read()
    )


@pytest.mark.slow
def test_two_process_spill_fill_resume(plain_fixture, tmp_path, data_dir):
    """Multi-process spill FILL-resume (round 5): both processes die
    right after their fill completes (shared-dir manifests durable);
    the re-run must skip every host's input stream (fill_resumed on
    both), count from the durable bucket files, and land byte-exact."""
    out = str(tmp_path / "mhfr")

    def launch_all(extra):
        port = _free_port()
        return [
            _launch(pid, port, 2, out, plain_fixture,
                    extra=("-spill-partitions", "8", *extra))
            for pid in (0, 1)
        ]

    procs = launch_all(("-selfdestruct-after-fill",))
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (_so, se) in zip(procs, outs):
        assert p.returncode == 13, se.decode()[-2000:]
    import os as _os

    ck = tmp_path / "mhfr.spillckpt"
    assert _os.path.isdir(ck)
    manifests = [f for f in _os.listdir(ck) if f.startswith("fill_p0")]
    assert len(manifests) == 2  # one per host, all durable

    procs = launch_all(())
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (_so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-3000:]
    assert not _os.path.isdir(ck)  # success cleans the shared ckpt

    got = {}
    with open(out + ".histo") as f:
        for line in f:
            a, c = line.split()
            got[int(a)] = int(c)
    assert got == load_histo_fixture(data_dir / "k27.histo")

    from dsk_tpu.kmer import codec
    from dsk_tpu.oracle import count_bank

    oracle = count_bank(plain_fixture, 27)
    seen = {}
    for i in (0, 1):
        part = np.load(f"{out}.part{i}.npz")
        assert int(part["fill_resumed"]) == 1  # input never re-streamed
        for row, c in zip(part["kmers"], part["counts"]):
            v = codec.words_to_value(row)
            assert v not in seen
            seen[v] = int(c)
    assert seen == {v: c for v, c in oracle.items()}


@pytest.mark.slow
def test_four_process_spill_with_split(plain_fixture, tmp_path, data_dir):
    """4-process spill with a table cap small enough to force partition
    SPLITS on some host: rank-strided split ids stay globally unique,
    ownership stays disjoint, histogram byte-exact."""
    port = _free_port()
    out = str(tmp_path / "mh4sp")
    procs = [
        _launch(pid, port, 4, out, plain_fixture,
                extra=("-spill-partitions", "4",
                       "-table-cap", str(1 << 13)))
        for pid in range(4)
    ]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (_so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-3000:]
    got = {}
    with open(out + ".histo") as f:
        for line in f:
            a, c = line.split()
            got[int(a)] = int(c)
    assert got == load_histo_fixture(data_dir / "k27.histo")
    from dsk_tpu.kmer import codec
    from dsk_tpu.oracle import count_bank

    oracle = count_bank(plain_fixture, 27)
    seen = {}
    all_ids = []
    for i in range(4):
        part = np.load(f"{out}.part{i}.npz")
        all_ids.extend(int(x) for x in part["partition_ids"])
        for row, c in zip(part["kmers"], part["counts"]):
            v = codec.words_to_value(row)
            assert v not in seen
            seen[v] = int(c)
    assert len(all_ids) == len(set(all_ids))  # split ids globally unique
    assert max(all_ids) >= 4  # at least one split actually happened
    assert seen == {v: c for v, c in oracle.items()}


def test_initialize_passes_local_device_ids(monkeypatch):
    """One card per process on a GPU host: local_device_ids reaches
    jax.distributed.initialize; with no coordinator nothing is called."""
    import jax

    from dsk_tpu.dist import multihost

    calls = []
    monkeypatch.setattr(
        jax.distributed, "initialize", lambda **kw: calls.append(kw)
    )
    multihost.initialize()
    assert calls == []
    multihost.initialize("localhost:1234", 4, 2, local_device_ids=[2])
    assert calls == [{
        "coordinator_address": "localhost:1234", "num_processes": 4,
        "process_id": 2, "local_device_ids": [2],
    }]
