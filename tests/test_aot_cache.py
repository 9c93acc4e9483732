"""AOT compile + persistent-cache contract.

engine.compile() AOT-lowers location-free and lets jax's persistent
compilation cache serve warm starts.  These tests pin that contract on
the CPU backend: compile() swaps wrappers for executables, counts stay
oracle-exact through them, repeated compiles work, and the cache
directory follows the environment: JAX_COMPILATION_CACHE_DIR when set,
else one fixed path inside the checkout; DSK_TPU_AOT_CACHE=0 disables.
"""

import os

import jax
import pytest

import dsk_tpu
from dsk_tpu import oracle
from dsk_tpu.dist.engine import (
    CHECKOUT_CACHE_DIR,
    DistCountEngine,
    _enable_persistent_cache,
    default_mesh,
    persistent_cache_dir,
)
from dsk_tpu.kmer import codec


def _engine(mesh_n):
    return DistCountEngine(
        27,
        mesh=default_mesh(mesh_n),
        batch_rows=16,
        row_len=64,
        table_cap=1 << 12,
    )


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_cold_then_warm_single_chip(tmp_path, data_dir, monkeypatch,
                                    restore_cache_dir):
    uri = str(data_dir / "readN.fasta")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "xla"))

    cold = []
    e1 = _engine(1)
    e1.compile(progress=cold.append)
    res1 = e1.count(uri)

    warm = []
    e2 = _engine(1)
    e2.compile(progress=warm.append)
    res2 = e2.count(uri)

    # all three programs (step, hist, live) AOT-compiled both times; the
    # persistent cache (not a bespoke executable store) makes run 2 warm
    assert len(cold) == 3 and len(warm) == 3
    assert all(m.startswith("compiled") for m in cold + warm), (cold, warm)

    expected = oracle.count_bank(uri, 27)
    for res in (res1, res2):
        got = {
            codec.words_to_value(row): int(a)
            for row, a in zip(res.kmers, res.counts)
        }
        assert got == expected


def test_multichip_engine_gathers_after_compile(tmp_path, data_dir,
                                                monkeypatch,
                                                restore_cache_dir):
    """Compiled helpers are built from sharding-free avals, so the
    multi-chip gather must NOT route through them (regression: the AOT'd
    chunker rejected 8-chip NamedSharding tables)."""
    uri = str(data_dir / "readN.fasta")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "xla"))

    msgs = []
    eng = _engine(8)
    eng.compile(progress=msgs.append)
    # multi-chip compiles only step+hist; the live program stays a jit
    # wrapper (AOT avals carry no sharding)
    assert len(msgs) == 2
    res = eng.count(uri)

    expected = oracle.count_bank(uri, 27)
    got = {
        codec.words_to_value(row): int(a)
        for row, a in zip(res.kmers, res.counts)
    }
    assert got == expected


def test_persistent_cache_respects_user_config(tmp_path, monkeypatch,
                                               restore_cache_dir):
    """JAX_COMPILATION_CACHE_DIR, when set, is the cache directory."""
    mine = str(tmp_path / "mine")
    monkeypatch.delenv("DSK_TPU_AOT_CACHE", raising=False)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", mine)
    assert persistent_cache_dir() == mine
    _enable_persistent_cache()
    assert jax.config.jax_compilation_cache_dir == mine
    assert os.path.isdir(mine)


def test_persistent_cache_unset_goes_to_checkout(monkeypatch,
                                                 restore_cache_dir):
    """Unset: one fixed path inside the checkout (listed in .gitignore)."""
    monkeypatch.delenv("DSK_TPU_AOT_CACHE", raising=False)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(dsk_tpu.__file__)))
    assert CHECKOUT_CACHE_DIR == os.path.join(root, ".jax_cache")
    assert persistent_cache_dir() == CHECKOUT_CACHE_DIR
    _enable_persistent_cache()
    assert jax.config.jax_compilation_cache_dir == CHECKOUT_CACHE_DIR
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_persistent_cache_disabled_by_env(tmp_path, monkeypatch,
                                          restore_cache_dir):
    """DSK_TPU_AOT_CACHE=0 disables: no directory is set or created."""
    monkeypatch.setenv("DSK_TPU_AOT_CACHE", "0")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "x"))
    before = jax.config.jax_compilation_cache_dir
    assert persistent_cache_dir() is None
    _enable_persistent_cache()
    assert jax.config.jax_compilation_cache_dir == before
    assert not (tmp_path / "x").exists()
