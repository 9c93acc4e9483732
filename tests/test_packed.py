"""Packed host->device wire format (io/packed.py): roundtrip exactness
and engine integration.  The reference packs its disk partitions to
2 bits/base (doc/paper.tex:104); here the pack/unpack pair guards the
device ingest boundary, so any bit-layout drift must break these tests."""

import numpy as np
import pytest

from dsk_tpu.io.batch import PAD
from dsk_tpu.io.packed import pack_codes, packed_shapes, unpack_codes_jnp


def canonical(codes: np.ndarray) -> np.ndarray:
    """What unpack must restore: every invalid byte becomes exactly PAD."""
    return np.where(codes <= 3, codes, PAD).astype(np.uint8)


@pytest.mark.parametrize("L", [16, 20, 32, 48, 96, 100, 128, 1024])
def test_roundtrip_exact(L):
    rng = np.random.default_rng(L)
    codes = rng.integers(0, 4, (7, L), dtype=np.uint8)
    # sprinkle invalids: separators, N-runs, row tails
    inv = rng.random((7, L)) < 0.15
    codes[inv] = PAD
    codes[3, :] = PAD                      # dead row
    codes[5, L // 2:] = PAD                # padded tail
    words, bitmap = pack_codes(codes)
    nw, nb = packed_shapes(L)
    assert words.shape == (7, nw) and words.dtype == np.uint32
    assert bitmap.shape == (7, nb) and bitmap.dtype == np.uint32
    out = np.asarray(unpack_codes_jnp(words, bitmap, L))
    np.testing.assert_array_equal(out, canonical(codes))


def test_roundtrip_under_jit_3d():
    import jax

    rng = np.random.default_rng(0)
    codes = rng.integers(0, 5, (3, 4, 64), dtype=np.uint8)  # 4 = invalid
    codes[codes == 4] = PAD
    ws, bs = zip(*(pack_codes(codes[g]) for g in range(3)))
    words, bitmap = np.stack(ws), np.stack(bs)
    out = np.asarray(
        jax.jit(lambda w, b: unpack_codes_jnp(w, b, 64))(words, bitmap)
    )
    np.testing.assert_array_equal(
        out, np.stack([canonical(codes[g]) for g in range(3)])
    )


@pytest.mark.parametrize("L", [16, 48, 100, 128, 1024])
def test_native_packer_lockstep(L):
    from dsk_tpu.io import native
    from dsk_tpu.io.packed import pack_codes_numpy

    if not native.available():
        pytest.skip("libdskio.so unavailable")
    rng = np.random.default_rng(L + 1)
    codes = rng.integers(0, 4, (37, L), dtype=np.uint8)
    codes[rng.random((37, L)) < 0.1] = PAD
    wn, bn = native.pack_batch(codes)
    wp, bp = pack_codes_numpy(codes)
    np.testing.assert_array_equal(wn, wp)
    np.testing.assert_array_equal(bn, bp)


def test_wire_bytes_shrink():
    # the point of the format: <= 3 bits/base on the wire (+ alignment)
    words, bitmap = pack_codes(np.zeros((128, 1024), np.uint8))
    wire = words.nbytes + bitmap.nbytes
    assert wire * 8 <= 3 * 128 * 1024 + 128 * 32
    assert wire < (128 * 1024) // 2


@pytest.mark.parametrize("L", [16, 20, 48, 100, 128, 1024])
def test_exc_roundtrip_exact(L):
    from dsk_tpu.io.packed import (
        exc_shapes,
        pack_codes_exc,
        unpack_codes_exc_jnp,
    )

    rng = np.random.default_rng(L + 3)
    codes = rng.integers(0, 4, (9, L), dtype=np.uint8)
    inv = rng.random((9, L)) < 0.05
    codes[inv] = PAD
    codes[3, :] = PAD                      # dead row (live = 0)
    codes[5, L // 2:] = PAD                # padded tail
    codes[7, 0] = PAD                      # leading invalid
    E = int((codes > 3).sum(axis=1).max()) + 1  # fits the worst row
    words, meta = pack_codes_exc(codes, E)
    nw, nm = exc_shapes(L, E)
    assert words.shape == (9, nw) and words.dtype == np.uint32
    assert meta.shape == (9, nm) and meta.dtype == np.uint16
    out = np.asarray(unpack_codes_exc_jnp(words, meta, L))
    np.testing.assert_array_equal(out, canonical(codes))


def test_exc_words_identical_to_bitmap_words():
    # the code-word plane is shared between the two wire formats
    from dsk_tpu.io.packed import pack_codes_exc

    rng = np.random.default_rng(11)
    codes = rng.integers(0, 4, (17, 100), dtype=np.uint8)
    codes[rng.random((17, 100)) < 0.1] = PAD
    w_bm, _ = pack_codes(codes)
    w_exc, _ = pack_codes_exc(codes, 32)
    np.testing.assert_array_equal(w_bm, w_exc)


@pytest.mark.parametrize("L", [16, 48, 100, 128, 1024])
def test_exc_native_packer_lockstep(L):
    from dsk_tpu.io import native
    from dsk_tpu.io.packed import pack_codes_exc_numpy

    if not native.available() or native.pack_batch_exc(
        np.zeros((1, 4), np.uint8), 2
    ) is None:
        pytest.skip("libdskio.so (with fx_pack_batch_exc) unavailable")
    rng = np.random.default_rng(L + 5)
    codes = rng.integers(0, 4, (37, L), dtype=np.uint8)
    codes[rng.random((37, L)) < 0.02] = PAD
    codes[0, :] = PAD
    E = 32 if L > 64 else L
    wn, mn = native.pack_batch_exc(codes, E)
    wp, mp_ = pack_codes_exc_numpy(codes, E)
    np.testing.assert_array_equal(wn, wp)
    np.testing.assert_array_equal(mn, mp_)


def test_exc_overflow_raises_both_packers():
    from dsk_tpu.io import native
    from dsk_tpu.io.packed import WireOverflow, pack_codes_exc_numpy

    codes = np.zeros((4, 64), np.uint8)
    codes[2, 1:40:2] = PAD  # 20 invalid events, live ends valid
    with pytest.raises(WireOverflow):
        pack_codes_exc_numpy(codes, 16)
    if native.available():
        out_ok = native.pack_batch_exc(codes, 32)
        if out_ok is not None:  # symbol present
            with pytest.raises(WireOverflow):
                native.pack_batch_exc(codes, 16)


def test_exc_wire_bytes_shrink_further():
    # the point of the exc format: ~2.3 bits/base at 1024-wide rows
    from dsk_tpu.io.packed import pack_codes_exc

    words, meta = pack_codes_exc(np.zeros((128, 1024), np.uint8), 16)
    wire = words.nbytes + meta.nbytes
    assert wire * 8 <= 2.3 * 128 * 1024
    w_bm, b_bm = pack_codes(np.zeros((128, 1024), np.uint8))
    assert wire < w_bm.nbytes + b_bm.nbytes


def test_dist_engine_wire_formats_agree():
    """The same batch counted through wire="exc" (default) and
    wire="bitmap" must produce identical tables."""
    from dsk_tpu.dist.engine import DistCountEngine, default_mesh
    from dsk_tpu.io.batch import Batch

    rng = np.random.default_rng(23)
    codes = rng.integers(0, 4, (16, 96), dtype=np.uint8)
    codes[rng.random((16, 96)) < 0.04] = PAD
    batch = Batch(codes, np.zeros(16, np.int32), 16)
    results = {}
    for wire in ("exc", "bitmap"):
        eng = DistCountEngine(
            7, mesh=default_mesh(), batch_rows=16, row_len=96,
            buf_batches=2, table_cap=1 << 11, wire=wire,
        )
        assert eng.wire == wire
        res = eng.count_stream(iter([Batch(
            codes.copy(), np.zeros(16, np.int32), 16
        )]))
        results[wire] = (res.kmers.copy(), res.counts.copy())
    np.testing.assert_array_equal(results["exc"][0], results["bitmap"][0])
    np.testing.assert_array_equal(results["exc"][1], results["bitmap"][1])


def test_dist_engine_counts_through_packed_path():
    """End-to-end through DistCountEngine on the CPU mesh: the packed
    wire is the ONLY ingest path, so fixture parity elsewhere already
    covers it; this pins a tiny case with in-row separators directly."""
    from dsk_tpu import oracle
    from dsk_tpu.dist.engine import DistCountEngine, default_mesh
    from dsk_tpu.io.batch import Batch
    from dsk_tpu.kmer import codec

    rng = np.random.default_rng(7)
    k = 5
    letters = np.frombuffer(b"ACTG", np.uint8)  # A=0,C=1,T=2,G=3
    from collections import defaultdict

    rows = []
    want: dict[int, int] = defaultdict(int)
    for _ in range(16):
        a = rng.integers(0, 4, 40, dtype=np.uint8)
        b = rng.integers(0, 4, 25, dtype=np.uint8)
        row = np.full(96, PAD, np.uint8)
        row[:40] = a
        row[41:66] = b  # packed pair with one separator
        rows.append(row)
        oracle.count_sequence(want, letters[a].tobytes(), k)
        oracle.count_sequence(want, letters[b].tobytes(), k)
    codes = np.stack(rows)
    eng = DistCountEngine(
        k, mesh=default_mesh(), batch_rows=16, row_len=96,
        buf_batches=2, table_cap=1 << 11,
    )
    batch = Batch(codes, np.zeros(16, np.int32), 16)
    res = eng.count_stream(iter([batch]))
    got = {
        codec.words_to_value(row): int(c)
        for row, c in zip(res.kmers, res.counts)
    }
    assert got == want


def test_exc_wire_rejected_for_wide_rows():
    # uint16 positions cannot address rows >= 65535: explicit exc must
    # fail at CONSTRUCTION (not from a pack thread mid-stream), and the
    # default must silently pick bitmap
    from dsk_tpu.dist.engine import DistCountEngine, default_mesh

    with pytest.raises(ValueError, match="row_len"):
        DistCountEngine(
            31, mesh=default_mesh(), batch_rows=8, row_len=1 << 16,
            table_cap=1 << 11, wire="exc",
        )
    eng = DistCountEngine(
        31, mesh=default_mesh(), batch_rows=8, row_len=1 << 16,
        table_cap=1 << 11,
    )
    assert eng.wire == "bitmap"
