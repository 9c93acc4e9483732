"""Packed host->device wire formats: 2-bit codes + validity.

The byte-per-base (B, L) uint8 batch costs 8 bits/base over the host->
device link; DNA carries 2.  Batches travel as 16-base uint32 code
words plus validity in one of two encodings, unpacked on device by a
fused elementwise stage in front of extraction (VPU shifts — negligible
next to the counting sorts):

  * "exc" (default): per-row live length + the positions of the few
    invalid bases before it (read separators, in-read N's) as (1+E)
    uint16 — ~2.3 bits/base at 1024-wide rows.  Valid because packed
    rows have ~row_len/read_len invalid EVENTS, not row_len/8 bytes'
    worth; pathological N-dense rows raise WireOverflow and the run
    retries on "bitmap" (engine/run.py valve).
  * "bitmap": a dense 32-base validity bitmap — 3 bits/base, any row.

The reference faces the same volume question at its process<->disk
boundary and packs partition files to 2 bits/base (doc/paper.tex:104);
this is that idea applied to the device's ingest boundary (host->device
bytes; whether they are on the critical path over PCIe is ROADMAP S3f).

Layout (row-major, LSB-first so unpack is a single shift):
  base i of a row  -> code word i // 16, bits 2*(i % 16)
  validity bit     -> bitmap word i // 32, bit i % 32
Invalid positions (PAD / split-at-invalid separators) pack code 0 with
validity 0; unpack restores exactly PAD there, so
``unpack(pack(codes)) == canonical(codes)`` where canonical maps every
invalid byte to PAD.  Rows whose length is not a multiple of 32 are
padded with invalid tail bits.
"""

from __future__ import annotations

import numpy as np

from dsk_tpu.io.batch import PAD, ROW_EVENT_CAP

# default exception slots per row for the "exc" wire format (see
# pack_codes_exc): covers the ~row_len/read_len read separators of a
# packed 1024-wide row plus a few in-read N's.  Equal to the batchers'
# soft per-row event cap (io/batch.py ROW_EVENT_CAP, fastx.cpp
# EVENT_CAP), which closes rows early so parsed rows never exceed it —
# except a single read chunk with > E internal N's, which raises
# WireOverflow and retries the run on the dense-bitmap format.
EXC_E = ROW_EVENT_CAP


class WireOverflow(RuntimeError):
    """A row has more invalid positions than the sparse "exc" wire
    format's E exception slots (pathological N-dense input).  Retry
    valve: re-stream on the dense validity-bitmap format (engine/run.py
    rebuilds the engine with wire="bitmap")."""


def packed_shapes(row_len: int) -> tuple[int, int]:
    """(code words, bitmap words) per row of ``row_len`` bases."""
    lpad = -(-row_len // 32) * 32
    return lpad // 16, lpad // 32


def pack_codes(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(B, L) uint8 codes -> ((B, ceil(L/16)) uint32 words,
    (B, ceil(L/32)) uint32 validity bitmap).

    Prefers the C packer (native.pack_batch, ~10x) — this runs per batch
    on the prefetch thread; the numpy path below is the lockstep-tested
    fallback."""
    from dsk_tpu.io import native

    out = native.pack_batch(codes)
    if out is not None:
        return out
    return pack_codes_numpy(codes)


def pack_codes_numpy(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Pure-numpy packer (normative reference for fx_pack_batch)."""
    B, L = codes.shape
    nw, nb = packed_shapes(L)
    lpad = nb * 32
    if lpad != L:
        full = np.full((B, lpad), PAD, np.uint8)
        full[:, :L] = codes
        codes = full
    valid = codes <= 3
    two = np.where(valid, codes, 0).astype(np.uint32)
    # or-reduce 16 shifted lanes into one word (vectorized over B*nw)
    lanes = two.reshape(B, nw, 16) << (2 * np.arange(16, dtype=np.uint32))
    words = np.bitwise_or.reduce(lanes, axis=2)
    vlanes = valid.reshape(B, nb, 32).astype(np.uint32) << np.arange(
        32, dtype=np.uint32
    )
    bitmap = np.bitwise_or.reduce(vlanes, axis=2)
    return words, bitmap


def exc_shapes(row_len: int, E: int = EXC_E) -> tuple[int, int]:
    """(code words, meta columns) per row of the "exc" wire format."""
    return packed_shapes(row_len)[0], 1 + E


def pack_codes_exc(
    codes: np.ndarray, E: int = EXC_E
) -> tuple[np.ndarray, np.ndarray]:
    """(B, L) uint8 codes -> ((B, ceil(L/16)) uint32 code words,
    (B, 1+E) uint16 meta) — the SPARSE validity encoding.

    meta[:, 0] is the row's live length (1 + last valid position; 0 for
    all-invalid rows) and meta[:, 1:] the positions of the (few) invalid
    bases BEFORE it (read separators, in-read N's), ascending, padded
    with 0xFFFF.  The dense 1-bit/base bitmap costs row_len/8 bytes per
    row; real rows have ~row_len/read_len invalid events, so this is
    2(1+E) bytes instead (1024-wide rows: 128 -> 34 B, total wire
    3.03 -> 2.30 bits/base — the H2D link is the CLI bottleneck).
    Rows with more than E events raise WireOverflow (the engine's retry
    valve falls back to the bitmap format).

    Prefers the C packer (native.pack_batch_exc); numpy fallback below
    is the lockstep-tested normative reference."""
    from dsk_tpu.io import native

    out = native.pack_batch_exc(codes, E)
    if out is not None:
        return out
    return pack_codes_exc_numpy(codes, E)


def pack_codes_exc_numpy(
    codes: np.ndarray, E: int = EXC_E
) -> tuple[np.ndarray, np.ndarray]:
    """Pure-numpy exc packer (normative reference for fx_pack_batch_exc)."""
    B, L = codes.shape
    if L >= 0xFFFF:
        raise ValueError(f"exc wire format needs row_len < 65535, got {L}")
    words, _ = pack_codes_numpy(codes)
    valid = codes <= 3
    any_valid = valid.any(axis=1)
    live = np.where(
        any_valid, L - np.argmax(valid[:, ::-1], axis=1), 0
    ).astype(np.int64)
    inv = ~valid & (np.arange(L)[None, :] < live[:, None])
    counts = inv.sum(axis=1)
    worst = int(counts.max(initial=0))
    if worst > E:
        raise WireOverflow(
            f"row with {worst} invalid positions exceeds the exc wire "
            f"format's E={E} slots"
        )
    meta = np.full((B, 1 + E), 0xFFFF, np.uint16)
    meta[:, 0] = live.astype(np.uint16)
    r, c = np.nonzero(inv)
    if r.size:
        first = np.searchsorted(r, np.arange(B))
        rank = np.arange(r.size) - first[r]
        meta[r, 1 + rank] = c
    return words, meta


def unpack_codes_exc_jnp(words, meta, row_len: int):
    """Device-side inverse of pack_codes_exc: -> (B, row_len) uint8
    codes with PAD at invalid positions.  Pure elementwise + a tiny
    (B, L, E) broadcast-compare reduce (XLA fuses it into the extraction
    stage); works under jit on any backend."""
    import jax.numpy as jnp

    w = jnp.repeat(words, 16, axis=-1)[..., :row_len]
    i = jnp.arange(row_len, dtype=jnp.uint32)
    codes = (w >> (2 * (i % 16))) & jnp.uint32(3)
    live = meta[:, :1].astype(jnp.int32)            # (B, 1)
    exc = meta[:, 1:].astype(jnp.int32)             # (B, E)
    ii = jnp.arange(row_len, dtype=jnp.int32)
    ok = ii[None, :] < live
    hit = jnp.any(ii[None, :, None] == exc[:, None, :], axis=-1)
    return jnp.where(
        ok & ~hit, codes.astype(jnp.uint8), jnp.uint8(int(PAD))
    )


def unpack_codes_jnp(words, bitmap, row_len: int):
    """Device-side inverse of pack_codes: -> (B, row_len) uint8 codes
    with PAD at invalid positions.  Pure elementwise (XLA fuses it into
    the extraction stage); works under jit on any backend."""
    import jax.numpy as jnp

    # repeat (broadcast+reshape, no gather) each word across its bases,
    # then shift each base's bits down; slice off the 32-alignment tail
    w = jnp.repeat(words, 16, axis=-1)[..., :row_len]
    i = jnp.arange(row_len, dtype=jnp.uint32)
    codes = (w >> (2 * (i % 16))) & jnp.uint32(3)
    v = jnp.repeat(bitmap, 32, axis=-1)[..., :row_len]
    ok = (v >> (i % 32)) & jnp.uint32(1)
    return jnp.where(
        ok == 1, codes.astype(jnp.uint8), jnp.uint8(int(PAD))
    )
