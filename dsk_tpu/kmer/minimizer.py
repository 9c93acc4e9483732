"""Minimizers and minimizer-based repartition.

The TPU analog of gatb ModelMinimizer (SURVEY.md C2) and
RepartitorAlgorithm/MmersFrequency (C6): every k-mer window gets the
smallest m-mer it contains (strand-symmetric), m-mer frequencies are
sampled from the bank, and minimizers are assigned to partitions either
round-robin (lexicographic type) or frequency-balanced (the reference's
`-minimizer-type 1` / `-repartition-type` behavior — KMC2/3 lineage,
CHANGELOG.md:13).

The distributed engine routes by a mixed hash by default (statistically
balanced without a table); the minimizer machinery exists for
(a) capability parity with the reference's options, (b) superkmer
compaction (consecutive windows sharing a minimizer travel as one
record), and (c) frequency-aware routing when input skew defeats the
hash (engine option).

Definition used here (documented contract — the reference's exact
minimizer ORDER includes lexicographic-with-forbidden-patterns
heuristics that are not part of its output contract): the minimizer of a
window is the minimum over the canonical codes of all m-mers of the
window, where an m-mer's canonical code is min(fwd, revcomp) under the
A<C<T<G packing.  m <= 16 (fits one uint32 word).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# numpy ON PURPOSE (see kmer/device.py SENTINEL): an eager jnp scalar
# would become a device constant read back at lowering time
MINIMIZER_SENTINEL = np.uint32(0xFFFFFFFF)


def mmer_codes(batch: jax.Array, m: int) -> tuple[jax.Array, jax.Array]:
    """All canonical m-mer codes of a (B, L) uint8 batch.

    Returns ((B, L-m+1) uint32 canonical codes, (B, L-m+1) valid bool).
    Pure jnp doubling construction: packed codes of 2^j-base blocks at
    every offset, combined per set bit of m.
    """
    if m < 1 or m > 16:
        raise ValueError(f"minimizer size must be in 1..16, got {m}")
    B, L = batch.shape
    nmm = L - m + 1
    c32 = batch.astype(jnp.uint32)
    okay = c32 <= 3
    c = jnp.where(okay, c32, 0)
    pad = jnp.zeros((B, 16), jnp.uint32)
    P = jnp.concatenate([c, pad], axis=1)
    R = jnp.concatenate([jnp.where(okay, c32 ^ 2, 0), pad], axis=1)
    V = jnp.concatenate([okay, pad.astype(jnp.bool_)], axis=1)
    vtab = {1: V}
    for lvl in (1, 2, 4, 8):
        P = (P[:, :-lvl] << (2 * lvl)) | P[:, lvl:]
        R = (R[:, lvl:] << (2 * lvl)) | R[:, :-lvl]
        V = V[:, :-lvl] & V[:, lvl:]
        vtab[2 * lvl] = V

    fwd = (P[:, :nmm] >> (32 - 2 * m)) if m < 16 else P[:, :nmm]
    rc = R[:, :nmm] & jnp.uint32((1 << (2 * m)) - 1)
    canon = jnp.minimum(fwd, rc)
    if m == 16:
        vm = vtab[16][:, :nmm]
    else:
        a = 1
        while a * 2 < m:
            a *= 2
        vm = vtab[a][:, :nmm] & vtab[a][:, m - a : m - a + nmm]
    return canon, vm


def window_minimizers(
    batch: jax.Array, k: int, m: int
) -> tuple[jax.Array, jax.Array]:
    """Minimizer of every k-window of a (B, L) batch.

    Returns ((B, L-k+1) uint32 minimizers, (B, L-k+1) valid bool): the min
    canonical m-mer over the k-m+1 m-mer positions of each window
    (sentinel where the window has an invalid base).  The sliding-window
    min is a doubling sweep: O(log(k-m)) vectorized min steps.
    """
    if m > k:
        raise ValueError(f"minimizer size {m} > k {k}")
    B, L = batch.shape
    nw = L - k + 1
    codes, vm = mmer_codes(batch, m)  # (B, L-m+1)
    codes = jnp.where(vm, codes, MINIMIZER_SENTINEL)
    span = k - m + 1  # m-mers per window
    # doubling min over the span
    M = codes
    width = 1
    while width * 2 <= span:
        M = jnp.minimum(M[:, :-width], M[:, width:])
        width *= 2
    if width < span:
        M = jnp.minimum(M[:, : -(span - width)], M[:, span - width :])
    mins = M[:, :nw]
    # window valid iff every m-mer valid iff min != sentinel AND all bases
    # valid; the sentinel trick makes the min itself the validity signal
    # only if ALL m-mers invalid — recompute exact validity from vm
    V = vm
    width = 1
    while width * 2 <= span:
        V = V[:, :-width] & V[:, width:]
        width *= 2
    if width < span:
        V = V[:, : -(span - width)] & V[:, span - width :]
    valid = V[:, :nw]
    return jnp.where(valid, mins, MINIMIZER_SENTINEL), valid


def superkmer_lengths(minimizers: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Run lengths of equal consecutive minimizers within each row — the
    superkmer segmentation (consecutive windows sharing a minimizer form
    one superkmer; gatb ModelMinimizer superkmer iteration, SURVEY.md C2).

    Host-side analysis helper (route compaction uses it on device later).
    """
    out = []
    for row_m, row_v in zip(minimizers, valid):
        run = 0
        prev = None
        for mm, vv in zip(row_m, row_v):
            if not vv:
                if run:
                    out.append(run)
                run = 0
                prev = None
                continue
            if prev is not None and mm == prev:
                run += 1
            else:
                if run:
                    out.append(run)
                run = 1
                prev = mm
        if run:
            out.append(run)
    return np.asarray(out, dtype=np.int64)


def sample_minimizer_frequencies(
    bank, k: int, m: int, sample_bases: int = 1 << 20,
    batch_rows: int = 256, row_len: int = 256,
) -> np.ndarray:
    """(4^m,) int64 frequency table of window minimizers over a bank
    prefix sample (the reference's MmersFrequency sampling pass, C6)."""
    from dsk_tpu.io.batch import batch_iterator

    freq = np.zeros(4**m, dtype=np.int64)
    seen = 0
    for batch in batch_iterator(bank, k, batch_rows, row_len):
        mins, valid = window_minimizers(jnp.asarray(batch.codes), k, m)
        mn = np.asarray(mins)[np.asarray(valid)]
        np.add.at(freq, mn, 1)
        seen += batch.n_bases
        if seen >= sample_bases:
            break
    return freq


def build_repartition(
    freq: np.ndarray, n_partitions: int, frequency_aware: bool = True
) -> np.ndarray:
    """minimizer -> partition table (4^m,) int32.

    frequency_aware=True greedily assigns heaviest minimizers to the
    lightest partition (the reference's -repartition-type balancing);
    False is plain round-robin (lexicographic -minimizer-type 0 analog).
    """
    n_min = freq.shape[0]
    table = np.empty(n_min, dtype=np.int32)
    if not frequency_aware:
        table[:] = np.arange(n_min, dtype=np.int64) % n_partitions
        return table
    order = np.argsort(freq)[::-1]  # heaviest first
    loads = np.zeros(n_partitions, dtype=np.int64)
    # greedy: heavy minimizers individually; assign the long zero/light
    # tail round-robin for speed
    heavy = order[freq[order] > 0]
    for mm in heavy:
        p = int(np.argmin(loads))
        table[mm] = p
        loads[p] += freq[mm]
    light = order[freq[order] == 0]
    table[light] = np.arange(light.shape[0], dtype=np.int64) % n_partitions
    return table


def pack_rows_2bit(batch: jax.Array) -> jax.Array:
    """(B, L) uint8 codes -> (B, ceil(L/16)) uint32, 2-bit packed, base at
    position 16*w most significant within word w; invalid bases pack as 0
    (validity is carried separately by the segmentation masks)."""
    B, L = batch.shape
    c32 = jnp.where(batch <= 3, batch.astype(jnp.uint32), 0)
    pad = (-L) % 16
    if pad:
        c32 = jnp.concatenate([c32, jnp.zeros((B, pad), jnp.uint32)], axis=1)
    c32 = c32.reshape(B, -1, 16)
    word = jnp.zeros(c32.shape[:2], jnp.uint32)
    for j in range(16):
        word = word | (c32[:, :, j] << (2 * (15 - j)))
    return word


def superkmer_records(
    batch: jax.Array,
    k: int,
    m: int,
    max_span: int,
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array, jax.Array]:
    """Build fixed-shape superkmer records for routing (SURVEY.md C6 /
    the reference's KMC3-style superkmer rework, CHANGELOG.md:13).

    A superkmer = a maximal run of <= max_span consecutive windows sharing
    a minimizer (longer runs split; correctness unaffected).  Every
    occurrence of a canonical kmer has the same (strand-symmetric)
    minimizer, so minimizer routing sends all copies to one owner.

    Returns per-WINDOW-position arrays (B, nw):
      minimizers  uint32 (sentinel on non-heads / invalid)
      is_head     bool
      span        int32 windows in this record (at heads)
    plus the packed row words (B, ceil(L/16)) uint32 and nw (static).

    The record for a head at (row b, window w) covers bases
    [w, w + span + k - 1) of row b; consumers slice the packed words
    w//16 .. (w + span + k - 1 + 15)//16 with bit offset 2*(w % 16).
    """
    B, L = batch.shape
    nw = L - k + 1
    mins, valid = window_minimizers(batch, k, m)
    is_head, head_len = superkmer_segments(mins, valid)
    # split runs longer than max_span: a window starts a record iff it is
    # a run head OR its distance from the run head is a multiple of
    # max_span
    idx = jnp.broadcast_to(jnp.arange(nw, dtype=jnp.int32)[None, :], (B, nw))
    head_pos = jax.lax.cummax(jnp.where(is_head, idx, 0), axis=1)
    off_in_run = idx - head_pos
    is_rec = valid & (is_head | ((off_in_run % max_span) == 0))
    # span of each record: min(max_span, run_end - this + 1)
    prev_same = jnp.zeros((B, nw), jnp.bool_)
    prev_same = prev_same.at[:, 1:].set(
        valid[:, 1:] & valid[:, :-1] & (mins[:, 1:] == mins[:, :-1])
    )
    is_end = jnp.ones((B, nw), jnp.bool_)
    is_end = is_end.at[:, :-1].set(~prev_same[:, 1:])
    is_end = is_end & valid
    INT_MAX = jnp.int32(2**31 - 1)
    end_pos = jax.lax.cummin(
        jnp.where(is_end, idx, INT_MAX), axis=1, reverse=True
    )
    span = jnp.where(
        is_rec, jnp.minimum(end_pos - idx + 1, max_span), 0
    ).astype(jnp.int32)
    packed = pack_rows_2bit(batch)
    rec_mins = jnp.where(is_rec, mins, MINIMIZER_SENTINEL)
    return rec_mins, is_rec, span, packed, mins


def unpack_records_to_rows(
    words: jax.Array, bit_off: jax.Array, n_bases: int
) -> jax.Array:
    """(R, PW) packed uint32 + (R,) base offset in [0, 16) ->
    (R, n_bases) uint8 codes (tail beyond a record's span is garbage;
    callers mask by span).  Vectorized shift-and-extract."""
    R, PW = words.shape
    # base j of record r lives in word (off + j) // 16 at bit
    # 2*(15 - (off + j) % 16)
    j = jnp.arange(n_bases, dtype=jnp.int32)[None, :]
    pos = bit_off[:, None] + j                # (R, n_bases)
    wi = pos // 16
    bi = 2 * (15 - (pos % 16))
    w = jnp.take_along_axis(
        words, jnp.clip(wi, 0, PW - 1), axis=1
    )
    return ((w >> bi) & 3).astype(jnp.uint8)


def superkmer_segments(
    minimizers: jax.Array, valid: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Device-side superkmer segmentation (vectorized run detection).

    minimizers/valid: (B, nw) as produced by window_minimizers.  Returns
    (is_head, head_len): is_head marks the first window of each superkmer
    (a maximal run of consecutive valid windows sharing a minimizer,
    never crossing a row); head_len holds the run length at head
    positions (0 elsewhere).  The future routing path sends one packed
    record per head; this is also the compression-factor diagnostic
    (mean run length == kmers per routed record).
    """
    B, nw = minimizers.shape
    prev_same = jnp.zeros((B, nw), jnp.bool_)
    prev_same = prev_same.at[:, 1:].set(
        valid[:, 1:] & valid[:, :-1]
        & (minimizers[:, 1:] == minimizers[:, :-1])
    )
    is_head = valid & ~prev_same
    # run length via position-of-head subtraction: for each window its
    # head position (cummax of head indices), then length = (last in run)
    # - head + 1 computed at heads by a reverse scan over run ends
    idx = jnp.broadcast_to(jnp.arange(nw, dtype=jnp.int32)[None, :], (B, nw))
    head_pos = jax.lax.cummax(jnp.where(is_head, idx, 0), axis=1)
    is_end = jnp.ones((B, nw), jnp.bool_)
    is_end = is_end.at[:, :-1].set(~prev_same[:, 1:])
    is_end = is_end & valid
    INT_MAX = jnp.int32(2**31 - 1)
    end_pos = jax.lax.cummin(
        jnp.where(is_end, idx, INT_MAX), axis=1, reverse=True
    )
    head_len = jnp.where(is_head, end_pos - head_pos + 1, 0)
    return is_head, head_len
