"""Device-side (jnp) k-mer extraction and counting primitives.

The reference's per-base rolling extraction loop (gatb ModelCanonical,
SURVEY.md C2, HOT LOOP #1) and per-partition radix-sort/count (SURVEY.md C4,
HOT LOOPS #2-3) re-designed as data-parallel array programs:

  * reads live on device as (B, L) uint8 code tensors (0..3 valid, >=4
    invalid/pad),
  * k-mers are W x uint32 words, word 0 most significant, so lexicographic
    word comparison == integer comparison of the 2k-bit value (the gatb
    LargeInt<N> analog, SURVEY.md C3; W is a static "span" dispatched at
    trace time exactly like the reference's KSIZE_LIST template dispatch,
    src/DSK.cpp:103),
  * window extraction is a static unrolled sweep of k shifted adds over the
    whole batch — every window position is one independent element (the
    thread-pool-over-reads of the reference becomes pure data parallelism;
    XLA fuses the sweep into one loop that reads each base once),
  * counting is sort + segment-reduce: lax.sort over the W key words, run
    boundaries, segment_sum of weights.  Sentinel rows (all-ones words)
    sort to the end; all-ones is never a canonical k-mer (canonical(G^k)
    = C^k < G^k), so the sentinel cannot collide.

Everything is shape-static and jit-friendly; no data-dependent control flow.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from dsk_tpu.kmer.codec import words_per_kmer

# numpy scalar ON PURPOSE: a module-level jnp.uint32 would be an eager
# array on the default device, and every program that closes over it
# would read it back to the host at lowering time.  np.uint32 lowers to
# a plain literal.
SENTINEL = np.uint32(0xFFFFFFFF)


def kmer_hash(words: jax.Array) -> jax.Array:
    """Mixed 32-bit hash of (N, W) uint32 kmer words -> (N,) uint32.

    Used for owner-chip routing (dist) and pass selection (multi-pass) —
    the reference's h(m) partition/pass hash (doc/paper.tex:74).
    Murmur-style multiply/xor-shift mixing so low bits are usable for
    `% n`.  NOTE: pass selection and chip routing both consume this one
    hash; they use INDEPENDENT bits (pass uses the hash of hash+seed) to
    avoid correlation between the two partitions.
    """
    return kmer_hash_planes(tuple(words[:, w] for w in range(words.shape[1])))


def kmer_hash_planes(planes: tuple[jax.Array, ...]) -> jax.Array:
    """kmer_hash over plane layout (tuple of (N,) uint32 word arrays)."""
    h = jnp.full(planes[0].shape, 0x9E3779B9, jnp.uint32)
    for p in planes:
        h = (h ^ p) * jnp.uint32(0x85EBCA6B)
        h = h ^ (h >> 13)
    h = h * jnp.uint32(0xC2B2AE35)
    return h ^ (h >> 16)


def pass_hash(words: jax.Array) -> jax.Array:
    """Independent second hash for multi-pass selection (decorrelated from
    kmer_hash so pass-restriction doesn't skew per-chip routing)."""
    return pass_hash_planes(tuple(words[:, w] for w in range(words.shape[1])))


def pass_hash_planes(planes: tuple[jax.Array, ...]) -> jax.Array:
    """pass_hash over plane layout (tuple of (N,) uint32 word arrays)."""
    h = jnp.full(planes[0].shape, 0x27220A95, jnp.uint32)
    for p in planes:
        h = (h ^ p) * jnp.uint32(0xCC9E2D51)
        h = (h << 15) | (h >> 17)
        h = h * jnp.uint32(0x1B873593)
    h = h ^ (h >> 15)
    h = h * jnp.uint32(0x2C1B3C6D)
    return h ^ (h >> 12)


def _mask_word0(k: int, w: int) -> int:
    """Bit mask of the most-significant word (unused high bits are zero)."""
    used = 2 * k - 32 * (w - 1)
    return (1 << used) - 1 if used < 32 else 0xFFFFFFFF


@functools.partial(jax.jit, static_argnames=("k",))
def extract_canonical_planes(
    batch: jax.Array, k: int
) -> tuple[jax.Array, jax.Array]:
    """All canonical k-mer windows of a (B, L) uint8 code batch, as planes.

    Returns (planes, valid):
      planes: (W, B, L-k+1) uint32 — word w of every window's canonical
              packed k-mer is one contiguous plane (word 0 most
              significant), sentinel where invalid; the flush sort takes
              plane slices as operands with no strided copies
      valid:  (B, L-k+1) bool — window fully inside a run of valid bases

    Mirrors the semantics of the reference's rolling ModelCanonical codes
    (split at invalid bases), but as k static shifted adds over the batch
    instead of a sequential per-base loop.  XLA fuses the whole sweep into
    one elementwise loop; on the H100 it ties a doubling formulation and a
    hand-written Pallas kernel inside the counting step (PERF.md).
    """
    if batch.ndim != 2:
        raise ValueError(f"batch must be (B, L), got {batch.shape}")
    B, L = batch.shape
    if L < k:
        raise ValueError(f"row length {L} < k={k}")
    W = words_per_kmer(k)
    nw = L - k + 1

    is_valid = batch <= 3
    codes = jnp.where(is_valid, batch, 0).astype(jnp.uint32)

    # window validity via prefix sums of invalid flags
    bad = (~is_valid).astype(jnp.int32)
    cbad = jnp.cumsum(bad, axis=1)
    cbad0 = jnp.pad(cbad, ((0, 0), (1, 0)))
    valid = (cbad0[:, k:] - cbad0[:, :-k]) == 0  # (B, nw)

    fwd = [jnp.zeros((B, nw), jnp.uint32) for _ in range(W)]
    rc = [jnp.zeros((B, nw), jnp.uint32) for _ in range(W)]
    for j in range(k):
        base = codes[:, j : j + nw]
        # forward: base j sits at global bit 2*(k-1-j) (2-bit units never
        # straddle 32-bit words since bit positions are even)
        p = 2 * (k - 1 - j)
        fwd[W - 1 - p // 32] |= base << (p % 32)
        # revcomp: complemented base j sits at global bit 2*j
        q = 2 * j
        rc[W - 1 - q // 32] |= (base ^ 2) << (q % 32)

    # canonical = lexicographic (== integer) min of fwd vs rc
    lt = jnp.zeros((B, nw), jnp.bool_)
    eq = jnp.ones((B, nw), jnp.bool_)
    for w in range(W):
        lt = lt | (eq & (fwd[w] < rc[w]))
        eq = eq & (fwd[w] == rc[w])
    canon = [jnp.where(lt | eq, fwd[w], rc[w]) for w in range(W)]
    canon = [jnp.where(valid, cw, SENTINEL) for cw in canon]
    return jnp.stack(canon), valid


def extract_canonical(batch: jax.Array, k: int) -> tuple[jax.Array, jax.Array]:
    """extract_canonical_planes with row layout: words (B, L-k+1, W)."""
    planes, valid = extract_canonical_planes(batch, k)
    return jnp.moveaxis(planes, 0, -1), valid


def sum_by_key(words: jax.Array, weights: jax.Array) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Group-by-key sum: the device replacement for DSK's per-partition
    radix-sort + run-length scan (SURVEY.md C4).

    words:   (N, W) uint32 keys (sentinel rows allowed)
    weights: (N,)   int32 per-row weight (0 for sentinel/padding rows)

    Returns (uniq, counts, n_uniq):
      uniq:   (N, W) uint32 — distinct keys in sorted order, sentinel-padded
      counts: (N,)   int32  — total weight per distinct key
      n_uniq: ()     int32  — number of distinct non-sentinel keys

    Scatter-free: run totals come from cumsum + run-boundary scans and
    the compaction of distinct keys to the front is a second, cheap
    single-key sort (a design kept from the previous chip, where
    scatters lost to sorts; a hash count is ROADMAP S3d).  Total weight per call must stay < 2^31.
    """
    N, W = words.shape
    planes = tuple(words[:, w] for w in range(W))
    uniq_planes, counts, n_uniq = sum_by_key_planes(planes, weights)
    return jnp.stack(uniq_planes, axis=-1), counts, n_uniq


def merge_sorted_planes(
    planes_a: tuple[jax.Array, ...],
    weights_a: jax.Array,
    planes_b: tuple[jax.Array, ...],
    weights_b: jax.Array,
) -> tuple[tuple[jax.Array, ...], jax.Array]:
    """Merge two individually key-sorted plane sets into one sorted set.

    Both inputs must be ascending by their W key words with dead rows as
    full sentinels (which sort to the end — exactly the layout lax.sort
    and the flush compaction produce).  The concatenation
    [reverse(a), b] is then a cyclically bitonic "valley" (descending,
    ascending, sentinel plateau), so a single bitonic MERGE network —
    ceil(log2 N) elementwise compare-exchange stages — sorts it: O(N log N)
    elementwise word-ops instead of the O(N log^2 N) of a full
    lax.sort.  Used by the "merge" flush: the persistent table is already
    sorted, so only the new buffer pays a real sort (SURVEY.md C4 — DSK
    also exploits per-partition sortedness by never re-sorting counted
    output).

    Virtual +inf padding to the next power of two is simulated: a stage's
    shifted partner slots that fall off the end read SENTINEL, so no
    physical pad is materialized.
    """
    W = len(planes_a)
    arrs = [
        jnp.concatenate([planes_a[w][::-1], planes_b[w]]) for w in range(W)
    ] + [
        jnp.concatenate(
            [weights_a.astype(jnp.int32)[::-1], weights_b.astype(jnp.int32)]
        )
    ]
    N = arrs[0].shape[0]
    P = 1 << (N - 1).bit_length()  # virtual length (power of two)
    idx = jnp.arange(N, dtype=jnp.int32)

    s = P // 2
    while s >= 1:
        in_lo = (idx & s) == 0

        # partner values via static shifts; off-the-end partners read the
        # sentinel (+inf keys always lose the exchange, so their weight
        # fill is never selected); leading fill of the down-shift is
        # never read (in_hi slots have idx >= s)
        def shift_up(a, fill):
            if s >= N:
                return jnp.full((N,), fill, a.dtype)
            return jnp.concatenate(
                [a[s:], jnp.full((s,), fill, a.dtype)]
            )

        def shift_down(a):
            if s >= N:
                return jnp.zeros((N,), a.dtype)
            return jnp.concatenate(
                [jnp.zeros((s,), a.dtype), a[: N - s]]
            )

        up = [shift_up(a, SENTINEL) for a in arrs[:W]]
        up.append(shift_up(arrs[W], 0))
        down = [shift_down(a) for a in arrs]

        # lexicographic key(x) > key(up) / key(down) > key(x)
        gt_lo = jnp.zeros((N,), jnp.bool_)
        eq = jnp.ones((N,), jnp.bool_)
        for w in range(W):
            gt_lo = gt_lo | (eq & (arrs[w] > up[w]))
            eq = eq & (arrs[w] == up[w])
        gt_hi = jnp.zeros((N,), jnp.bool_)
        eq = jnp.ones((N,), jnp.bool_)
        for w in range(W):
            gt_hi = gt_hi | (eq & (down[w] > arrs[w]))
            eq = eq & (down[w] == arrs[w])

        take_partner = jnp.where(in_lo, gt_lo, gt_hi)
        arrs = [
            jnp.where(take_partner, jnp.where(in_lo, u, d), a)
            for a, u, d in zip(arrs, up, down)
        ]
        s //= 2

    return tuple(arrs[:W]), arrs[W]


def _run_heads(
    skeys: tuple[jax.Array, ...], sweights: jax.Array
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Run heads + exclusive weight prefix of a key-sorted plane set.

    Returns (keep, csum_before, total_weight): keep marks the first row
    of each run of a real (non-sentinel) key; csum_before[i] is the sum
    of weights of rows BEFORE i.  Run totals are not materialized here:
    compacted run heads sit in global order, so run i's total is simply
    csum_before[head_{i+1}] - csum_before[head_i] (the next run starts
    where this one ends; total_weight closes the last run) — see
    _counts_from_prefix.  One cumsum replaces the old cumsum +
    reverse-cummin-over-run-ends sweep (the cummin and its masks were a
    large share of the dedup scan on the previous chip).
    Total weight per call must stay < 2^31 (int32 csum).
    """
    W = len(skeys)
    N = skeys[0].shape[0]
    is_new = jnp.zeros((N,), jnp.bool_).at[0].set(True)
    neq = jnp.zeros((N - 1,), jnp.bool_)
    for w in range(W):
        neq = neq | (skeys[w][1:] != skeys[w][:-1])
    is_new = is_new.at[1:].set(neq)

    sw = sweights.astype(jnp.int32)
    csum = jnp.cumsum(sw)
    csum_before = csum - sw
    total_weight = csum[-1]

    # a run is a real key iff not every word is SENTINEL (a canonical kmer
    # can have word0 == 0xFFFFFFFF — e.g. a G^16 prefix when 16 | k — but
    # never ALL words: canonical(G^k) = C^k)
    is_sent = jnp.ones((N,), jnp.bool_)
    for w in range(W):
        is_sent = is_sent & (skeys[w] == SENTINEL)
    keep = is_new & ~is_sent
    return keep, csum_before, total_weight


def _wrap_flag(total_weight: jax.Array) -> jax.Array:
    """1 iff the int32 occurrence cumsum wrapped past 2^31 (VERDICT r2
    weak #1).  Weights are non-negative, so the first crossing of 2^31
    lands the total in [2^31, 2^32) == negative int32; per-flush
    increments are << 2^31 (the flush buffer holds <= ~10^8 windows), so
    the flag fires at the first wrapping flush, before a second wrap
    could make the total positive again.  Callers surface it through the
    engine's typed-overflow valve: the retry doubles n_passes, halving
    per-pass occurrence volume (the reference plans passes from VOLUME,
    doc/paper.tex:66-67 — see engine/planner.py OCC_BUDGET for the
    planner-side constraint that keeps this guard from ever firing)."""
    return (total_weight < 0).astype(jnp.int32)


def _counts_from_prefix(
    ckey_sorted: jax.Array, cb_sorted: jax.Array, total_weight: jax.Array,
    n_valid: int,
) -> tuple[jax.Array, jax.Array]:
    """Per-run totals for COMPACTED run heads, by prefix-sum difference.

    ckey_sorted: head positions ascending, dead rows keyed >= n_valid;
    cb_sorted: each head's csum_before.  Run i's rows end where run i+1
    begins, so its total = cb[i+1] - cb[i]; the last live head closes at
    total_weight (trailing dead rows all carry weight 0).  Returns
    (live, counts)."""
    live = ckey_sorted < n_valid
    nxt_cb = jnp.concatenate([cb_sorted[1:], total_weight[None]])
    nxt_live = jnp.concatenate([live[1:], jnp.zeros((1,), jnp.bool_)])
    closing = jnp.where(nxt_live, nxt_cb, total_weight)
    return live, jnp.where(live, closing - cb_sorted, 0)


def _dedup_sorted(
    skeys: tuple[jax.Array, ...], sweights: jax.Array
) -> tuple[tuple[jax.Array, ...], jax.Array, jax.Array, jax.Array]:
    """Run-length dedup + compaction of an already key-sorted plane set
    (the post-sort half of sum_by_key_planes).  Returns (uniq_planes,
    counts, n_uniq, wrapped) — wrapped flags int32 cumsum overflow
    (_wrap_flag); counts are garbage when it is set."""
    W = len(skeys)
    N = skeys[0].shape[0]
    keep, csum_before, total_weight = _run_heads(skeys, sweights)

    # compaction by stable single-key sort: real run-heads to the front.
    # (A monotone-position scatter is the alternative; on the previous
    # chip it lost inside the fused flush program.  Not yet measured on
    # the H100.)
    idx = jnp.arange(N, dtype=jnp.int32)
    ckey = jnp.where(keep, idx, N)
    ops2 = (ckey,) + skeys + (csum_before,)
    sorted2 = jax.lax.sort(ops2, num_keys=1)
    live, counts = _counts_from_prefix(
        sorted2[0], sorted2[1 + W], total_weight, N
    )
    uniq_planes = tuple(
        jnp.where(live, sorted2[1 + w], SENTINEL) for w in range(W)
    )
    n_uniq = jnp.sum(keep.astype(jnp.int32))
    return uniq_planes, counts, n_uniq, _wrap_flag(total_weight)


def sum_by_key_planes(
    planes: tuple[jax.Array, ...], weights: jax.Array
) -> tuple[tuple[jax.Array, ...], jax.Array, jax.Array]:
    """Plane-layout core of sum_by_key: keys as W separate (N,) uint32
    arrays (contiguous lax.sort operands — no strided slicing of a (N, W)
    matrix).  Returns (uniq_planes, counts, n_uniq).  Total weight per
    call must stay < 2^31 (per-batch uses are far below; accumulating
    callers use the wrap-guarded variants below)."""
    W = len(planes)
    ops = planes + (weights.astype(jnp.int32),)
    sorted_ops = jax.lax.sort(ops, num_keys=W)
    uniq, counts, n_uniq, _ = _dedup_sorted(
        tuple(sorted_ops[:W]), sorted_ops[W]
    )
    return uniq, counts, n_uniq


def sum_by_key_planes_capped(
    planes: tuple[jax.Array, ...],
    weights: jax.Array,
    cap: int,
    segments: int = 0,
    presorted: bool = False,
) -> tuple[tuple[jax.Array, ...], jax.Array, jax.Array, jax.Array]:
    """sum_by_key_planes with a bounded output and two-stage compaction.

    The monolithic run-head compaction (one 1-key lax.sort over ALL N
    rows) was the largest flush piece on the previous chip.  With
    `segments` = S > 1 the
    compaction runs in two stages instead:

      1. deal the sorted rows into S STRIDED segments (position i ->
         segment i mod S) and front-load each segment's run heads with
         ONE batched 1-key sort of short rows;
      2. slice every segment to `slack = 2*ceil(cap/S)` columns and
         restore global order with a small flat 1-key sort over the
         S*slack survivors.

    Strided (not contiguous) segments make each segment a 1/S systematic
    sample of positions, so heads per segment track the GLOBAL head
    count (<= cap enforced by the caller's overflow check) even when
    live rows occupy only a prefix — the systematic case: a PARTIAL
    flush group (stream warm-up, final group) whose padding rows all
    sort to the end.  2x slack then overflows only under a mod-S
    periodic run-length pattern (no genomic mechanism produces one);
    dropped heads are COUNTED and returned as n_lost — the engine's
    overflow valve treats n_lost > 0 like a table overflow (retry falls
    back to the monolithic path).  It beat the monolithic compaction on
    the previous chip; not yet measured on the H100.

    Returns (uniq_planes (cap,)*W, counts (cap,), n_uniq, n_lost,
    wrapped) — wrapped flags int32 occurrence-cumsum overflow
    (_wrap_flag; counts are garbage when set, callers must raise).

    presorted=True skips the internal key sort: planes must already be
    key-sorted and weights aligned — the weightless-flush path sorts
    the key planes ALONE (unit weights are reconstructed from liveness
    after the sort, saving 1/3 of the sorted bytes at k=31; PERF.md
    round 3) and hands the sorted planes here for the compaction.
    """
    W = len(planes)
    N = planes[0].shape[0]
    if presorted:
        skeys, sweights = tuple(planes), weights.astype(jnp.int32)
    else:
        ops = planes + (weights.astype(jnp.int32),)
        sorted_ops = jax.lax.sort(ops, num_keys=W)
        skeys, sweights = tuple(sorted_ops[:W]), sorted_ops[W]
    S = segments
    slack = 0 if S <= 1 else min(-(-N // S), 2 * (-(-cap // S)))
    if S <= 1 or S * slack >= N // 2:
        # no meaningful reduction at this shape: monolithic path
        uniq, counts, n_uniq, wrapped = _dedup_sorted(skeys, sweights)
        return (
            tuple(u[:cap] for u in uniq),
            counts[:cap],
            n_uniq,
            jnp.int32(0),
            wrapped,
        )

    keep, csum_before, total_weight = _run_heads(skeys, sweights)
    L = -(-N // S)
    NP = S * L
    idx = jnp.arange(N, dtype=jnp.int32)
    ckey = jnp.where(keep, idx, N)
    pad = NP - N

    def padded(a, fill):
        if pad == 0:
            return a
        return jnp.concatenate([a, jnp.full((pad,), fill, a.dtype)])

    def deal(a):
        # strided deal: segment s holds positions {s, s+S, s+2S, ...}
        return a.reshape(L, S).T

    ops1 = (
        (deal(padded(ckey, N)),)
        + tuple(deal(padded(k, SENTINEL)) for k in skeys)
        + (deal(padded(csum_before, 0)),)
    )
    s1 = jax.lax.sort(ops1, num_keys=1, dimension=-1)
    n_keep_seg = jnp.sum((s1[0] < N).astype(jnp.int32), axis=1)
    n_lost = jnp.sum(jnp.maximum(n_keep_seg - slack, 0))
    sliced = tuple(o[:, :slack].reshape(S * slack) for o in s1)
    s2 = jax.lax.sort(sliced, num_keys=1)
    # counts by prefix diff over the FULL survivor list before slicing to
    # cap (the entry at cap-1 needs its successor's csum_before).  When
    # n_lost > 0, diffs spanning a lost head absorb its run — the counts
    # are then wrong, which is safe ONLY because n_lost feeds the
    # overflow valve and the whole run is retried, never emitted.
    live_full, counts_full = _counts_from_prefix(
        s2[0], s2[1 + W], total_weight, N
    )
    live = live_full[:cap]
    uniq = tuple(
        jnp.where(live, s2[1 + w][:cap], SENTINEL) for w in range(W)
    )
    counts = counts_full[:cap]
    n_uniq = jnp.sum(keep.astype(jnp.int32))
    return uniq, counts, n_uniq, n_lost, _wrap_flag(total_weight)


def compact_heads_unit(
    skeys: tuple[jax.Array, ...],
    cap: int,
    segments: int = 0,
) -> tuple[tuple[jax.Array, ...], jax.Array, jax.Array, jax.Array]:
    """sum_by_key dedup+compaction for KEY-SORTED UNIT-WEIGHT rows where
    every dead row is full-sentinel (the weightless flush contract:
    single-chip buffers append weight-1 windows, dead/filtered windows
    are sentinel-masked, and sentinels sort to the tail).

    Two unit-weight identities make this cheaper than the general
    presorted path (sum_by_key_planes_capped(presorted=True)):

      * csum_before[i] = i for live rows (all weights 1, dead rows all
        at the tail) — so a head's exclusive prefix IS its position,
        which the compaction key already carries: the int32 cumsum pass
        over N rows disappears, and the two-stage segment sorts carry
        (ckey, planes...) = W+1 operands instead of W+2 (25% fewer
        bytes at k=31 through the compaction's dominant sorts);
      * run totals = next head position - head position, closing at
        n_live (= N - dead count, one cheap reduction).

    Counts are bounded by N (< 2^31 by construction), so there is no
    wrap flag.  Returns (uniq (cap,)*W, counts (cap,), n_uniq, n_lost)
    with the same slack-loss valve semantics as
    sum_by_key_planes_capped.
    """
    W = len(skeys)
    N = skeys[0].shape[0]
    is_new = jnp.zeros((N,), jnp.bool_).at[0].set(True)
    neq = jnp.zeros((N - 1,), jnp.bool_)
    for w in range(W):
        neq = neq | (skeys[w][1:] != skeys[w][:-1])
    is_new = is_new.at[1:].set(neq)
    is_sent = jnp.ones((N,), jnp.bool_)
    for w in range(W):
        is_sent = is_sent & (skeys[w] == SENTINEL)
    keep = is_new & ~is_sent
    n_live = jnp.int32(N) - jnp.sum(is_sent.astype(jnp.int32))
    n_uniq = jnp.sum(keep.astype(jnp.int32))

    idx = jnp.arange(N, dtype=jnp.int32)
    ckey = jnp.where(keep, idx, N)

    S = segments
    slack = 0 if S <= 1 else min(-(-N // S), 2 * (-(-cap // S)))
    if S <= 1 or S * slack >= N // 2:
        ops2 = (ckey,) + skeys
        s2 = jax.lax.sort(ops2, num_keys=1)
        n_lost = jnp.int32(0)
    else:
        L = -(-N // S)
        NP = S * L
        pad = NP - N

        def padded(a, fill):
            if pad == 0:
                return a
            return jnp.concatenate(
                [a, jnp.full((pad,), fill, a.dtype)]
            )

        def deal(a):
            return a.reshape(L, S).T

        ops1 = (deal(padded(ckey, N)),) + tuple(
            deal(padded(k, SENTINEL)) for k in skeys
        )
        s1 = jax.lax.sort(ops1, num_keys=1, dimension=-1)
        n_keep_seg = jnp.sum((s1[0] < N).astype(jnp.int32), axis=1)
        n_lost = jnp.sum(jnp.maximum(n_keep_seg - slack, 0))
        sliced = tuple(o[:, :slack].reshape(S * slack) for o in s1)
        s2 = jax.lax.sort(sliced, num_keys=1)

    # totals by position diff over the FULL survivor list BEFORE the
    # cap slice (the head at cap-1 needs its successor's position): run
    # i spans [head_i, head_{i+1}); the last live head closes at n_live
    # (dead rows are all behind it).  As in the general two-stage path,
    # diffs spanning a slack-lost head absorb its run — safe only
    # because n_lost feeds the valve.
    cpos = s2[0]
    live_full = cpos < n_live
    nxt = jnp.concatenate([cpos[1:], jnp.full((1,), N, jnp.int32)])
    nxt_live = jnp.concatenate(
        [live_full[1:], jnp.zeros((1,), jnp.bool_)]
    )
    closing = jnp.where(nxt_live, nxt, n_live)
    counts_full = jnp.where(live_full, closing - cpos, 0)
    live = live_full[:cap]
    counts = counts_full[:cap]
    uniq = tuple(
        jnp.where(live, s2[1 + w][:cap], SENTINEL) for w in range(W)
    )
    return uniq, counts, n_uniq, n_lost


def sum_by_key_presorted(
    planes_a: tuple[jax.Array, ...],
    weights_a: jax.Array,
    planes_b: tuple[jax.Array, ...],
    weights_b: jax.Array,
) -> tuple[tuple[jax.Array, ...], jax.Array, jax.Array, jax.Array]:
    """sum_by_key over the union of two ALREADY-SORTED plane sets.

    Skips the full W-key sort: a bitonic merge network combines the two
    sorted inputs (merge_sorted_planes), then the run-length dedup +
    compaction run as usual.  The "merge" flush uses this with
    a = the freshly sorted buffer, b = the persistent table (sorted by
    construction), so only the buffer ever pays a real lax.sort.
    Returns (uniq_planes, counts, n_uniq, wrapped)."""
    merged_planes, merged_w = merge_sorted_planes(
        planes_a, weights_a, planes_b, weights_b
    )
    return _dedup_sorted(merged_planes, merged_w)


def sum_by_key_planes_2d(
    planes: tuple[jax.Array, ...], weights: jax.Array
) -> tuple[tuple[jax.Array, ...], jax.Array, jax.Array]:
    """Batched sum_by_key over S independent key-space buckets.

    planes: WK x (S, R) uint32; weights: (S, R) int32.  Each bucket row is
    grouped/deduped INDEPENDENTLY (callers partition the key space by
    hash bucket, so equal keys always share a row) — the analog of DSK's
    per-partition radix sort (SURVEY.md C4).

    Returns (uniq_planes (S, R) sentinel-padded with live keys compacted
    to the front of each row, counts (S, R), n_uniq (S,), wrapped —
    int32 flag: some bucket row's occurrence cumsum wrapped past 2^31
    (counts garbage, caller must raise; see _wrap_flag)).
    """
    WK = len(planes)
    S, R = planes[0].shape
    ops = planes + (weights.astype(jnp.int32),)
    sorted_ops = jax.lax.sort(ops, num_keys=WK, dimension=-1)
    skeys = sorted_ops[:WK]
    sweights = sorted_ops[WK]

    neq = jnp.zeros((S, R - 1), jnp.bool_)
    for w in range(WK):
        neq = neq | (skeys[w][:, 1:] != skeys[w][:, :-1])
    is_new = jnp.concatenate(
        [jnp.ones((S, 1), jnp.bool_), neq], axis=1
    )
    is_end = jnp.concatenate(
        [neq, jnp.ones((S, 1), jnp.bool_)], axis=1
    )
    csum = jnp.cumsum(sweights, axis=1)
    INT_MAX = jnp.int32(2**31 - 1)
    end_csum = jax.lax.cummin(
        jnp.where(is_end, csum, INT_MAX), axis=1, reverse=True
    )
    run_total = (end_csum - (csum - sweights)).astype(jnp.int32)

    is_sent = jnp.ones((S, R), jnp.bool_)
    for w in range(WK):
        is_sent = is_sent & (skeys[w] == SENTINEL)
    keep = is_new & ~is_sent

    idx = jnp.broadcast_to(jnp.arange(R, dtype=jnp.int32)[None, :], (S, R))
    ckey = jnp.where(keep, idx, R)
    ops2 = (ckey,) + skeys + (run_total,)
    sorted2 = jax.lax.sort(ops2, num_keys=1, dimension=-1)
    live = sorted2[0] < R
    uniq_planes = tuple(
        jnp.where(live, sorted2[1 + w], SENTINEL) for w in range(WK)
    )
    counts = jnp.where(live, sorted2[1 + WK], 0)
    n_uniq = jnp.sum(keep.astype(jnp.int32), axis=1)
    wrapped = jnp.max(_wrap_flag(csum[:, -1]))
    return uniq_planes, counts, n_uniq, wrapped


def count_batch_windows(batch: jax.Array, k: int) -> tuple[jax.Array, jax.Array, jax.Array]:
    """(B, L) code batch -> distinct canonical kmers + abundances (one shot)."""
    words, valid = extract_canonical(batch, k)
    B, nw, W = words.shape
    flat = words.reshape(B * nw, W)
    weights = valid.reshape(B * nw).astype(jnp.int32)
    return sum_by_key(flat, weights)


def histogram_from_counts(
    counts: jax.Array, n_uniq: jax.Array, nb_bins: int = 10000
) -> jax.Array:
    """hist[a] = #distinct kmers with abundance a, a in 1..nb_bins (clipped).

    Matches the reference's 10,000-bin histogram-over-all-distinct-kmers
    (fixture test/k27.histo; SURVEY.md C7/C12).  Index 0 is unused.
    """
    N = counts.shape[0]
    mask = jnp.arange(N) < n_uniq
    bins = jnp.where(mask, jnp.clip(counts, 1, nb_bins), 0)
    return jnp.zeros(nb_bins + 1, jnp.int32).at[bins].add(mask.astype(jnp.int32)).at[0].set(0)
