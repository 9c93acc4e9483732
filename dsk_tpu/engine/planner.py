"""Resource planner: input estimate -> passes / table capacity / batching.

The device re-design of gatb ConfigurationAlgorithm (SURVEY.md C5).  The
reference picks n_iters (passes) and n_partitions from estimated kmer
volume vs -max-memory/-max-disk (doc/paper.tex:66-67:
n_iters = ceil(v*b/D), n_p = ceil(v(b+32)/(0.7 n_iters M)), with
machine RAM/disk auto-detected, doc/human_log:3-4).

Here the budget is device memory (HBM for the distinct-kmer table + sort
scratch).  The number of distinct kmers is estimated by counting a small
SAMPLE of the bank (the analog of the reference's sampling-based
repartition, SURVEY.md C6) and extrapolating linearly — an overestimate
for high-coverage data, which errs toward more passes (safe).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from dsk_tpu.io.bank import Bank, open_bank
from dsk_tpu.kmer import codec

# Bytes of device memory consumed per table slot during a merge flush:
# (W words + count) * 4 bytes, times a scratch factor for lax.sort's
# operand copies (keys + payload, double-buffered).  SORT_SCRATCH_FACTOR,
# MAX_TABLE_SLOTS and the 5000 MB default -max-memory are carried over
# from a 16 GB device and have not been sized for the H100 (ROADMAP R2).
SORT_SCRATCH_FACTOR = 6
TABLE_FILL_TARGET = 0.8  # plan tables at 80% occupancy (hash-split jitter)
MAX_TABLE_SLOTS = 1 << 25  # per-chip table ceiling: prefer passes beyond it

# Per-chip per-pass OCCURRENCE budget: the flush accumulates run totals
# with an int32 cumsum whose total equals all k-mer occurrences seen on
# that chip in that pass (kmer/device.py _run_heads), so it must stay
# < 2^31.  This is the reference's own planning variable — n_iters is
# chosen from total k-mer VOLUME v, not from the distinct count
# (doc/paper.tex:66-67: n_iters = ceil(v*b/D); "~826719 MB of kmers",
# doc/human_log:4).  1.4e9 leaves ~1.53x headroom for hash-routing skew
# across chips; the device-side wrap guard (CountVolumeOverflow) is the
# backstop if skew exceeds it.
OCC_BUDGET_PER_CHIP_PASS = 1_400_000_000


@dataclass
class ResourcePlan:
    n_passes: int
    table_cap: int       # per chip, per pass (slots)
    flush_items: int     # pending windows before a merge flush
    buf_batches: int     # mesh-engine flush cadence (buffer ~ table size)
    batch_rows: int
    row_len: int
    est_bases: int
    est_distinct: int
    est_distinct_per_pass: int
    spill: bool = False      # host-side partition spill (dist/spill.py)
    n_partitions: int = 0    # spill hash partitions (spill mode only)

    def as_properties(self) -> dict:
        return {
            "nb_passes": self.n_passes,
            "table_cap": self.table_cap,
            "flush_items": self.flush_items,
            "buf_batches": self.buf_batches,
            "est_bases": self.est_bases,
            "est_distinct_kmers": self.est_distinct,
            "spill": self.spill,
            "nb_partitions": self.n_partitions,
        }


def sample_distinct_estimate(
    bank: Bank, k: int, total_windows: int, sample_bases: int = 2 << 20
) -> int:
    """Estimate total distinct kmers from a nested-prefix sample profile.

    Plain linear extrapolation of distinct/window from a small sample
    wildly overestimates for high-coverage data (the distinct curve
    saturates).  Two estimators run on the sample and the TIGHTER one
    wins (the linear-marginal one is an upper bound, so the min stays
    safe):

    - marginal rate: new-kmer rate over the last profile interval,
      linearly extrapolated (x1.2).  Still overestimates — for coverage data the
      rate keeps decaying after the sample — measured ~2x on a 50x
      synthetic bank, which doubles table_cap and the flush sort.
    - coverage fit: d(w) = G(1 - exp(-w/G)) + eps*w.  The saturating
      term is uniform coverage of an underlying genome of G distinct
      kmers; the linear term is the floor of NOVEL kmers per window
      (sequencing errors), which never saturates.  Fitted to FIVE
      nested prefix points (_PROFILE_FRACTIONS): two points leave the
      model under-determined — a (small G, large eps) corner passes
      through any two points and extrapolates linearly to ~4x over
      (measured on 20x-coverage 100 bp reads) — and three were
      unstable to thinning noise (round 3, PERF.md); the inner points'
      curvature rejects both.  A 1.15 safety factor covers fit and
      thinning noise.  Overflowing anyway is recoverable: the engine's
      typed-overflow auto-retry re-plans with more passes.

    Runs on the host (numpy): planning must never pay device compiles
    before the real engine is even built.
    """
    ws, ds = _host_distinct_profile(bank, k, sample_bases)
    if len(ws) < 2 or ws[-1] <= ws[-2]:  # sample covered everything: exact
        return ds[-1] if ds else 0
    s1, d1, s2, d2 = ws[-2], ds[-2], ws[-1], ds[-1]
    marginal = (d2 - d1) / max(s2 - s1, 1)
    est = d2 + marginal * max(0, total_windows - s2) * 1.2
    fit = _coverage_fit_estimate(ws, ds, total_windows)
    if fit is not None:
        est = min(est, fit * 1.15)
    return int(min(max(est, d2), total_windows))


def _coverage_fit_estimate(
    ws: list[int], ds: list[int], total: int
) -> float | None:
    """d(total) under d(w) = G(1-exp(-w/G)) + eps*w fitted to the
    nested-prefix points (ws, ds).  None when the points don't constrain
    the model (degenerate sample, or no G fits with eps >= 0)."""
    if len(ws) < 2 or ds[-1] <= 0 or min(ds) <= 0:
        return None
    w = np.asarray(ws, np.float64)
    d = np.asarray(ds, np.float64)
    if np.any(np.diff(d) < 0) or np.any(np.diff(w) <= 0):
        return None

    # G sweep: log grid from "everything saturates" to "nothing does".
    # For each G, eps is the least-squares residual slope over ALL
    # points; a fit is credible only if it passes through EVERY point
    # within tolerance (with >= 3 points this rejects the small-G/large-
    # eps corner that any 2 points admit).  Among credible fits take the
    # LARGEST extrapolation — the safe direction; the caller still
    # min()s against the marginal-linear upper bound.  Tolerance is
    # TIERED: thinning noise is ~0.2-0.5%, so when the model genuinely
    # fits, a 0.5% gate shrinks the credible spread ~25% (measured on
    # 20x-coverage data: max est 5.35M vs 7.04M at 2%, truth 5.0M); the
    # looser tier catches model mismatch without losing the bound.
    grid = np.geomspace(max(d[-1] / 2.0, 1.0), max(total * 64.0, 2.0), 192)
    rate = d[-1] / w[-1]
    for tol in (0.005, 0.02):
        best = None
        for G in grid:
            sat = G * (1.0 - np.exp(-w / G))
            eps = float(np.dot(w, d - sat) / np.dot(w, w))
            if eps < -0.01 * rate:  # saturating term overshoots the data
                continue
            pred = sat + eps * w
            if np.max(np.abs(pred - d) / d) > tol:
                continue
            est = G * (1.0 - np.exp(-total / G)) + max(eps, 0.0) * total
            if best is None or est > best:
                best = est
        if best is not None:
            return best
    return None


def _host_distinct_two_point(
    bank: Bank, k: int, limit_bases: int
) -> tuple[int, int, int, int]:
    """Back-compat view of _host_distinct_profile: (windows_half,
    distinct_half, windows_full, distinct_full)."""
    ws, ds = _host_distinct_profile(bank, k, limit_bases)
    if not ws:
        return 0, 0, 0, 0
    if len(ws) == 1:
        return ws[0], ds[0], ws[0], ds[0]
    return ws[-2], ds[-2], ws[-1], ds[-1]


# five nested prefixes: with only three, a single noisy point (hash
# thinning is ~0.3% at high factors) widened the credible-G set and the
# safe-direction max jumped non-monotonically with sample size
# (measured 1.87x true at a 256 Mbase sample vs 1.16x at 128 M on the
# 4 Gbase validation input; five points hold 1.16-1.21x at every size)
_PROFILE_FRACTIONS = (0.125, 0.25, 0.5, 0.75, 1.0)


def _host_distinct_profile(
    bank: Bank, k: int, limit_bases: int
) -> tuple[list[int], list[int]]:
    """Nested-prefix profile of a bank sample: (windows, distinct) at
    the _PROFILE_FRACTIONS points of the sampled prefix, host numpy.

    All sampled reads are concatenated with a single invalid separator
    (split-at-invalid semantics make windows never cross reads) so the
    whole sample is ONE vectorized canonical_windows sweep; the half-point
    measurement is a slice of the same arrays.  k > 32 shrinks the sample
    (the codec's multi-word path is python-int; estimates don't need
    scale).
    """
    parts: list[np.ndarray] = []
    sep = np.array([0xFF], dtype=np.uint8)
    seen = 0
    from dsk_tpu.io import native

    if native.available():
        # the native reader parses ~100x faster than the python path; rows
        # are (k-1)-halo chunks — windows on halos are seen twice, which
        # biases the two-point rate by < overlap fraction (irrelevant for
        # a capacity estimate).  Row width tracks the mean read length: a
        # fixed 4096 for 100 bp reads made the flattened sample 41x pad
        # (measured 100 s of sweep for 11.8M real bases, and the pad-
        # inflated length mis-sized the thinning factor 512x).
        from dsk_tpu.io.batch import batch_iterator

        _, mean_len = bank.estimate()
        want = max(int(mean_len) + 2, k + 1, 128)
        rl = 1 << int(np.ceil(np.log2(want)))
        rl = int(min(rl, 4096))
        for batch in batch_iterator(bank, max(k, 2), 256, rl):
            rows = batch.codes[: batch.n_rows]
            parts.append(
                np.concatenate(
                    [rows, np.full((rows.shape[0], 1), 0xFF, np.uint8)],
                    axis=1,
                ).reshape(-1)
            )
            seen += int(batch.n_bases)
            if seen >= limit_bases:
                break
    else:
        for _bank_id, seq in bank.iter_sequences():
            codes = codec.encode_bytes(seq.data)
            parts.append(codes)
            parts.append(sep)
            seen += codes.shape[0]
            if seen >= limit_bases:
                break
    if not parts:
        return [], []
    total = int(sum(p.shape[0] for p in parts))
    if total < k:
        return [], []
    bounds = [int(total * f) for f in _PROFILE_FRACTIONS]

    # Sweep PER PART (parts never share windows: each ends in a 0xFF
    # separator) with canonical-invariant 64-bit hash keys: any k in
    # O(log k) u64 passes, and a bounded working set that reuses heap
    # pages (fresh page faults run ~100 MB/s on this VM class — a single
    # full-sample sweep measured 38-57 s in round 2; see utils.hostmem).
    # Distinct counts use hash THINNING: every distinct key survives
    # keys < 2^64/factor with probability 1/factor independent of its
    # multiplicity, so distinct_total ~ factor * distinct(thinned) —
    # unbiased, ~1/sqrt(kept) relative error.  factor is sized from the
    # REAL sampled bases (`seen`), NOT the flattened part length: rows
    # are padded to the reader width, and pad once inflated factor 512x
    # (kept keys dropped to ~1k, the ~3-4% noise tripped the coverage
    # fit's residual gate, and the planner fell back to the 5x-over
    # marginal estimate — measured on 100 bp reads).  Target ~2M kept
    # key OCCURRENCES: <= 16 MB working set, and kept-distinct noise
    # <= ~0.5% whenever the distinct rate is >= a few percent.  Exact
    # (factor=1) below 2M sampled bases, where tests and tiny inputs
    # live.
    factor = 1
    while factor < 4096 and seen > factor * (2 << 20):
        factor *= 2
    thresh = np.uint64((1 << 64) - 1) // np.uint64(factor)
    nq = len(bounds)

    def sweep(part: np.ndarray, off: int):
        keys, okv = codec.hash_canonical_windows(part, k)
        pos = np.arange(okv.shape[0], dtype=np.int64)
        # window counts stay EXACT (they are the marginal-rate
        # denominators); only the distinct sets are thinned
        sel = okv if factor == 1 else okv & (keys <= thresh)
        wins, kept = [], []
        for b in bounds:
            inq = pos < b - off
            wins.append(int((okv & inq).sum()))
            kept.append(keys[sel & inq])
        return wins, kept

    offsets = np.concatenate(
        [[0], np.cumsum([p.shape[0] for p in parts])]
    )[:-1]
    # SERIAL sweep over the SMALL per-batch parts, on purpose (measured
    # on this VM class, 12M-base sample, cold process):
    #   * small parts, serial:        0.46 s   <- this
    #   * small parts, 4 threads:     5.6 s  (lock churn + cold arenas)
    #   * 1.9M-row chunks, serial:   18.8 s  (first-touch of each ~10 MB
    #     temp stalls ~1 ms/page cold; same chunks re-swept: 1.0 s)
    #   * 1.9M-row chunks, 4 threads: 12.5 s
    # Small parts keep every doubling-level temp ~2 MB, so the whole
    # sweep reuses one warmed heap footprint.  See utils.hostmem.
    results = [
        sweep(part, int(off))
        for part, off in zip(parts, offsets)
        if part.shape[0] >= k
    ]
    if not results:
        return [], []
    ws = [sum(r[0][q] for r in results) for q in range(nq)]
    ds = [
        int(np.unique(np.concatenate([r[1][q] for r in results])).shape[0])
        * factor
        for q in range(nq)
    ]
    # drop degenerate leading points (empty quantiles on tiny samples)
    keep = [q for q in range(nq) if ws[q] > 0]
    return [ws[q] for q in keep], [ds[q] for q in keep]


_WIRE_RATES: tuple[float, float] | None = None


def _wire_rates() -> tuple[float, float]:
    """Measured (D2H, H2D) MB/s to the default device, cached per
    process.  The spill-vs-passes decision needs REAL transfer costs
    (VERDICT r3 next-item 1): a slow link makes passes cheaper, a fast
    one spill.  DSK_TPU_SPILL_RATES="d2h_mbps,h2d_mbps" overrides (pins
    experiments).  The 1 MB round-trip probe is kept from the previous
    platform; ROADMAP D-tunnel replaces it."""
    global _WIRE_RATES
    if _WIRE_RATES is not None:
        return _WIRE_RATES
    import os

    env = os.environ.get("DSK_TPU_SPILL_RATES")
    if env:
        d2h, h2d = (float(x) for x in env.split(","))
        _WIRE_RATES = (d2h, h2d)
        return _WIRE_RATES
    import time

    import jax

    dev = jax.devices()[0]
    # incompressible payload: a compressing link would report a fake
    # rate for all-zeros
    buf = np.random.default_rng(0).integers(
        0, 2**32, size=(1 << 18,), dtype=np.uint32
    )  # 1 MB
    x = jax.device_put(buf, dev)
    _ = np.asarray(x)  # warmup: settles the reverse channel
    # a full fetch is the only compile-free fence, so each probe
    # measures ONE ROUND
    # TRIP of a FRESH array (re-fetching the same jax.Array returns its
    # cached _npy_value in microseconds and would report a fake memcpy
    # rate).  The per-direction split is not observable without a
    # compiled fence, so both rates report the round-trip-halved figure
    # — the spill cost model only ever uses their SUM (1/d2h + 1/h2d =
    # bytes * t_round), which this keeps exact.
    best = float("inf")
    for _rep in range(2):
        fresh = buf + np.uint32(_rep + 1)
        t0 = time.perf_counter()
        y = jax.device_put(fresh, dev)
        _ = np.asarray(y)
        best = min(best, max(time.perf_counter() - t0, 1e-9))
    half = 2.0 / best  # MB/s at 1 MB payload, per direction
    _WIRE_RATES = (half, half)
    return _WIRE_RATES


def _round_capacity(x: int) -> int:
    """Round a slot count up to the {2^n, 3*2^(n-1)} grid (>= 2^16).

    Pure pow2 rounding over-provisions up to 2x — the flush sorts
    (buffer + table) rows, so table slack is paid on EVERY flush.  The
    half-step grid caps the waste at 33% while keeping the set of
    compiled program shapes small (the persistent cache is per-shape).  Every point is a
    multiple of 2^15, so bucketized flushes (capb = cap/S) and lane
    tiling stay exact."""
    x = max(int(x), 1 << 16)
    n = int(np.ceil(np.log2(x)))
    for cand in (3 << (n - 2), 1 << n):
        if cand >= x:
            return cand
    return 1 << (n + 1)  # unreachable (2^n >= x by construction)


def plan_resources(
    bank: Bank | str,
    k: int,
    max_memory_mb: int = 5000,
    n_chips: int = 1,
    batch_rows: int = 0,
    row_len: int = 0,
    sample: bool = True,
    spill: str = "auto",
    max_disk_mb: int = 0,
    per_bank: bool = False,
) -> ResourcePlan:
    """batch_rows/row_len == 0: auto-size the batch geometry.  Rows are
    read chunks, so row_len tracks the MEAN READ LENGTH (a fixed 256 for
    100 bp reads wastes ~60% of window slots as padding); batch_rows then
    targets ~2M windows per batch on an accelerator (big fused batches
    amortize the per-dispatch cost) and 256K on the CPU."""
    from dsk_tpu.utils.hostmem import tune_malloc

    tune_malloc()  # sampling sweeps allocate ~100 MB temps; see hostmem
    if isinstance(bank, str):
        bank = open_bank(bank)
    W = codec.words_per_kmer(k)
    est_bases, mean_len = bank.estimate()

    if row_len <= 0:
        # Readers PACK short reads into shared rows (one 0xFF separator
        # each; io/batch.py), so wide rows win at every read length: the
        # only per-row waste is the sub-read-length tail.  1024 keeps the
        # valid-window fraction near its packing ceiling (1 - (k-1)/(len
        # + 1)) for 100 bp Illumina reads AND bounds halo overhead to
        # (k-1)/1024 for long reads.  Shrink only when the whole input is
        # tiny (CPU tests) so batches stay at least a few rows tall.
        row_len = 1024
        while row_len > 128 and est_bases < 4 * row_len * 64:
            row_len //= 2
    if batch_rows <= 0:
        from dsk_tpu.utils.devices import on_accelerator

        target_windows = (2 << 20) if on_accelerator() else (1 << 18)
        nw0 = max(row_len - k + 1, 1)
        batch_rows = int(np.clip(round(target_windows / nw0), 256, 8192))
        # multiples of 256 rows: few distinct batch shapes, so few
        # compiled programs across inputs
        batch_rows = -(-batch_rows // 256) * 256
    est_windows = max(est_bases - int(est_bases / max(mean_len, k)) * (k - 1), 1)

    import time as _time

    t_sample0 = _time.perf_counter()
    sample_bases = 0
    if sample and est_bases > (1 << 22):
        # the marginal new-kmer rate only drops once the sample spans a few
        # coverage multiples of the underlying genome — sample ~1/8th of
        # the input (capped) rather than a fixed prefix.  The cap is
        # 128 Mbases: at the old 32 M cap a 4 Gbase / 64 Mbase-genome run
        # sampled 0.5x coverage, the credible-fit range stayed wide, and
        # the safe-direction estimate ran 31% over (88.3M vs 67.1M true
        # — one extra pass).  A 128 M sample costs ~5 s host sweep and
        # covers 2x, which collapses the fit spread (PERF.md round 3).
        sample_bases = int(min(max(est_bases // 8, 2 << 20), 128 << 20))
        est_distinct = sample_distinct_estimate(
            bank, k, est_windows, sample_bases=sample_bases
        )
    else:
        est_distinct = est_windows  # upper bound, no sampling needed/worth it

    slot_bytes = (W + 1) * 4 * SORT_SCRATCH_FACTOR
    budget_slots = max(
        (max_memory_mb << 20) // slot_bytes // max(n_chips, 1), 1 << 16
    )
    # cap the per-chip table: beyond this, extra passes beat giant sorts
    # (compile time and flush latency both scale with the table; the
    # 2-bit batch cache makes re-reads cheap — reference n_iters design)
    budget_slots = min(budget_slots, MAX_TABLE_SLOTS)
    per_chip_distinct = -(-est_distinct // max(n_chips, 1))
    n_passes = max(
        1, -(-per_chip_distinct // int(budget_slots * TABLE_FILL_TARGET))
    )
    # volume constraint (reference n_iters semantics): per-chip per-pass
    # occurrences ~ total windows / n_chips / n_passes must fit the
    # int32 flush accumulator
    per_chip_occ = -(-est_windows // max(n_chips, 1))
    n_passes = max(n_passes, -(-per_chip_occ // OCC_BUDGET_PER_CHIP_PASS))
    per_pass = -(-per_chip_distinct // n_passes)
    table_cap = _round_capacity(int(per_pass / TABLE_FILL_TARGET) + 1)
    table_cap = min(table_cap, budget_slots * 2)
    flush_items = min(max(table_cap, 1 << 20), 1 << 23)
    # mesh-engine flush cadence: with the two-stage flush compaction the
    # flush is near-linear in rows, so big groups win by amortizing the
    # table re-sort; beyond ~64M flush rows the flat key sort's
    # super-linearity and sort scratch take over (a previous-chip
    # optimum, to be re-swept on the H100: ROADMAP S3e).  Clip the group
    # so one flush sorts at most TARGET_FLUSH_ROWS.
    windows_per_batch = max(batch_rows * (row_len - k + 1), 1)
    TARGET_FLUSH_ROWS = 64 << 20
    buf_batches = int(
        np.clip(
            (TARGET_FLUSH_ROWS - table_cap) // windows_per_batch, 8, 64
        )
    )

    # -- spill vs passes (VERDICT r3 next-item 1) -------------------------
    # The reference bounds memory by spilling routed kmers to disk and
    # bounds disk by passes: n_iters = ceil(v*b/D) (doc/paper.tex:66).
    # Here HBM tables are FASTER when the distinct volume fits (no
    # D2H/H2D round trip), so spill engages only when it saves re-streams
    # AND the measured wire cost of the spilled bytes is below the cost
    # of the extra passes it avoids.  spill="on"/"off" pins the mode.
    use_spill = False
    n_partitions = 0
    if spill == "on" or (spill == "auto" and n_passes > 1):
        # per-bank spill records carry the bank id as an extra key word,
        # and a kmer may occupy one (kmer, bank) row PER BANK — size the
        # record bytes and the partition count for that worst case (an
        # under-split partition only costs a modulus-doubling split)
        nb = max(getattr(bank, "nb_banks", 1), 1) if per_bank else 1
        rec_bytes = (W + 1 + (1 if per_bank else 0)) * 4
        est_rows = est_distinct * nb
        if max_disk_mb > 0:
            disk_bytes = max_disk_mb << 20
        else:
            from dsk_tpu.utils import sysinfo

            disk_bytes = sysinfo.auto_limits()["max_disk_mb"] << 20
        # per-pass spill is bounded by the pre-dedup window volume (the
        # group dedup only shrinks it), so DSK's own pass rule applies.
        # Spill's share of -max-disk is 3/4: the multipass batch cache
        # holds the other 1/4 (engine _count_spilled splits the same way)
        spill_bytes = est_windows * rec_bytes
        n_passes_spill = max(
            1, -(-spill_bytes // max(disk_bytes * 3 // 4, 1))
        )
        spill_cap = min(budget_slots, MAX_TABLE_SLOTS)
        spill_cap = _round_capacity(spill_cap // 2 + 1)
        per_pass_spill = -(-est_rows // n_passes_spill)
        n_partitions = int(
            np.clip(
                -(-per_pass_spill // int(spill_cap * TABLE_FILL_TARGET)),
                max(n_chips, 1),
                8192,
            )
        )
        if spill == "on":
            use_spill = True
        elif n_passes_spill < n_passes:
            # measured-cost comparison: a pass costs one re-stream of the
            # input (rate measured from this plan's own sampling sweep —
            # parse+hash, conservative); spill costs the record bytes
            # over the measured D2H + H2D wire once
            t_sample = max(_time.perf_counter() - t_sample0, 1e-9)
            restream = (
                sample_bases / t_sample if sample_bases else 20e6
            )  # bases/s
            d2h_mbps, h2d_mbps = _wire_rates()
            wire_s = (spill_bytes / (1 << 20)) * (
                1.0 / d2h_mbps + 1.0 / h2d_mbps
            )
            cost_hbm = n_passes * (est_bases / restream)
            cost_spill = n_passes_spill * (est_bases / restream) + wire_s
            use_spill = cost_spill < cost_hbm
        if use_spill:
            n_passes = n_passes_spill
            table_cap = spill_cap
            per_pass = per_pass_spill
            buf_batches = int(
                np.clip(
                    (TARGET_FLUSH_ROWS - table_cap) // windows_per_batch,
                    8, 64,
                )
            )
        else:
            n_partitions = 0

    return ResourcePlan(
        n_passes=n_passes,
        table_cap=table_cap,
        flush_items=flush_items,
        buf_batches=buf_batches,
        batch_rows=batch_rows,
        row_len=row_len,
        est_bases=est_bases,
        est_distinct=est_distinct,
        est_distinct_per_pass=per_pass,
        spill=use_spill,
        n_partitions=n_partitions,
    )
