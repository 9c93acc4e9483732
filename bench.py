"""Benchmark: sustained k-mer counting throughput on one card.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

Headline metric (BASELINE.json): bases/s/chip at k=31 through the full
device pipeline (extract canonical windows -> sort -> segment-reduce ->
running-table merge), on synthetic random reads resident in host memory
(the host->device transfer is included; FASTA parsing is not — the CPU
reference baseline 2.2 Mbases/s (doc/human_log, SURVEY.md section 6) is
HDD-bound, ours is compute-bound).

vs_baseline = bases/s divided by the reference's single-thread CPU figure
(2.2e6 bases/s, derived in SURVEY.md section 6).
"""

from __future__ import annotations

import json
import time

import numpy as np

CPU_BASELINE_BASES_PER_S = 2.2e6  # DSK 1-thread human-genome run, SURVEY.md §6


GENOME_SIZE = 1 << 20  # 1 Mbase synthetic genome; reads sampled from it
                       # (matches the shape of the read50x fixture: random
                       # genome + uniform read sampling => bounded distinct
                       # kmers, realistic duplicate structure)


def make_batches(n_batches: int, rows: int, row_len: int, seed: int = 0):
    from dsk_tpu.io.batch import Batch

    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=GENOME_SIZE, dtype=np.uint8)
    out = []
    for _ in range(n_batches):
        starts = rng.integers(0, GENOME_SIZE - row_len, size=rows)
        codes = genome[starts[:, None] + np.arange(row_len)[None, :]]
        out.append(
            Batch(
                codes=codes,
                bank_ids=np.zeros(rows, np.int32),
                n_rows=rows,
                n_bases=int(codes.size),
                n_reads=rows,
            )
        )
    return out


def make_error_batches(
    n_batches: int, rows: int, row_len: int, err: float, seed: int = 0
):
    """Error-rich reads: genome sampling + per-base random substitutions.

    The headline stream's distinct/window ratio is ~0.8% (clean reads of
    a 1 Mbase genome); real error-rich Illumina runs >= 3% (reference
    human: 4.8B distinct / ~146 Gbases, doc/human_log:18-23 — VERDICT r3
    weak #3).  A substitution at rate e mints ~e*k novel kmers per base,
    so e ~ 0.11% at k=31 pushes the ratio past 4% — the flush-output-
    pressure regime where the table holds mostly singletons."""
    from dsk_tpu.io.batch import Batch

    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=GENOME_SIZE, dtype=np.uint8)
    out = []
    for _ in range(n_batches):
        starts = rng.integers(0, GENOME_SIZE - row_len, size=rows)
        codes = genome[starts[:, None] + np.arange(row_len)[None, :]]
        hit = rng.random(codes.shape) < err
        # substitution = +1..3 mod 4: never the original base
        codes = np.where(
            hit,
            (codes + rng.integers(1, 4, codes.shape, dtype=np.uint8)) % 4,
            codes,
        ).astype(np.uint8)
        out.append(
            Batch(
                codes=codes,
                bank_ids=np.zeros(rows, np.int32),
                n_rows=rows,
                n_bases=int(codes.size),
                n_reads=rows,
            )
        )
    return out


def main() -> None:
    global GENOME_SIZE

    import sys as _sys

    import jax

    from dsk_tpu.utils.hostmem import tune_malloc

    tune_malloc()

    from dsk_tpu.dist.engine import DistCountEngine, default_mesh

    # --smoke: tiny shapes for a CPU code-path check (every engine and
    # section runs; the numbers are meaningless).  The driver's real
    # bench runs the full shapes on the chip.
    smoke = "--smoke" in _sys.argv
    k = 31
    if smoke:
        GENOME_SIZE = 1 << 16
        rows, row_len = 256, 256
        n_batches = 8
    else:
        rows, row_len = 2048, 1024
        n_batches = 64  # 2 groups of 32: ~134 Mbases

    # the static-shape engine: ONE fused step program per flush group
    # (lax.scan of buf_batches route steps + the flush merge).  G32 and
    # a distinct-sized 1.5M cap come from a geometry sweep on the
    # previous chip (scripts/measure_group_geometry.py re-sweeps them).
    G_main = 4 if smoke else 32
    cap_main = (1 << 16) if smoke else (1 << 20) + (1 << 19)
    engine = DistCountEngine(
        k,
        mesh=default_mesh(),
        batch_rows=rows,
        row_len=row_len,
        buf_batches=G_main,  # buffer ~27x table: flush re-sort amortized
        table_cap=cap_main,
    )
    import sys

    engine.compile(progress=lambda m: print(f"[bench] {m}", file=sys.stderr))
    warm = make_batches(2, rows, row_len, seed=99)
    engine.count_stream(iter(warm), finalize=False)  # warm execution path

    batches = make_batches(n_batches, rows, row_len, seed=0)
    total_bases = sum(b.n_bases for b in batches)
    # timed: the full device pipeline (extract -> append -> flush merges ->
    # histogram), H2D included.  The solid-table download is timed
    # separately.  Best of three runs.
    # exc wire format (io/packed.py): 2-bit code words + 2(1+E) B/row
    # meta + 4 B/row bank ids ~= 2.30 bits/base at row_len 1024
    from dsk_tpu.io.packed import EXC_E

    wire_bits_per_base = 2 + (2 * (1 + EXC_E) + 4) * 8 / row_len
    wire_mb = total_bases * wire_bits_per_base / 8 / (1 << 20)

    res = None
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        res = engine.count_stream(iter(batches), finalize=False)
        runs.append(round(time.perf_counter() - t0, 3))
    elapsed = min(runs)
    n_distinct = int(res.info["n_distinct_device"])

    # device ceiling: fenced step reps on device-resident groups (H2D
    # excluded)
    import jax.numpy as jnp
    from dsk_tpu.io.packed import pack_codes_exc

    d0 = jax.devices()[0]
    grp = batches[:G_main]  # one flush group (buf_batches)
    ws, ms = zip(*(pack_codes_exc(b.codes) for b in grp))
    cd = jax.device_put(np.stack(ws), d0)
    md = jax.device_put(np.stack(ms), d0)
    bd = jax.device_put(np.stack([b.bank_ids for b in grp]), d0)
    st = engine._init_state()
    jax.block_until_ready(cd)
    ps = jnp.int32(0)
    tab_p, tab_c, over, tover = st
    step_best = float("inf")
    for rep in range(3):
        t0 = time.perf_counter()
        tab_p, tab_c, over, tover = engine._step(
            cd, md, bd, tab_p, tab_c, over, tover, ps
        )
        jax.block_until_ready(over)
        if rep:  # first exec excluded
            step_best = min(step_best, time.perf_counter() - t0)
    group_bases = sum(b.n_bases for b in grp)
    device_bases_per_s = group_bases / step_best

    t1 = time.perf_counter()
    kmers, counts, _ = engine.gather_tables()
    gather_s = time.perf_counter() - t1
    assert kmers.shape[0] == n_distinct

    def fenced_ceiling(eng, cd_, md_, bd_, passes=(0,)):
        """Fenced device-resident step reps: bases/s with the H2D wire
        excluded.  Each pass gets
        FRESH tables (multipass semantics: per-pass tables are
        re-initialized; the init fill is part of the timed cost)."""
        best = float("inf")
        checks = []
        for rep in range(3):
            t0 = time.perf_counter()
            checks = []
            for ps_ in passes:
                tab_p, tab_c, over, tover = eng._init_state()
                tab_p, tab_c, over, tover = eng._step(
                    cd_, md_, bd_, tab_p, tab_c, over, tover,
                    jnp.int32(ps_),
                )
                checks.append((over, tover))
            jax.block_until_ready(checks[-1][0])
            if rep:
                best = min(best, time.perf_counter() - t0)
        for over, tover in checks:  # near-capacity shapes must finish
            eng._check_overflow(over, tover)  # clean, no slack loss
        return best

    # --- k=63 device ceiling (BASELINE config 4: large-k multi-word
    # kmers, W=4).  Same packed group (packed codes are k-independent);
    # 16 batches per group.
    G63 = 2 if smoke else 16
    engine63 = DistCountEngine(
        63,
        mesh=default_mesh(),
        batch_rows=rows,
        row_len=row_len,
        buf_batches=G63,
        table_cap=cap_main,
    )
    engine63.compile(
        progress=lambda m: print(f"[bench k63] {m}", file=sys.stderr)
    )
    cd16, md16, bd16 = cd[:G63], md[:G63], bd[:G63]
    jax.block_until_ready(cd16)
    k63_bases = sum(b.n_bases for b in grp[:G63])
    t63 = fenced_ceiling(engine63, cd16, md16, bd16)
    k63_device_bases_per_s = k63_bases / t63

    # --- multipass near-capacity device ceiling (VERDICT r2 weak #6:
    # the comfortable single-pass 0.7-fill shape was the only bench).
    # 1.4 Mbase genome => ~1.35M distinct, ~0.67M per pass at
    # n_passes=2 vs a 0.75M cap = ~0.9 fill: the two-stage compaction
    # slack valve is live, and both pass filters run.
    saved_genome = GENOME_SIZE
    # 1.44 Mbase genome => 1,441,7xx distinct, ~721K per pass vs the
    # 786,432 cap = 0.92 fill (measured split jitter ~±900; the first
    # attempt at 1.57 Mbases landed pass 1 at 786,905 — 473 OVER cap)
    GENOME_SIZE = (1 << 17) if smoke else (1 << 20) + (3 << 17)
    mp_batches = make_batches(G_main, rows, row_len, seed=7)
    GENOME_SIZE = saved_genome
    engine_mp = DistCountEngine(
        k,
        mesh=default_mesh(),
        batch_rows=rows,
        row_len=row_len,
        buf_batches=G_main,
        table_cap=(1 << 17) if smoke else 768 << 10,
        n_passes=2,
    )
    engine_mp.compile(
        progress=lambda m: print(f"[bench mp] {m}", file=sys.stderr)
    )
    wsm, msm = zip(*(pack_codes_exc(b.codes) for b in mp_batches))
    cdm = jax.device_put(np.stack(wsm), d0)
    mdm = jax.device_put(np.stack(msm), d0)
    bdm = jax.device_put(
        np.stack([b.bank_ids for b in mp_batches]), d0
    )
    jax.block_until_ready(cdm)
    mp_bases = sum(b.n_bases for b in mp_batches)
    t_mp = fenced_ceiling(engine_mp, cdm, mdm, bdm, passes=(0, 1))
    # both passes over the same bases = one logical multipass count
    mp_device_bases_per_s = mp_bases / t_mp

    # --- adversarial high-distinct shape (VERDICT r3 next-item 3): one
    # G32 group of 0.11%-error reads => ~4% distinct/window (the
    # reference human run's regime, doc/human_log:18-23) vs the headline
    # stream's 0.8%.  Table is singleton-dominated, flush output
    # pressure is worst-case; fenced ceiling + distinct rate recorded.
    adv_batches = make_error_batches(
        G_main, rows, row_len, err=0.0011, seed=3
    )
    engine_adv = DistCountEngine(
        k,
        mesh=default_mesh(),
        batch_rows=rows,
        row_len=row_len,
        buf_batches=G_main,
        table_cap=(1 << 17) if smoke else 3 << 21,  # ~2x headroom over
        # the ~3.5M worst-case distinct of this shape: an overflow here
        # would abort the driver's whole bench run
    )
    engine_adv.compile(
        progress=lambda m: print(f"[bench adv] {m}", file=sys.stderr)
    )
    wsa, msa = zip(*(pack_codes_exc(b.codes) for b in adv_batches))
    cda = jax.device_put(np.stack(wsa), d0)
    mda = jax.device_put(np.stack(msa), d0)
    bda = jax.device_put(
        np.stack([b.bank_ids for b in adv_batches]), d0
    )
    jax.block_until_ready(cda)
    adv_bases = sum(b.n_bases for b in adv_batches)
    t_adv = fenced_ceiling(engine_adv, cda, mda, bda)
    # distinct count + windows of the adversarial shape (one extra run
    # into fresh tables, histogram on device)
    tab_p_a, tab_c_a, over_a, tover_a = engine_adv._init_state()
    tab_p_a, tab_c_a, over_a, tover_a = engine_adv._step(
        cda, mda, bda, tab_p_a, tab_c_a, over_a, tover_a, jnp.int32(0)
    )
    engine_adv._check_overflow(over_a, tover_a)
    adv_hist = np.asarray(engine_adv._hist(tab_c_a), dtype=np.int64)
    adv_distinct = int(adv_hist[1:].sum())
    adv_windows = G_main * rows * (row_len - k + 1)
    adv_device_bases_per_s = adv_bases / t_adv

    bases_per_s = total_bases / elapsed
    result = {
        "metric": "count_bases_per_s_per_chip_k31",
        "value": round(bases_per_s, 1),
        "unit": "bases/s",
        "vs_baseline": round(bases_per_s / CPU_BASELINE_BASES_PER_S, 2),
        "detail": {
            "platform": jax.devices()[0].platform,
            "device_kind": jax.devices()[0].device_kind,
            "device_count": len(jax.devices()),
            "total_bases": total_bases,
            "elapsed_s": round(elapsed, 3),
            "stream_runs_s": runs,
            # implied H2D rate of the streamed runs (exc-packed payload
            # is ~2.3 bits/base)
            "wire_mb_per_s": round(wire_mb / elapsed, 1),
            "n_distinct": n_distinct,
            "distinct_kmers_per_s": round(n_distinct / elapsed, 1),
            "table_download_s": round(gather_s, 3),
            "device_bases_per_s": round(device_bases_per_s, 1),
            # BASELINE config 4 (large-k): k=63 W=4 fenced device ceiling
            "k63_device_bases_per_s": round(k63_device_bases_per_s, 1),
            "k63_vs_baseline": round(
                k63_device_bases_per_s / CPU_BASELINE_BASES_PER_S, 2
            ),
            # near-capacity 2-pass shape (both pass filters + the
            # two-stage compaction slack valve live, ~0.9 table fill)
            "multipass2_device_bases_per_s": round(
                mp_device_bases_per_s, 1
            ),
            # adversarial error-rich shape (>= 3% distinct/window — the
            # reference human-run regime, doc/human_log:18-23).  The
            # distinct rate is judged against the reference's derived
            # ~42K solid kmers/s emission (BASELINE.md): target >= 10x.
            "adversarial_device_bases_per_s": round(
                adv_device_bases_per_s, 1
            ),
            "adversarial_distinct": adv_distinct,
            "adversarial_distinct_ratio": round(
                adv_distinct / adv_windows, 4
            ),
            "adversarial_distinct_kmers_per_s": round(
                adv_distinct / t_adv, 1
            ),
            "adversarial_distinct_rate_vs_ref42k": round(
                adv_distinct / t_adv / 42e3, 1
            ),
            "end_to_end_bases_per_s": round(
                total_bases / (elapsed + gather_s), 1
            ),
        },
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
