"""Device proof of the int32 occurrence-volume wrap guard.

The device-side cumsum wrap guard (kmer/device.py, CountVolumeOverflow)
was VERDICT r2 weak #1 and until now was proven only by a CPU unit test
with a crafted near-2^31 table (tests/test_volume_guard.py).  This run
forces a 1-pass plan over the 4.1 Gbase validation input (4.42e9 kmer
occurrences on ONE chip in one pass — 2.06x the int32 ceiling), so the
guard MUST fire mid-stream on the device; the retry valve then
doubles passes until the volume fits (1 -> 2 wraps again at 2.2e9 ->
4 clean), and the final store must be value-identical to the clean
run A store from scripts/validate_gbase.py.

Run AFTER validate_gbase.py --bases 4096 --genome-mb 64 (reuses its
input and run-A store): python scripts/volume_guard.py
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(msg: str) -> None:
    print(f"[volguard] {msg}", file=sys.stderr, flush=True)


def main() -> int:
    from dsk_tpu.utils.hostmem import tune_malloc

    tune_malloc()

    import jax

    from validate_gbase import work_dir

    dev = jax.devices()[0]
    log(f"device: {dev.device_kind} ({dev.platform})")

    tag_dir = work_dir(4096)
    fasta = os.path.join(tag_dir, "input.fasta")  # round-3 artifact name
    if not os.path.exists(fasta):
        fasta = os.path.join(tag_dir, "input_g64M.fasta")  # keyed name
    ref_store = os.path.join(tag_dir, "a.dsk")
    if not (os.path.exists(fasta) and os.path.exists(ref_store)):
        log("missing validate_gbase artifacts; run it first")
        return 2

    import dsk_tpu.engine.run as runmod
    from dsk_tpu.engine.run import RunParams, execute

    # --mode table: force a 1-pass plan at the planner cap — the TABLE
    #   overflows first (67.1M distinct >> 33.5M cap) and the valve
    #   ladders 1 -> 2 -> 4.
    # --mode volume (default): force a 1-pass plan WITH a 96M-slot cap —
    #   the 67.1M distinct now FIT the table, but the pass's 3.37e9
    #   window occurrences exceed the int32 cumsum ceiling (wrap at 64%
    #   of the stream), so the only guard that can fire is the
    #   device-side wrap detector (CountVolumeOverflow); the valve
    #   doubles to 2 passes (1.68e9 occ, 33.5M distinct each) and
    #   finishes clean.  (A first attempt forced passes=2/cap=48M and
    #   finished clean at 2 — 1.68e9 occ per pass is BELOW the ceiling;
    #   occurrences are windows, not bases.)
    mode = "volume"
    if "--mode" in sys.argv:
        mode = sys.argv[sys.argv.index("--mode") + 1]

    orig = runmod.plan_resources

    def plan(*a, **kw):
        p = orig(*a, **kw)
        if mode == "table":
            log(f"plan said passes={p.n_passes}; FORCING 1 "
                f"(table must overflow first)")
            p.n_passes = 1
        else:
            log(f"plan said passes={p.n_passes} cap={p.table_cap}; "
                f"FORCING passes=1 cap=96M (3.37e9 windows > 2^31 but "
                f"67.1M distinct < cap: only the volume wrap guard "
                f"can fire)")
            p.n_passes = 1
            p.table_cap = 3 << 25
        return p

    runmod.plan_resources = plan
    t0 = time.perf_counter()
    try:
        out = execute(RunParams(
            file=fasta, kmer_size=31, abundance_min=3,
            out=os.path.join(tag_dir, "vg"), verbose=2, histo=1,
            max_memory=2600, checkpoint=False, max_retries=4,
        ))
    finally:
        runmod.plan_resources = orig
    wall = time.perf_counter() - t0
    final_passes = out.info["config"]["nb_passes"]
    log(f"DONE in {wall:.0f}s: n_solid={out.n_solid} "
        f"final passes={final_passes}")

    from validate_gbase import compare_stores
    same_hist, same_tab, rows = compare_stores(ref_store, out.store_path)
    forced = 1
    result = {
        "gate": f"volume_guard_4gbase_{mode}",
        "guard_fired": final_passes > forced,  # valve ran past the forced plan
        "final_passes": final_passes,
        "wall_s": round(wall, 1),
        "histogram_identical": same_hist,
        "table_identical": same_tab,
        "rows": rows,
    }
    print(json.dumps(result))
    ok = result["guard_fired"] and same_hist and same_tab
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
