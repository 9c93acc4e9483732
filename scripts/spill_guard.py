"""Spill-mode validation on the device (VERDICT r3 next-item 1 gate).

Demonstrates on the accelerator that host-side partition spill breaks the
HBM<->passes coupling: a run whose per-chip table is forced down to
~4M slots — which the table engine can only satisfy with a ~20-pass
ladder over this input — completes in <= 2 input passes under spill
(DSK's fixed-memory contract: doc/paper.tex:71-91, 7 passes x 86
partitions in 4 GB for a human genome, doc/human_log:4), with histogram
AND full solid table identical to a reference run of the normal table
engine.

Legs:
  ref    normal table engine, planner-chosen plan (the trusted result)
  spill  -spill on, -max-memory shrunk so table_cap ~ 4M slots; gate:
         nb_passes <= 2 AND store identity vs ref

Run: python scripts/spill_guard.py
       [--bases 4096] [--genome-mb 64] [--max-memory-spill 288]
Reuses <tmp>/gbase<bases>/input_g<G>M.fasta (validate_gbase.py's
generator) and writes stores next to it.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def log(msg: str) -> None:
    print(f"[spill_guard] {msg}", file=sys.stderr, flush=True)


def main() -> int:
    from dsk_tpu.utils.hostmem import tune_malloc

    tune_malloc()

    import validate_gbase as vg

    total_mb = 4096
    if "--bases" in sys.argv:
        total_mb = int(sys.argv[sys.argv.index("--bases") + 1])
    genome_mb = 64
    if "--genome-mb" in sys.argv:
        genome_mb = int(sys.argv[sys.argv.index("--genome-mb") + 1])
    mem_spill = 288  # MB -> ~4.2M table slots at W=2 (planner slot_bytes)
    if "--max-memory-spill" in sys.argv:
        mem_spill = int(sys.argv[sys.argv.index("--max-memory-spill") + 1])

    vg.GENOME_MB = genome_mb
    tag_dir = vg.work_dir(total_mb)
    os.makedirs(tag_dir, exist_ok=True)
    fasta = f"{tag_dir}/input_g{genome_mb}M.fasta"
    legacy = f"{tag_dir}/input.fasta"
    if genome_mb == 64 and os.path.exists(legacy):
        fasta = legacy

    import jax

    dev = jax.devices()[0]
    log(f"device: {dev.device_kind} ({dev.platform})")

    vg.gen_input(fasta, total_mb)

    from dsk_tpu.engine.run import RunParams, execute

    results = {}

    def run(tag: str, **kw):
        t0 = time.perf_counter()
        out = execute(RunParams(
            file=fasta, kmer_size=31, abundance_min=3,
            out=f"{tag_dir}/{tag}", verbose=2, histo=1, **kw,
        ))
        wall = time.perf_counter() - t0
        info = out.info
        log(
            f"[{tag}] DONE in {wall:.0f}s: n_solid={out.n_solid} "
            f"passes={info['config']['nb_passes']} "
            f"spill={info['config'].get('spill')} "
            f"partitions={info['config'].get('nb_partitions')} "
            f"timers={info.get('time')}"
        )
        results[tag] = {
            "wall_s": round(wall, 1),
            "n_solid": out.n_solid,
            "nb_passes": info["config"]["nb_passes"],
            "spill": bool(info["config"].get("spill")),
            "nb_partitions": info["config"].get("nb_partitions"),
            "nb_distinct": info["nb_distinct_kmers"],
            "spill_splits": info.get("spill_splits"),
            "spill_mb": info.get("spill_mb"),
            "time": info.get("time"),
            "store": out.store_path,
        }
        return out

    # ref store keyed to its input via the shared sidecar helper
    # (vg.ensure_ref_store — round-5 lesson: an unkeyed reuse at a
    # different --genome-mb reported a fake FAIL)
    ref_store = vg.ensure_ref_store(
        tag_dir, fasta,
        lambda: run("a", spill="off", max_memory=2600, max_disk=150),
    )
    if "a" not in results:
        results["ref"] = {"store": ref_store, "reused": True}

    out_sp = run(
        "spill", spill="on", max_memory=mem_spill,
        out_tmp=tag_dir,
    )
    del out_sp

    same_hist, same_tab, rows = vg.compare_stores(
        ref_store, results["spill"]["store"]
    )
    gate = {
        "gate": "spill_guard",
        "bases_mb": total_mb,
        "genome_mb": genome_mb,
        "device": dev.device_kind,
        "spill_passes": results["spill"]["nb_passes"],
        "passes_le_2": results["spill"]["nb_passes"] <= 2,
        "hist_identical": same_hist,
        "table_identical": same_tab,
        "table_rows": rows,
        "legs": results,
    }
    print(json.dumps(gate), flush=True)
    ok = (
        same_hist and same_tab
        and results["spill"]["nb_passes"] <= 2
        and results["spill"]["spill"]
    )
    log("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
