#!/usr/bin/env python
"""Device gate for MID-PASS spill resume (round 5).

A checkpointed spill run is killed mid-count (a store-append hook
raises after N partitions land), then re-executed with -resume: the
fill must NOT re-stream (zero `_spill_stream` calls — the bucket files
are durable), and the resumed store + histogram must be identical to
the uninterrupted reference store.  Exceeds the reference, which has no
mid-run checkpoint (SURVEY.md §5.3-5.4); the fixed-memory disk engine
is exactly the mode whose runs are long enough to need one.

Reuses <tmp>/gbase192 (input_g16M.fasta + a.dsk from spill_guard.py).

    python scripts/spill_resume_gate.py [--bases 192 --genome-mb 16]
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dsk_tpu.utils.hostmem import tune_malloc

tune_malloc()


def log(msg: str) -> None:
    print(f"[resume_gate] {msg}", file=sys.stderr, flush=True)


class _Kill(Exception):
    pass


def main() -> int:
    total_mb = 192
    genome_mb = 16
    if "--bases" in sys.argv:
        total_mb = int(sys.argv[sys.argv.index("--bases") + 1])
    if "--genome-mb" in sys.argv:
        genome_mb = int(sys.argv[sys.argv.index("--genome-mb") + 1])
    kill_after = 4  # store partition appends before the injected crash
    if "--kill-after" in sys.argv:
        kill_after = int(sys.argv[sys.argv.index("--kill-after") + 1])

    import scripts.validate_gbase as vg

    vg.GENOME_MB = genome_mb
    tag_dir = vg.work_dir(total_mb, plain_1024=False)
    os.makedirs(tag_dir, exist_ok=True)
    fasta = f"{tag_dir}/input_g{genome_mb}M.fasta"

    import jax

    dev = jax.devices()[0]
    log(f"device: {dev.device_kind} ({dev.platform})")

    vg.gen_input(fasta, total_mb)

    from dsk_tpu.dist.engine import DistCountEngine
    from dsk_tpu.engine.run import RunParams, execute
    from dsk_tpu.store.output import OutputStore

    params = dict(
        file=fasta, kmer_size=31, abundance_min=3, verbose=2, histo=1,
        spill="on", max_memory=288, out=f"{tag_dir}/resume",
        out_tmp=tag_dir,
    )

    # -- leg 1: crash after `kill_after` streamed partition appends ----
    orig_append = OutputStore.append_solid_partition
    n_appends = [0]

    def dying_append(self, idx, kk, cc):
        n_appends[0] += 1
        if n_appends[0] > kill_after:
            raise _Kill(f"injected kill after {kill_after} partitions")
        return orig_append(self, idx, kk, cc)

    OutputStore.append_solid_partition = dying_append
    t0 = time.perf_counter()
    crashed = False
    try:
        execute(RunParams(**params))
    except _Kill as e:
        crashed = True
        log(f"crashed as injected: {e}")
    finally:
        OutputStore.append_solid_partition = orig_append
    t_crash = time.perf_counter() - t0
    assert crashed, "the injected kill never fired (too few partitions?)"
    ckpt_dir = f"{tag_dir}/resume.spillckpt"
    assert os.path.isdir(ckpt_dir), f"no spill checkpoint at {ckpt_dir}"
    n_marks = sum(
        1 for f in os.listdir(ckpt_dir) if f.startswith("count_p")
    )
    log(f"crash leg: {t_crash:.0f}s, ckpt dir present, {n_marks} mark(s)")

    # -- leg 2: resume; the fill must never re-stream ------------------
    fills = [0]
    orig_fill = DistCountEngine._spill_stream

    def counting_fill(self, *a, **kw):
        fills[0] += 1
        return orig_fill(self, *a, **kw)

    DistCountEngine._spill_stream = counting_fill
    t0 = time.perf_counter()
    try:
        out = execute(RunParams(resume=True, **params))
    finally:
        DistCountEngine._spill_stream = orig_fill
    t_resume = time.perf_counter() - t0
    log(
        f"resume leg: {t_resume:.0f}s, fills={fills[0]}, "
        f"n_solid={out.n_solid}, resumed="
        f"{out.info.get('spill_resumed')}"
    )
    assert fills[0] == 0, "resume re-streamed the input"
    assert not os.path.isdir(ckpt_dir), "ckpt not cleaned after success"

    # -- compare against the uninterrupted reference store -------------
    # shared input-keying discipline (vg.ensure_ref_store): reuse a.dsk
    # only when its sidecar matches THIS input, else build it fresh
    ref_store = vg.ensure_ref_store(
        tag_dir, fasta,
        lambda: execute(RunParams(
            file=fasta, kmer_size=31, abundance_min=3, verbose=2,
            histo=1, spill="off", max_memory=2600, max_disk=150,
            out=f"{tag_dir}/a",
        )),
    )
    same_hist, same_tab, rows = vg.compare_stores(ref_store, out.store_path)
    gate = {
        "gate": "spill_resume",
        "bases_mb": total_mb,
        "device": str(dev),
        "kill_after_partitions": kill_after,
        "marks_at_crash": n_marks,
        "resume_fill_streams": fills[0],
        "spill_resumed": bool(out.info.get("spill_resumed")),
        "hist_identical": bool(same_hist),
        "table_identical": bool(same_tab),
        "table_rows": int(rows),
        "t_crash_s": round(t_crash, 1),
        "t_resume_s": round(t_resume, 1),
    }
    print(json.dumps(gate), flush=True)
    # spill_resumed must be True: without it a silent regression to a
    # full recount from the durable fills (store recreated, marks
    # dropped) would still produce an identical store and fills==0 —
    # PASS must mean the MID-PASS path actually ran
    ok = (
        same_hist
        and same_tab
        and fills[0] == 0
        and bool(out.info.get("spill_resumed"))
    )
    log("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
