"""Gbase-class validation run on the device (VERDICT r2 next-item 3).

One synthetic ~1.02 Gbase FASTA (16 Mbase genome, 62x coverage,
~16M distinct 31-mers) driven twice through the FULL execute() stack on
the real chip:

  run A ("clean"): planner-chosen ~3 passes, deliberately tight
         -max-disk (forces the batch-cache abort-and-reread path),
         streaming bounded-memory output, checkpoints on.
  run B ("valve"): same input, table_cap shrunk to 0.6x of plan (via a
         plan_resources wrapper) => TableOverflow mid-pass => the retry
         valve doubles passes and recounts; finishes clean at ~6 passes.

Checks:
  1. A == B: identical histograms AND identical full (kmer, count)
     stores (different pass decompositions + an overflow retry must not
     change a single count — the at-scale identity the 100 Mbase soak
     checked at 1-vs-3 passes, now at 10x size with the round-3
     streaming-output/volume-planner/retry stack in the loop).
  2. Phase timers + plan + store sizes recorded (PERF.md material).

Reference tier analog: /root/reference/doc/figure-1/ecoli_log:12
(749 Mbases) and droso_log (1.37 Gbases).

Run: python scripts/validate_gbase.py [--bases 1024] (Mbases; smaller
for smoke).  Writes everything under <tmp>/gbase (work_dir()).
"""

from __future__ import annotations

import json
import os
import sys
import time

GENOME_MB = 16  # Mbases of genome; distinct ~= genome size (--genome-mb)
READ_LEN = 126


def log(msg: str) -> None:
    print(f"[gbase] {msg}", file=sys.stderr, flush=True)


def gen_input(path: str, total_mbases: int, seed: int = 0) -> None:
    import numpy as np

    if os.path.exists(path) and os.path.getsize(path) > 0:
        log(f"input exists: {path} ({os.path.getsize(path)>>20} MB)")
        return
    rng = np.random.default_rng(seed)
    G = GENOME_MB << 20
    genome = rng.integers(0, 4, G, dtype=np.uint8)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    n_reads = (total_mbases << 20) // READ_LEN
    t0 = time.perf_counter()
    CH = 200_000
    with open(path, "wb", buffering=1 << 22) as f:
        done = 0
        while done < n_reads:
            m = min(CH, n_reads - done)
            starts = rng.integers(0, G - READ_LEN, m)
            mat = acgt[genome[starts[:, None] + np.arange(READ_LEN)]]
            rows = np.empty((m, READ_LEN + 1), np.uint8)
            rows[:, :READ_LEN] = mat
            rows[:, READ_LEN] = ord("\n")
            heads = "".join(
                f">r{done + i}\n" for i in range(m)
            ).encode()
            # interleave header/sequence: build per-read byte chunks
            seqs = rows.tobytes()
            out = bytearray()
            off = 0
            hlines = heads.split(b"\n")
            for i in range(m):
                out += b">" + hlines[i][1:] + b"\n"
                out += seqs[off : off + READ_LEN + 1]
                off += READ_LEN + 1
            f.write(out)
            done += m
            if done % (CH * 10) == 0:
                log(f"gen: {done}/{n_reads} reads")
    log(
        f"generated {n_reads} reads x {READ_LEN}bp = "
        f"{n_reads*READ_LEN>>20} Mbases in {time.perf_counter()-t0:.0f}s"
    )


def load_store(path):
    import numpy as np

    from dsk_tpu.store.output import OutputStore

    ks, cs = [], []
    with OutputStore.load(path) as store:
        for kk, cc in store.iter_solid():
            if kk.shape[0]:
                ks.append(kk.reshape(kk.shape[0], -1))
                cs.append(cc)
        rec = store._f["histogram/histogram"][:]
        hist = np.stack([rec["index"], rec["abundance"]])
    k = np.concatenate(ks) if ks else np.empty((0, 2), np.uint32)
    c = np.concatenate(cs) if cs else np.empty((0,), np.int32)
    order = np.lexsort(tuple(k[:, w] for w in range(k.shape[1] - 1, -1, -1)))
    return k[order], c[order], hist


def work_dir(total_mb: int, plain_1024: bool = True) -> str:
    """<tmp>/gbase<bases> (plain <tmp>/gbase at the 1024 Mbase tier)."""
    import tempfile

    tag = "" if (plain_1024 and total_mb == 1024) else str(total_mb)
    return os.path.join(tempfile.gettempdir(), f"gbase{tag}")


def _dir_mb(path: str) -> float:
    total = 0
    for root, _dirs, files in os.walk(path):
        total += sum(os.path.getsize(os.path.join(root, f)) for f in files)
    return round(total / (1 << 20), 1)


def ensure_ref_store(tag_dir: str, fasta: str, build) -> str:
    """Reuse `tag_dir`/a.dsk only when its sidecar records THIS input
    (path + byte size); otherwise delete the stale store, call
    build() — which must write `tag_dir`/a.dsk — and stamp the sidecar.
    Shared by every gate script so the keying stays byte-compatible
    (round-5 lesson: an unkeyed reuse at a different --genome-mb
    silently compared across inputs and reported a fake FAIL)."""
    import json

    from dsk_tpu.store import container

    ref_store = os.path.join(tag_dir, "a.dsk")
    sidecar = ref_store + ".input.json"
    key = {"input": fasta, "bytes": os.path.getsize(fasta)}
    if os.path.exists(ref_store) and os.path.exists(sidecar):
        try:
            with open(sidecar) as f:
                if json.load(f) == key:
                    log(f"reference store {ref_store} reused (input matches)")
                    return ref_store
        except (OSError, ValueError):
            pass
    if os.path.exists(ref_store):
        log("reference store stale (different input): rebuilding")
        container.remove(ref_store)
    build()
    with open(sidecar, "w") as f:
        json.dump(key, f)
    return ref_store


def compare_stores(a_store: str, b_store: str) -> tuple[bool, bool, int]:
    """(histogram identical, table identical, rows) between two stores
    — the shared identity gate for this script and volume_guard.py."""
    ka, ca, ha = load_store(a_store)
    kb, cb, hb = load_store(b_store)
    same_hist = ha.shape == hb.shape and bool((ha == hb).all())
    same_tab = (
        ka.shape == kb.shape
        and bool((ka == kb).all())
        and bool((ca == cb).all())
    )
    return same_hist, same_tab, int(ka.shape[0])


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from dsk_tpu.utils.hostmem import tune_malloc

    tune_malloc()
    import numpy as np

    global GENOME_MB
    total_mb = 1024
    if "--bases" in sys.argv:
        total_mb = int(sys.argv[sys.argv.index("--bases") + 1])
    if "--genome-mb" in sys.argv:
        GENOME_MB = int(sys.argv[sys.argv.index("--genome-mb") + 1])
    max_memory = 520
    if "--max-memory" in sys.argv:
        max_memory = int(sys.argv[sys.argv.index("--max-memory") + 1])
    max_disk = 150
    if "--max-disk" in sys.argv:
        max_disk = int(sys.argv[sys.argv.index("--max-disk") + 1])
    tag_dir = work_dir(total_mb)

    import jax

    dev = jax.devices()[0]
    log(f"device: {dev.device_kind} ({dev.platform})")

    os.makedirs(tag_dir, exist_ok=True)
    # cache key includes the genome size: a changed --genome-mb must
    # not silently reuse an input generated from a different genome
    fasta = f"{tag_dir}/input_g{GENOME_MB}M.fasta"
    legacy = f"{tag_dir}/input.fasta"
    if GENOME_MB == 64 and os.path.exists(legacy):
        fasta = legacy  # round-3 artifacts predate the keyed name
    gen_input(fasta, total_mb)

    import dsk_tpu.engine.run as runmod
    from dsk_tpu.engine.run import RunParams, execute

    results = {}

    def run(tag: str, shrink: float | None, **kw):
        orig = runmod.plan_resources

        def plan(*a, **kws):
            p = orig(*a, **kws)
            if shrink is not None:
                p.table_cap = int(p.table_cap * shrink)
            log(
                f"[{tag}] plan: passes={p.n_passes} cap={p.table_cap} "
                f"G={p.buf_batches} est_distinct={p.est_distinct}"
            )
            return p

        runmod.plan_resources = plan
        t0 = time.perf_counter()
        try:
            out = execute(RunParams(
                file=fasta, kmer_size=31, abundance_min=3,
                out=f"{tag_dir}/{tag}", verbose=2, histo=1, **kw,
            ))
        finally:
            runmod.plan_resources = orig
        wall = time.perf_counter() - t0
        info = out.info
        log(
            f"[{tag}] DONE in {wall:.0f}s: n_solid={out.n_solid} "
            f"passes={info['config']['nb_passes']} "
            f"timers={info.get('time')}"
        )
        results[tag] = {
            "wall_s": round(wall, 1),
            "n_solid": out.n_solid,
            "nb_passes": info["config"]["nb_passes"],
            "nb_distinct": info["nb_distinct_kmers"],
            "time": info.get("time"),
            "store": out.store_path,
            "store_mb": _dir_mb(out.store_path),
        }
        return out

    # --extra-leg TAG:SHRINK runs ONE more shrunk leg against an
    # existing run A (e.g. when the default 0.6x shrink still fits the
    # actual per-pass distinct count and B never overflows)
    extra = None
    if "--extra-leg" in sys.argv:
        t, s = sys.argv[sys.argv.index("--extra-leg") + 1].split(":")
        extra = (t, float(s))
    if extra is not None:
        tag, shrink = extra
        if tag in ("a", "b"):
            raise SystemExit(
                f"--extra-leg tag {tag!r} would clobber the reference runs"
            )
        if not os.path.exists(f"{tag_dir}/a.dsk"):
            raise SystemExit(
                "--extra-leg needs a completed run A in "
                f"{tag_dir} (run without --extra-leg first)"
            )
        run(tag, shrink, max_memory=max_memory)
        results["a"] = {"store": f"{tag_dir}/a.dsk"}
        results["b"] = results[tag]
    else:
        # run A: clean, tight -max-disk (cache abort-and-reread live)
        run("a", None, max_memory=max_memory, max_disk=max_disk)
        # run B: induced TableOverflow -> retry valve doubles passes
        run("b", 0.6, max_memory=max_memory)

    log("comparing stores (host lexsort of both tables)...")
    same_hist, same_tab, rows = compare_stores(
        results["a"]["store"], results["b"]["store"]
    )
    log(f"histogram identical: {same_hist}; table identical: {same_tab}")
    results["identity"] = {
        "histogram": same_hist,
        "table": same_tab,
        "rows": rows,
    }
    print(json.dumps(results, indent=1))
    with open(f"{tag_dir}/results.json", "w") as f:
        json.dump(results, f, indent=1)
    return 0 if (same_hist and same_tab) else 1


if __name__ == "__main__":
    sys.exit(main())
