"""At-scale consistency gate on the device: 100 Mbase fastq.gz counted
twice — default plan vs forced multi-pass — must produce identical
(kmer, count) sets and histograms.

The fixtures pin small-input correctness; this pins the at-scale paths
they cannot reach: planner-chosen big tables, multi-group streaming,
the 2-bit batch cache across passes, pass-table merging.  Verification
is self-consistency (an oracle at 100 Mbases would need GBs of host
dict), which is exactly the reference's c1..c4 invariance idea — the
same multiset through different execution shapes.

Usage: python scripts/soak_multipass.py [n_mbases]
"""

import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def run(inp, out, **kw):
    from dsk_tpu.engine.run import RunParams, execute

    t0 = time.time()
    res = execute(
        RunParams(file=str(inp), kmer_size=31, out=str(out), verbose=1, **kw)
    )
    log(
        f"[{out.name}] wall {time.time() - t0:.1f}s  "
        f"time={res.info.get('time')}  "
        f"n_passes={res.info.get('n_passes')} "
        f"distinct={res.info.get('nb_distinct_kmers')}"
    )
    return res


def load(path):
    from dsk_tpu.store.output import OutputStore

    with OutputStore.load(str(path)) as store:
        f = store._f
        parts = sorted(f["dsk/solid"], key=int)
        rows = [f[f"dsk/solid/{p}"][:] for p in parts]
        hist = f["histogram/histogram"][:]
    solid = np.concatenate(rows) if rows else np.zeros((0,))
    return solid, hist


def main():
    from dsk_tpu.utils.hostmem import tune_malloc

    tune_malloc()
    from measure_cli_e2e import CACHE, make_input

    n_mbases = int(sys.argv[1]) if len(sys.argv) > 1 else 100
    inp = make_input(n_mbases)
    base = CACHE

    run(inp, base / "soak_1pass")
    # small memory budget forces >= 2 passes and the 2-bit batch cache
    run(inp, base / "soak_npass", max_memory=220)

    s1, h1 = load(base / "soak_1pass.dsk")
    s2, h2 = load(base / "soak_npass.dsk")
    assert h1.shape == h2.shape and (h1 == h2).all(), "histogram mismatch"
    assert s1.shape == s2.shape, f"solid count {s1.shape} vs {s2.shape}"

    # order differs (pass-major vs single table): compare as sorted sets
    def matrix(s):
        return np.column_stack(
            [s["value"].astype(np.int64), s["abundance"].astype(np.int64)]
        )

    m1, m2 = matrix(s1), matrix(s2)
    m1 = m1[np.lexsort(m1.T[::-1])]
    m2 = m2[np.lexsort(m2.T[::-1])]
    assert (m1 == m2).all(), "(kmer, count) set mismatch"
    log(
        f"OK: {s1.shape[0]} solid kmers, histogram and (kmer,count) sets "
        f"identical across 1-pass and multi-pass runs"
    )


if __name__ == "__main__":
    main()
