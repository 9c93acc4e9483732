"""Fenced device-step sweep over flush-group geometry (one card).

Each flush re-sorts the whole table_cap, so fewer, bigger flush groups
and a distinct-sized cap should both win until the flush sort's
super-linearity takes over.  This sweeps (buf_batches, table_cap) at
bench geometry and reports device-ceiling bases/s per config (wire
excluded: groups are device-resident, steps fenced with
jax.block_until_ready).  Best-of-K reps, stderr progress.

Usage: python scripts/measure_group_geometry.py [k]
"""

import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main():
    from dsk_tpu.utils.hostmem import tune_malloc

    tune_malloc()

    import jax
    import jax.numpy as jnp

    from bench import make_batches
    from dsk_tpu.dist.engine import DistCountEngine, default_mesh
    from dsk_tpu.io.packed import pack_codes

    dev = jax.devices()[0]
    log(f"device: {dev.device_kind} ({dev.platform})")

    rows, row_len = 2048, 1024
    k = int(sys.argv[1]) if len(sys.argv) > 1 else 31

    if k == 31:
        # round-3 re-sweep: the weightless flush cut the per-row sort
        # cost, so the optimum may have moved toward bigger groups
        configs = [
            ("G32-cap1.5M", 32, (1 << 20) + (1 << 19)),
            ("G48-cap1.5M", 48, (1 << 20) + (1 << 19)),
            ("G64-cap1.5M", 64, (1 << 20) + (1 << 19)),
        ]
    else:
        configs = [
            ("G16-cap1.5M", 16, (1 << 20) + (1 << 19)),
            ("G32-cap1.5M", 32, (1 << 20) + (1 << 19)),
        ]

    results = {}
    for name, G, cap in configs:
        log(f"[{name}] building engine (G={G}, cap={cap})...")
        engine = DistCountEngine(  # hand-packed bitmap groups below
            k,
            mesh=default_mesh(),
            batch_rows=rows,
            row_len=row_len,
            buf_batches=G,
            table_cap=cap,
            wire="bitmap",
        )
        batches = make_batches(G, rows, row_len, seed=0)
        ws, ms = zip(*(pack_codes(b.codes) for b in batches))
        cd = jax.device_put(np.stack(ws), dev)
        md = jax.device_put(np.stack(ms), dev)
        bd = jax.device_put(np.stack([b.bank_ids for b in batches]), dev)
        jax.block_until_ready(cd)  # fence the puts
        st = engine._init_state()
        tab_p, tab_c, over, tover = st
        ps = jnp.int32(0)
        # _step donates the table carry: rebind it each call (bench.py does
        # the same) or the next call reads a donated buffer
        t0 = time.perf_counter()
        tab_p, tab_c, over, tover = engine._step(
            cd, md, bd, tab_p, tab_c, over, tover, ps
        )
        jax.block_until_ready(over)
        log(f"  compile+first {time.perf_counter() - t0:.1f}s")
        best = float("inf")
        for _ in range(4):
            t0 = time.perf_counter()
            tab_p, tab_c, over, tover = engine._step(
                cd, md, bd, tab_p, tab_c, over, tover, ps
            )
            jax.block_until_ready(over)
            best = min(best, time.perf_counter() - t0)
        group_bases = G * rows * row_len
        mbps = group_bases / best / 1e6
        results[name] = (best, mbps)
        log(f"  {name}: best {best * 1e3:.1f} ms = {mbps:.1f} Mbases/s")
        del engine, cd, md, bd, st, tab_p, tab_c, over, tover

    log(f"== summary (device ceiling, k={k}) ==")
    for name, (best, mbps) in results.items():
        log(f"{name:14s} {best * 1e3:8.1f} ms  {mbps:7.1f} Mbases/s")


if __name__ == "__main__":
    main()
