"""Host-only ingest throughput: gunzip + parse + 2-bit encode + row pack
+ wire pack, no device.  This is the host half of the count path; on
real metal (PCIe H2D at GB/s) end-to-end throughput is
min(host ingest, device pipeline), so this number is the e2e projection
partner of PERF.md's device ceiling.

Usage: python scripts/measure_host_pipeline.py [n_mbases]
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
    from measure_cli_e2e import make_input

    from dsk_tpu.io.bank import open_bank
    from dsk_tpu.io.batch import batch_iterator
    from dsk_tpu.io.packed import pack_codes

    n_mbases = int(sys.argv[1]) if len(sys.argv) > 1 else 100
    inp = make_input(n_mbases)

    k, rows, row_len = 31, 2048, 192  # planner-like geometry for 170bp reads

    from dsk_tpu.io.prefetch import parallel_map, prefetch

    def pack_one(b):
        return pack_codes(np.ascontiguousarray(b.codes, np.uint8))

    for workers in (1, 2, 4, 8):
        # serial-pack arrangement (pre round-2-final engine): pack on the
        # consuming thread, behind the reader
        bank = open_bank(str(inp))
        t0 = time.perf_counter()
        n_bases = n_batches = 0
        for b in batch_iterator(
            bank, k, rows, row_len, n_workers=workers
        ):
            words, bitmap = pack_one(b)
            n_bases += b.n_bases
            n_batches += 1
            del words, bitmap
        dt = time.perf_counter() - t0
        log(
            f"workers={workers} serial-pack: {n_bases / 1e6:.0f} Mbases "
            f"in {dt:.2f}s = {n_bases / dt / 1e6:.1f} Mbases/s "
            f"({n_batches} batches)"
        )

        # pool-pack arrangement (the engine's count_stream shape): raw
        # batches cross a bounded queue and pack on a put-pool analog
        bank = open_bank(str(inp))
        t0 = time.perf_counter()
        n_bases = 0
        src = prefetch(
            batch_iterator(bank, k, rows, row_len, n_workers=workers),
            depth=32,
        )

        def pack_keep(b):
            out = pack_one(b)
            return out, b.n_bases

        for (words, bitmap), bb in parallel_map(pack_keep, src, workers=4):
            n_bases += bb
            del words, bitmap
        dt = time.perf_counter() - t0
        log(
            f"workers={workers} pool-pack:   {n_bases / 1e6:.0f} Mbases "
            f"in {dt:.2f}s = {n_bases / dt / 1e6:.1f} Mbases/s"
        )


if __name__ == "__main__":
    main()
