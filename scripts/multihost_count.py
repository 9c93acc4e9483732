"""Multi-host counting driver: one process per host.

The multi-host replacement for the reference's single-machine run — the
filesystem "interconnect" (partition files, /root/reference/doc/paper.tex:71-76)
becomes jax.distributed + a global mesh + all_to_all routing
(SURVEY.md §2.4).  Each process reads its byte-range shard of the input
(dist/multihost.shard_bank), streams in lockstep, and ends with:

  * the GLOBAL abundance histogram (identical on every host),
  * its own chips' partitions (the partition-files analog), saved as
    <out>.part<pid>.npz,

after which process 0 merges the partition files into the final count
store (<out>.dsk) + .histo (the same outputs as a single-host `dsk` run).

Launch (every host, or locally for testing):

    python scripts/multihost_count.py -coordinator host0:8476 \
        -num-processes N -process-id I -file reads.fasta -kmer-size 27 \
        -out /shared/out [-abundance-min 2] [-table-cap 2**20] ...

On a GPU host, one process per card: add `-local-device-ids I` so each
process opens only its own card.

CPU simulation: JAX_PLATFORMS=cpu + xla_force_host_platform_device_count.
"""

import argparse
import os
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main() -> int:
    ap = argparse.ArgumentParser(prefix_chars="-")
    ap.add_argument("-coordinator", required=True)
    ap.add_argument("-num-processes", dest="num_processes", type=int,
                    required=True)
    ap.add_argument("-process-id", dest="process_id", type=int, required=True)
    ap.add_argument("-local-device-ids", dest="local_device_ids",
                    default=None,
                    help="comma list of this host's cards this process "
                         "opens (e.g. its process id, one card per "
                         "process); default: every local device")
    ap.add_argument("-file", required=True)
    ap.add_argument("-kmer-size", dest="kmer_size", type=int, default=31)
    ap.add_argument("-abundance-min", dest="abundance_min", type=int,
                    default=2)
    ap.add_argument("-out", required=True)
    ap.add_argument("-batch-rows", dest="batch_rows", type=int, default=256)
    ap.add_argument("-row-len", dest="row_len", type=int, default=256)
    ap.add_argument("-table-cap", dest="table_cap", type=int, default=1 << 18)
    ap.add_argument("-nb-cores", dest="nb_cores", type=int, default=1)
    ap.add_argument("-spill-partitions", dest="spill_partitions",
                    type=int, default=0,
                    help="> 0: host-partition spill over a SHARED spill "
                         "dir (next to -out); partitions owned by "
                         "pid %% n_hosts, counted host-locally")
    ap.add_argument("-per-bank", dest="per_bank", action="store_true",
                    help="per-bank counting over the spill path (round "
                         "5): each host's partitions arrive GROUPED per "
                         "kmer with a bank matrix; requires "
                         "-spill-partitions > 0.  Outputs .part<i>.npz "
                         "with a `banks` matrix + the global .histo "
                         "(no merged .dsk)")
    ap.add_argument("-selfdestruct-after-groups",
                    dest="selfdestruct", type=int, default=0,
                    help="FAILURE INJECTION (tests): hard-kill this "
                         "process after N dispatched flush groups — "
                         "survivors must error out within the lockstep "
                         "barrier timeout, never hang")
    ap.add_argument("-selfdestruct-after-fill",
                    dest="selfdestruct_fill", action="store_true",
                    help="FAILURE INJECTION (tests): hard-kill this "
                         "process once its spill FILL phase completes "
                         "(manifests durable) — a re-run must resume "
                         "the count from the shared bucket files with "
                         "zero input re-streams")
    args = ap.parse_args()

    from dsk_tpu.dist import multihost

    multihost.initialize(
        args.coordinator, args.num_processes, args.process_id,
        local_device_ids=(
            [int(x) for x in args.local_device_ids.split(",")]
            if args.local_device_ids else None
        ),
    )
    import jax
    from jax.experimental import multihost_utils

    pid = jax.process_index()
    print(
        f"[mh {pid}] {jax.process_count()} processes, "
        f"{len(jax.local_devices())} local / {len(jax.devices())} global "
        f"devices", file=sys.stderr, flush=True,
    )

    from dsk_tpu.dist.engine import DistCountEngine, default_mesh
    from dsk_tpu.io.bank import open_bank
    from dsk_tpu.store import text as store_text
    from dsk_tpu.store.output import OutputStore

    bank = open_bank(args.file)
    shard = multihost.shard_bank(bank)
    print(f"[mh {pid}] shard units: "
          f"{[(os.path.basename(u.path), u.start, u.end) for u in shard.units]}",
          file=sys.stderr, flush=True)

    if args.per_bank and args.spill_partitions <= 0:
        print("[mh] -per-bank needs -spill-partitions > 0",
              file=sys.stderr)
        return 2
    engine = DistCountEngine(
        args.kmer_size,
        mesh=default_mesh(),
        batch_rows=args.batch_rows,
        row_len=args.row_len,
        table_cap=args.table_cap,
        per_bank=args.per_bank,
        spill_partitions=args.spill_partitions,
        spill_dir=os.path.dirname(os.path.abspath(args.out)) or None,
    )
    if args.selfdestruct > 0:
        # spill engines dispatch _step_spill, table engines _step —
        # wrap whichever this engine actually calls
        attr = "_step_spill" if engine.spill else "_step"
        real_step = getattr(engine, attr)
        calls = [0]

        def dying_step(*a):
            calls[0] += 1
            if calls[0] > args.selfdestruct:
                print(f"[mh {pid}] SELF-DESTRUCT after {args.selfdestruct} "
                      f"groups", file=sys.stderr, flush=True)
                os._exit(13)
            return real_step(*a)

        setattr(engine, attr, dying_step)
    if args.selfdestruct_fill:
        # die right where the count phase would start: after the fill
        # barrier, so the manifests + bucket files are durable
        def dying_count(*a, **kw):
            print(f"[mh {pid}] SELF-DESTRUCT after fill",
                  file=sys.stderr, flush=True)
            os._exit(13)

        engine._count_partitions = dying_count

    # multi-process spill FILL-resume (round 5): manifests in the
    # SHARED dir next to -out; a re-run whose fingerprint matches a
    # complete set of manifests skips every host's input stream and
    # rebuilds the count from the durable bucket files
    spill_ckpt = None
    if args.spill_partitions > 0:
        import json as _json

        from dsk_tpu.dist.spill import SpillCheckpoint

        shared = os.path.dirname(os.path.abspath(args.out))
        fp = _json.dumps(
            {
                "file": args.file, "k": args.kmer_size,
                "rows": args.batch_rows, "len": args.row_len,
                "cap": args.table_cap, "parts": args.spill_partitions,
                "n": args.num_processes, "pb": bool(args.per_bank),
            },
            sort_keys=True,
        )
        spill_ckpt = SpillCheckpoint(
            os.path.join(
                shared, os.path.basename(args.out) + ".spillckpt"
            ),
            fp,
        )
    if args.per_bank:
        # per-bank spill: the sink receives each owned partition
        # GROUPED per kmer (total + bank matrix), in the same order the
        # engine records partition_ids/sizes (one critical section).
        # The histo2D matrix is additive over kmers, so each host folds
        # its owned partitions in and the global matrix allgather-sums
        # (BASELINE config 5: the joint spectrum across hosts).
        from dsk_tpu.engine import processors

        acc = {"k": [], "t": [], "b": []}
        # one named histo_max drives BOTH the buffer shape and the
        # matrix builder (shape coupling by name, not by literal);
        # matches RunParams.histo_max's default
        H2D_MAX = 10_000
        histo2d = np.zeros((H2D_MAX + 2, 11), np.int64)

        def pb_sink(p, part_id, kk, tot, bmat):
            acc["k"].append(kk)
            acc["t"].append(tot)
            acc["b"].append(bmat)
            if bmat.shape[0] and bmat.shape[1] >= 2:
                histo2d[:] += processors.histo2d_matrix(bmat, H2D_MAX)

        res = engine.count(
            shard, per_bank=True, pass_sink_per_bank=pb_sink,
            n_workers=args.nb_cores, spill_ckpt=spill_ckpt,
        )
        nb = shard.nb_banks
        kmers = (
            np.concatenate(acc["k"])
            if acc["k"] else np.empty((0, engine.W), np.uint32)
        )
        counts = (
            np.concatenate(acc["t"])
            if acc["t"] else np.empty((0,), np.int64)
        )
        banks = (
            np.concatenate(acc["b"])
            if acc["b"] else np.zeros((0, nb), np.int64)
        )
    else:
        res = engine.count(
            shard, n_workers=args.nb_cores, spill_ckpt=spill_ckpt
        )
        kmers, counts, banks = res.kmers, res.counts, None

    # every host persists its partitions; process 0 merges after a barrier
    ids = res.info.get("partition_ids", engine.local_partition_ids)
    extra = {"banks": banks} if banks is not None else {}
    np.savez(
        f"{args.out}.part{pid}.npz",
        kmers=kmers,
        counts=counts,
        partition_ids=np.array(ids, np.int32),
        sizes=np.array(res.info["partition_sizes"], np.int64),
        histogram=res.histogram,
        spill_count_devices=np.int32(
            res.info.get("spill_count_devices", 0)
        ),
        fill_resumed=np.int32(bool(res.info.get("fill_resumed"))),
        **extra,
    )
    multihost_utils.sync_global_devices("dsk_tpu_mh_parts_written")

    if args.per_bank:
        # the global histo2D sums every host's owned-partition folds
        histo2d = np.asarray(
            multihost_utils.process_allgather(histo2d)
        ).sum(axis=0)
    if pid == 0 and args.per_bank:
        # per-bank mode: partitions live in the npz files (grouped
        # kmer + bank matrix); the global histogram + histo2D are the
        # shared text artifacts
        with open(args.out + ".histo", "w") as f:
            store_text.write_histo(res.histogram, f)
        if shard.nb_banks >= 2:
            with open(args.out + ".histo2D", "w") as f:
                store_text.write_histo2d(histo2d, f)
        print(f"[mh 0] wrote {args.out}.histo / .histo2D (per-bank)",
              file=sys.stderr, flush=True)
    elif pid == 0:
        parts = []
        for i in range(jax.process_count()):
            parts.append(np.load(f"{args.out}.part{i}.npz"))
        order = np.argsort(
            np.concatenate([p["partition_ids"] for p in parts])
        )
        all_ids = np.concatenate([p["partition_ids"] for p in parts])
        chunks = {}
        for p in parts:
            off = 0
            for gid, sz in zip(p["partition_ids"], p["sizes"]):
                chunks[int(gid)] = (
                    p["kmers"][off : off + sz], p["counts"][off : off + sz]
                )
                off += sz
        del order, all_ids
        with OutputStore.create(args.out + ".dsk", args.kmer_size) as store:
            for gid in sorted(chunks):
                km, ct = chunks[gid]
                solid = ct >= args.abundance_min
                store.write_solid_partition(gid, km[solid], ct[solid])
            store.write_histogram(res.histogram)
            store.set_run_info(
                {
                    "kmer_size": args.kmer_size,
                    "n_hosts": jax.process_count(),
                    "input": args.file,
                    **res.info,
                }
            )
        with open(args.out + ".histo", "w") as f:
            store_text.write_histo(res.histogram, f)
        print(f"[mh 0] wrote {args.out}.dsk / .histo", file=sys.stderr,
              flush=True)
    multihost_utils.sync_global_devices("dsk_tpu_mh_done")
    if pid == 0 and spill_ckpt is not None:
        spill_ckpt.remove()  # all hosts past the barrier: run complete
    return 0


if __name__ == "__main__":
    sys.exit(main())
