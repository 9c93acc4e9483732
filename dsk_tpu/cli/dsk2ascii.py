"""`dsk2ascii` CLI: dump a count store as text.

Replaces the reference's dsk2ascii tool (utils/dsk2ascii.cpp): re-opens
the store, reads kmer_size from the dsk group, iterates solid partitions
in order, prints '<KMER> <count>' lines (or -fasta / -fastq shapes).
"""

from __future__ import annotations

import argparse
import os
import sys

from dsk_tpu.kmer import codec
from dsk_tpu.store import text as store_text
from dsk_tpu.store.output import OutputStore

# rows below which the parallel sorted dump is not worth the process
# spawns (a segment worker costs ~0.5 s to start)
_PARALLEL_MIN_ROWS = 1 << 21


def _segment_worker(task) -> int:
    """One parallel-dump worker (spawned process): merge its key-range
    segment of the store's sorted runs and write the formatted text to
    a segment file.  Concatenating segment files in order reproduces
    the serial dump byte-for-byte (sorted_segment_plan's contract)."""
    path, seg_path, bounds, pool_rows = task
    from dsk_tpu.store.output import _merge_sorted_runs
    from dsk_tpu.utils.hostmem import tune_malloc

    tune_malloc()
    store = OutputStore.load(path)
    try:
        k = store.kmer_size
        w = store.nb_words
        runs = [
            (store._f["dsk/solid"][name], lo, hi)
            for name, lo, hi in bounds
            if hi > lo
        ]
        n = 0
        step = store_text.DUMP_CHUNK_ROWS
        with open(seg_path, "wb") as f:
            for kk, cc in _merge_sorted_runs(runs, w, pool_rows):
                # format in bounded slices: format_count_lines builds an
                # (m, k) int64 scatter index, so a multi-million-row
                # merge chunk fed whole costs GBs of temp (pure page-
                # fault sys time on this VM class — utils/hostmem.py)
                for off in range(0, kk.shape[0], step):
                    f.write(
                        store_text.format_count_lines(
                            codec.words_to_letters(
                                kk[off : off + step], k
                            ),
                            cc[off : off + step],
                        )
                    )
                n += kk.shape[0]
        return n
    finally:
        store.close()


def _dump_sorted_parallel(
    path, store, out, n_workers: int, tmp_dir: str | None = None
) -> int | None:
    """Range-sharded parallel sorted dump: split the key space into
    n_workers segments (run-map quantiles), merge + format each in its
    own process, stream the segment files to `out` in order.  Returns
    the row count, or None when the store has no run map (caller falls
    back to the serial external sort).

    tmp_dir stages the full formatted text (~rows x (k+8) bytes): at
    flagship scale that is ~100 GB, so it defaults to the OUTPUT's
    directory (same filesystem), never a possibly-tmpfs /tmp."""
    import shutil
    import tempfile
    from concurrent.futures import ProcessPoolExecutor
    from multiprocessing import get_context

    try:
        plan = store.sorted_segment_plan(n_workers)
    except ValueError:
        return None
    work = tempfile.mkdtemp(prefix="dsk2ascii_par_", dir=tmp_dir)
    try:
        tasks = [
            (path, f"{work}/seg_{i:03d}.txt", seg, 1 << 22)
            for i, seg in enumerate(plan)
        ]
        # spawn: the workers import only numpy-level modules (this
        # module's import chain never imports jax, so no worker can
        # initialise a device backend; tests/test_store_cli.py pins it)
        with ProcessPoolExecutor(
            max_workers=len(tasks), mp_context=get_context("spawn")
        ) as ex:
            counts = list(ex.map(_segment_worker, tasks))
        for _p, seg_path, _b, _r in tasks:
            with open(seg_path, "rb") as f:
                shutil.copyfileobj(f, out, 1 << 20)
        return sum(counts)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dsk2ascii",
        description="dump a dsk_tpu count store as text",
        add_help=False,
    )
    p.add_argument("-help", "--help", action="help")
    p.add_argument("-file", required=True, help="input count store (<prefix>.dsk)")
    p.add_argument("-out", default=None, help="output text file (default stdout)")
    p.add_argument("-fasta", action="store_true", help="fasta-shaped output")
    p.add_argument("-fastq", action="store_true", help="fastq-shaped output")
    p.add_argument("-sorted", dest="sorted_", action="store_true",
                   help="emit globally sorted kmers (A<C<T<G order) instead "
                        "of partition order — the normative comparison form")
    p.add_argument("-c", dest="stdout", action="store_true",
                   help="force output to stdout")
    p.add_argument("-nb-cores", dest="nb_cores", type=int, default=0,
                   help="parallel workers for the -sorted dump "
                        "(0 = auto; 1 = serial)")
    p.add_argument("-out-tmp", dest="out_tmp", default=None,
                   help="staging dir for the -sorted dump's segment / "
                        "external-sort files (default: next to -out — "
                        "they can reach the full dump size)")
    p.add_argument("-verbose", type=int, default=1)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    from dsk_tpu.utils.hostmem import tune_malloc

    tune_malloc()  # the chunked decode allocates ~100 MB temps
    try:
        store = OutputStore.load(args.file)
    except (OSError, KeyError) as e:
        print(f"dsk2ascii: error: cannot open {args.file}: {e}", file=sys.stderr)
        return 1
    try:
        def write_sorted(f, chunks):
            k = store.kmer_size
            n = 0
            step = store_text.DUMP_CHUNK_ROWS
            for kk, cc in chunks:
                # bounded format slices (see _segment_worker)
                for off in range(0, kk.shape[0], step):
                    f.write(
                        store_text.format_count_lines(
                            codec.words_to_letters(
                                kk[off : off + step], k
                            ),
                            cc[off : off + step],
                        )
                    )
                n += kk.shape[0]
            return n

        def dump(f):
            if args.sorted_:
                # big stores: range-sharded PARALLEL merge (each worker
                # process merges + formats one leading-key segment;
                # byte-identical concatenation).  Small stores / no run
                # map: the serial vectorized k-way merge; legacy stores
                # without a run map go through the external-sort
                # fallback — chunk-sorted temp runs + the same merge,
                # STILL bounded (the old materializing lexsort was
                # unbounded at the 2.7B-row flagship scale)
                workers = args.nb_cores
                if workers <= 0:
                    workers = min(os.cpu_count() or 1, 8)
                tmp_dir = args.out_tmp or (
                    os.path.dirname(os.path.abspath(args.out))
                    if args.out and not args.stdout
                    else None
                )
                if (
                    workers > 1
                    and store.n_solid() >= _PARALLEL_MIN_ROWS
                ):
                    n = _dump_sorted_parallel(
                        args.file, store, f, workers, tmp_dir=tmp_dir
                    )
                    if n is not None:
                        return n
                try:
                    return write_sorted(f, store.iter_sorted_rows())
                except ValueError:
                    return write_sorted(
                        f,
                        store.iter_sorted_rows_external(
                            tmp_dir=tmp_dir
                        ),
                    )
            return store_text.dump_ascii(store, f, args.fasta, args.fastq)

        if args.out and not args.stdout:
            with open(args.out, "wb") as f:
                n = dump(f)
        else:
            n = dump(sys.stdout.buffer)
            sys.stdout.buffer.flush()
        if args.verbose and args.out:
            print(f"dsk2ascii: wrote {n} kmers -> {args.out}", file=sys.stderr)
    finally:
        store.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
