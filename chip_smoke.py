"""Smoke test of the counting path on the GPU: `python chip_smoke.py`.

Drives the normal entry point (`dsk_tpu.engine.run.execute`, the library
form of the `dsk` CLI) on the card and checks every result exactly.  The
pipeline is integers only (uint32 words, int32 counts), so every
comparison has zero tolerance.  Phases, all in this one process:

  1. device: the default JAX device must be a GPU (no CPU fallback);
     prints its kind, the card's name and power limit, whether native IO
     loaded and the compile cache directory.
  2. extraction: the device's canonical k-mer extraction on (2048, 1024)
     batches with 3% non-ACGT bases vs the host oracle
     kmer/codec.canonical_windows, k in 15..127.
  3. goldens: the reference's fixtures through execute(), byte-identical
     histograms / dump; a k=127 synthetic bank vs dsk_tpu/oracle.py.
  4. exact at size: 64 Mbases of 100 bp reads (0.5% substitutions, 5 Mbase
     genome) as FASTQ.gz, k=27, -abundance-min 3, spill off and on, vs a
     numpy oracle (np.unique over uint64 canonical codes).
  5. scale: >= 1 Gbase of the same read shape (20 Mbase genome) with the
     CLI's default memory settings; histogram invariants; prints seconds,
     bases/s, compile seconds, passes and peak device memory.

`--cards 4` runs only the four-card path: phase 3 (read50x) and phase 4
with hash routing, then phase 4 with superkmer routing (-minimizer-type
1), then the phase-5 throughput, on a four-card mesh in one process.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
Any failed check raises, so the exit code is non-zero and no such line
is printed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "tests", "data")
sys.path.insert(0, ROOT)

# the program under test; copied alone, the script stops here
import dsk_tpu  # noqa: E402, F401

READ_LEN = 100
HISTO_MAX = 10000
SCALE_MBASES = 1024  # phase 5 input
# code -> letter; complement of code c is c ^ 2 (A=0 C=1 T=2 G=3)
LETTERS = np.frombuffer(b"ACTG", np.uint8)


class SmokeFailure(RuntimeError):
    """A phase's result differs from its reference."""


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def say(msg: str) -> None:
    print(msg, flush=True)


# -- host pieces: reads, files, numpy oracle ------------------------------


def make_reads(
    n_reads: int, genome_len: int, sub_rate: float, seed: int,
    read_len: int = READ_LEN,
) -> np.ndarray:
    """(n_reads, read_len) uint8 codes 0..3: reads drawn uniformly from a
    random genome, from either strand, with per-base substitutions."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len, dtype=np.uint8)
    out = np.empty((n_reads, read_len), np.uint8)
    step = 1 << 20
    for lo in range(0, n_reads, step):
        n = min(step, n_reads - lo)
        starts = rng.integers(0, genome_len - read_len + 1, n)
        r = genome[starts[:, None] + np.arange(read_len)[None, :]]
        flip = rng.random(n) < 0.5
        r[flip] = (r[flip] ^ 2)[:, ::-1]  # reverse complement
        hit = rng.random(r.shape) < sub_rate
        r = np.where(
            hit, (r + rng.integers(1, 4, r.shape, dtype=np.uint8)) % 4, r
        ).astype(np.uint8)
        out[lo : lo + n] = r
    return out


def write_fastq_gz(path: str, reads: np.ndarray, threads: int = 8) -> None:
    """FASTQ.gz of fixed-length reads: records '@r', seq, '+', qual.
    Chunks are compressed in parallel as concatenated gzip members."""
    n, L = reads.shape
    rec = 3 + L + 3 + L + 1

    def member(lo: int) -> bytes:
        r = reads[lo : lo + (1 << 18)]
        buf = np.empty((r.shape[0], rec), np.uint8)
        buf[:, 0:3] = np.frombuffer(b"@r\n", np.uint8)
        buf[:, 3 : 3 + L] = LETTERS[r]
        buf[:, 3 + L : 6 + L] = np.frombuffer(b"\n+\n", np.uint8)
        buf[:, 6 + L : 6 + 2 * L] = ord("I")
        buf[:, -1] = ord("\n")
        z = zlib.compressobj(1, zlib.DEFLATED, 31)
        return z.compress(buf.tobytes()) + z.flush()

    with open(path, "wb") as f, ThreadPoolExecutor(threads) as ex:
        for blob in ex.map(member, range(0, n, 1 << 18)):
            f.write(blob)


def oracle_counts(codes: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Canonical k-mer counts of (n, L) code rows (codes > 3 split
    windows), k <= 32: (sorted uint64 canonical codes, int64 counts)."""
    n, L = codes.shape
    nw = L - k + 1
    vals = []
    for lo in range(0, n, 1 << 17):
        c = codes[lo : lo + (1 << 17)]
        ok = c <= 3
        cu = np.where(ok, c, 0).astype(np.uint64)
        fwd = np.zeros((c.shape[0], nw), np.uint64)
        rc = np.zeros((c.shape[0], nw), np.uint64)
        for j in range(k):
            col = cu[:, j : j + nw]
            fwd |= col << np.uint64(2 * (k - 1 - j))
            rc |= (col ^ np.uint64(2)) << np.uint64(2 * j)
        bad = np.cumsum(~ok, axis=1)
        bad = np.concatenate([np.zeros((c.shape[0], 1), bad.dtype), bad], 1)
        valid = (bad[:, k:] - bad[:, :-k]) == 0
        vals.append(np.minimum(fwd, rc)[valid])
    return np.unique(np.concatenate(vals), return_counts=True)


def oracle_histogram(counts: np.ndarray) -> np.ndarray:
    return np.bincount(
        np.minimum(counts, HISTO_MAX), minlength=HISTO_MAX + 1
    ).astype(np.int64)


def store_table(store_path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(sorted uint64 solid codes, their counts, histogram) of a k <= 32
    count store."""
    from dsk_tpu.store.output import OutputStore

    ks, cs = [], []
    with OutputStore.load(store_path) as store:
        for kk, cc in store.iter_solid():
            kk = kk.reshape(kk.shape[0], -1).astype(np.uint64)
            v = kk[:, 0]
            for w in range(1, kk.shape[1]):
                v = (v << np.uint64(32)) | kk[:, w]
            ks.append(v)
            cs.append(cc.astype(np.int64))
        hist = store.histogram()
    k = np.concatenate(ks) if ks else np.empty(0, np.uint64)
    c = np.concatenate(cs) if cs else np.empty(0, np.int64)
    order = np.argsort(k)
    return k[order], c[order], hist


# -- phases ---------------------------------------------------------------


def phase_device(cards: int):
    """Phase 1: the card, its limits, and what the program loaded."""
    import jax

    devs = jax.devices()
    d = devs[0]
    require(d.platform == "gpu", f"default JAX device is {d.platform}, not gpu")
    require(len(devs) >= cards, f"{len(devs)} devices, {cards} needed")
    from dsk_tpu.dist.engine import persistent_cache_dir
    from dsk_tpu.io import native

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    try:
        import h5py  # noqa: F401

        h5 = True
    except ImportError:
        h5 = False
    say(f"phase1 device kind={d.device_kind} count={len(devs)} "
        f"native_io={native.available()} h5py_importable={h5} "
        f"cache_dir={persistent_cache_dir()}")
    say(f"nvidia-smi: {smi[0]}")
    return devs


def _value_words(vals: np.ndarray, W: int) -> np.ndarray:
    """(W, n) big-endian uint32 words of the oracle's python-int values."""
    raw = b"".join(int(v).to_bytes(4 * W, "big") for v in vals)
    return np.frombuffer(raw, ">u4").reshape(-1, W).T.astype(np.uint32)


def phase_extraction(rows: int = 2048, row_len: int = 1024,
                     ks=(15, 16, 21, 27, 31, 32, 33, 63, 64, 65, 127),
                     seed: int = 1) -> None:
    """Phase 2: device extraction vs kmer/codec.canonical_windows, every
    window of every row."""
    import jax

    from dsk_tpu.kmer import codec
    from dsk_tpu.kmer.device import extract_canonical_planes

    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (rows, row_len), dtype=np.uint8)
    codes[rng.random(codes.shape) < 0.03] = 4
    dev_codes = jax.device_put(codes)
    for k in ks:
        t0 = time.perf_counter()
        planes, valid = jax.block_until_ready(
            extract_canonical_planes(dev_codes, k)
        )
        planes, valid = np.asarray(planes), np.asarray(valid)
        W = planes.shape[0]
        n_valid = 0
        for r in range(rows):
            want, ok = codec.canonical_windows(codes[r], k)
            require(np.array_equal(valid[r], ok),
                    f"extraction k={k} row {r}: validity differs")
            got = planes[:, r, :]
            require(bool(np.all(got[:, ~ok] == 0xFFFFFFFF)),
                    f"extraction k={k} row {r}: invalid window not sentinel")
            if k <= 32:
                v = got[0].astype(np.uint64)
                if W == 2:
                    v = (v << np.uint64(32)) | got[1]
                same = np.array_equal(v[ok], np.asarray(want)[ok])
            else:
                same = np.array_equal(got[:, ok], _value_words(want[ok], W))
            require(same, f"extraction k={k} row {r}: values differ")
            n_valid += int(ok.sum())
        say(f"phase2 extraction k={k} rows_checked={rows} "
            f"valid_windows={n_valid} exact=True "
            f"s={time.perf_counter() - t0:.3f}")


def _run(work: str, name: str, **kw):
    from dsk_tpu.engine.run import RunParams, execute

    kw.setdefault("verbose", 0)
    t0 = time.perf_counter()
    out = execute(RunParams(out=os.path.join(work, name), **kw))
    return out, time.perf_counter() - t0


def _same_file(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def golden_bigk_bank(path: str) -> None:
    """Deterministic k=127 bank: 24 reads x 600 bp of a 6 kbase genome."""
    rng = np.random.default_rng(20260820)
    genome = rng.integers(0, 4, size=6000, dtype=np.uint8)
    with open(path, "w") as f:
        for i in range(24):
            start = int(rng.integers(0, 5400))
            seq = LETTERS[genome[start : start + 600]].tobytes().decode()
            f.write(f">r{i}\n{seq}\n")


def phase_goldens(work: str, names=None, engine: str = "auto") -> None:
    """Phase 3: the reference's golden fixtures through execute()."""
    from dsk_tpu import oracle
    from dsk_tpu.cli import dsk2ascii
    from dsk_tpu.store.output import OutputStore

    d = DATA
    comma = ",".join(os.path.join(d, f"c{i}.fasta.gz") for i in range(1, 5))
    histo_gates = {
        "read50x": (os.path.join(d, "read50x_ref10K_e001.fasta.gz"), 27,
                    "k27.histo"),
        "read50x_c1c4": (comma, 27, "k27.histo"),
        "rlong": (os.path.join(d, "longread.fasta"), 27, "rlong.histo"),
        "readN": (os.path.join(d, "readN.fasta"), 20, "readN.histo"),
    }
    names = names or [*histo_gates, "short", "bigk"]
    for name in names:
        if name in histo_gates:
            uri, k, fix = histo_gates[name]
            out, s = _run(work, name, file=uri, kmer_size=k, histo=True,
                          engine=engine)
            require(_same_file(out.histo_path, os.path.join(d, fix)),
                    f"golden {name}: histogram differs from {fix}")
        elif name == "short":
            out, s = _run(work, name, file=os.path.join(d, "shortread.fasta"),
                          kmer_size=15, abundance_min=1, engine=engine)
            txt = os.path.join(work, "short.txt")
            require(dsk2ascii.main(
                ["-file", out.store_path, "-out", txt, "-verbose", "0"]
            ) == 0, "golden short: dsk2ascii failed")
            with open(txt) as f:
                got = sorted(ln.strip() for ln in f if ln.strip())
            with open(os.path.join(d, "short.parse_results")) as f:
                want = sorted(ln.strip() for ln in f if ln.strip())
            require(got == want, "golden short: dump differs from "
                    "short.parse_results")
        elif name == "bigk":
            bank = os.path.join(work, "bigk.fasta")
            golden_bigk_bank(bank)
            out, s = _run(work, name, file=bank, kmer_size=127,
                          abundance_min=1, engine=engine)
            with OutputStore.load(out.store_path) as st:
                got = dict(st.iter_items())
            want = oracle.count_bank(bank, 127)
            require(got == want, "golden bigk: table differs from oracle")
        else:
            raise ValueError(name)
        say(f"phase3 golden {name} match=True "
            f"chips={out.info.get('n_chips')} s={s:.1f}")


def phase_exact(work: str, mbases: int = 64, genome_mb: int = 5,
                legs=(("hash", "off"), ("hash", "on")),
                engine: str = "auto", seed: int = 4) -> None:
    """Phase 4: reads on disk -> execute() -> store, vs the numpy oracle."""
    n_reads = mbases * 1_000_000 // READ_LEN
    t0 = time.perf_counter()
    reads = make_reads(n_reads, genome_mb * 1_000_000, 0.005, seed)
    path = os.path.join(work, f"exact_{mbases}M.fastq.gz")
    write_fastq_gz(path, reads)
    kk, cc = oracle_counts(reads, 27)
    del reads
    want_hist = oracle_histogram(cc)
    solid = cc >= 3
    want_k, want_c = kk[solid], cc[solid]
    say(f"phase4 input {mbases} Mbases, {kk.shape[0]} distinct, "
        f"{int(solid.sum())} solid (set-up {time.perf_counter() - t0:.1f}s)")
    for routing, spill in legs:
        out, s = _run(
            work, f"exact_{routing}_{spill}", file=path, kmer_size=27,
            abundance_min=3, spill=spill, engine=engine,
            minimizer_type=1 if routing == "superkmer" else 0,
            out_tmp=work,
        )
        if spill == "off":  # spill fill is collective-free: no routing
            require(out.info.get("routing") == routing,
                    f"phase4: ran {out.info.get('routing')} routing, "
                    f"not {routing}")
        got_k, got_c, got_hist = store_table(out.store_path)
        require(np.array_equal(got_hist, want_hist),
                f"phase4 {routing}/spill {spill}: histogram differs")
        require(np.array_equal(got_k, want_k) and np.array_equal(got_c, want_c),
                f"phase4 {routing}/spill {spill}: solid table differs")
        cfg = out.info["config"]
        say(f"phase4 exact routing={routing} spill={spill} exact=True "
            f"routing_used={out.info.get('routing')} "
            f"passes={cfg['nb_passes']} spill_used={cfg.get('spill')} "
            f"chips={out.info.get('n_chips')} s={s:.1f}")


def phase_scale(work: str, mbases: int = SCALE_MBASES, genome_mb: int = 20,
                engine: str = "auto", seed: int = 5) -> None:
    """Phase 5: >= 1 Gbase end to end; histogram invariants."""
    import jax

    n_reads = mbases * 1_000_000 // READ_LEN
    t0 = time.perf_counter()
    reads = make_reads(n_reads, genome_mb * 1_000_000, 0.005, seed)
    path = os.path.join(work, f"scale_{mbases}M.fastq.gz")
    write_fastq_gz(path, reads)
    del reads
    windows = n_reads * (READ_LEN - 27 + 1)  # reads hold ACGT only
    say(f"phase5 input {mbases} Mbases written "
        f"(set-up {time.perf_counter() - t0:.1f}s)")
    out, s = _run(work, "scale", file=path, kmer_size=27, abundance_min=3,
                  engine=engine, out_tmp=work)
    hist = out.result.histogram
    a = np.arange(hist.shape[0], dtype=np.int64)
    require(int(hist[HISTO_MAX]) == 0, "phase5: abundance past histo-max")
    require(int((a * hist).sum()) == windows,
            "phase5: sum a*h(a) differs from the valid window count")
    require(out.n_solid == int(hist[3:].sum()),
            "phase5: n_solid differs from sum of h(a), a >= 3")
    peak = max(
        (dv.memory_stats() or {}).get("peak_bytes_in_use", 0)
        for dv in jax.devices()
    )
    bases = n_reads * READ_LEN
    say(f"phase5 scale bases={bases} distinct={int(hist[1:].sum())} "
        f"solid={out.n_solid} invariants=True")
    say(f"phase5 e2e_s={s:.3f} bases_per_s={bases / s:.1f} "
        f"compile_s={out.info['time'].get('compile')} "
        f"passes={out.info['config']['nb_passes']} "
        f"spill={out.info['config'].get('spill')} "
        f"chips={out.info.get('n_chips')} peak_bytes_in_use={peak} "
        f"phases={out.info['time']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1, choices=[1, 4],
                    help="4: run only the four-card path")
    args = ap.parse_args(argv)

    devs = phase_device(args.cards)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        if args.cards == 1:
            phase_extraction()
            phase_goldens(work)
            phase_exact(work)
        else:
            phase_goldens(work, names=["read50x"])
            phase_exact(work, legs=(("hash", "off"), ("hash", "on"),
                                    ("superkmer", "off")))
        phase_scale(work)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
