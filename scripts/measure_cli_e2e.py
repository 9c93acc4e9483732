"""End-to-end CLI measurement: 100 Mbase fastq.gz -> count phase Mbases/s.

The apples-to-apples number against the reference's end-to-end CPU
figures (BASELINE.md: 2.2 Mbases/s 1-thread, 12.7 best cell): full tool
path off disk — gunzip + parse + pack + H2D + device count — via
RunParams/execute with per-phase timers.

Generates the input once (synthetic 5 Mbase genome, ~170 bp reads,
~20x coverage — the shape of a real short-read run) and caches it.

Repeat the run before believing a difference (host clocks vary more
than device clocks on a shared host).

Usage: python scripts/measure_cli_e2e.py [n_mbases] [k]
"""

import gzip
import json
import pathlib
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

CACHE = pathlib.Path(tempfile.gettempdir()) / "dsk_tpu_e2e"


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def make_input(n_mbases: int) -> pathlib.Path:
    path = CACHE / f"reads{n_mbases}M.fastq.gz"
    if path.exists():
        return path
    CACHE.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(7)
    genome_n = n_mbases * 50_000  # 20x coverage
    genome = rng.choice(np.frombuffer(b"ACGT", np.uint8), genome_n)
    read_len = 170
    n_reads = n_mbases * 1_000_000 // read_len
    log(f"generating {path} ({n_reads} x {read_len} bp)...")
    qual = b"I" * read_len
    with gzip.open(path, "wb", compresslevel=1) as f:
        for i in range(n_reads):
            s = int(rng.integers(0, genome_n - read_len))
            f.write(
                b"@r%d\n%s\n+\n%s\n"
                % (i, genome[s : s + read_len].tobytes(), qual)
            )
    return path


def main():
    n_mbases = int(sys.argv[1]) if len(sys.argv) > 1 else 100
    k = int(sys.argv[2]) if len(sys.argv) > 2 else 31

    from dsk_tpu.utils.hostmem import tune_malloc

    tune_malloc()
    inp = make_input(n_mbases)

    from dsk_tpu.engine.run import RunParams, execute

    t0 = time.time()
    out = execute(
        RunParams(
            file=str(inp),
            kmer_size=k,
            out=str(CACHE / "e2e_out"),
            verbose=2,
            histo=True,
        )
    )
    wall = time.time() - t0
    info = out.info
    t_count = float(info["time"].get("count", "nan"))
    print(
        json.dumps(
            {
                "wall_s": round(wall, 2),
                "time": info.get("time"),
                "n_bases": info.get("n_bases"),
                "n_distinct": info.get("nb_distinct_kmers"),
                "t_stream": info.get("t_stream"),
                "t_sub": info.get("t_sub"),
                "t_gather": info.get("t_gather"),
                "count_mbases_per_s": round(
                    info.get("n_bases", 0) / 1e6 / t_count, 2
                ),
            },
            indent=1,
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
