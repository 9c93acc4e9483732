"""Per-pass checkpoint sidecar for multi-pass runs.

The reference has NO mid-run checkpoint (a crashed run is rerun,
SURVEY.md section 5.3); its bounded-resource multi-pass design is the
implicit recovery story.  Here each completed pass's disjoint table is
persisted to `<prefix>.ckpt` (a store/container.py directory), so a
resumed run (-resume) recounts only the missing passes.  The sidecar is
deleted on successful completion.

Fingerprint guard: a checkpoint is only reused when (input uri, k,
n_passes, engine shape knobs) match — otherwise it is discarded.
"""

from __future__ import annotations

import json
import os

import numpy as np

from dsk_tpu.engine.counter import CountResult
from dsk_tpu.store import container


def _fingerprint(params, n_passes: int) -> str:
    return json.dumps(
        {
            "file": params.file,
            "k": params.kmer_size,
            "n_passes": n_passes,
            "batch_rows": params.batch_rows,
            "row_len": params.row_len,
            "histo_max": params.histo_max,
            # per-bank-relevant flags: a resumed pass must have the same
            # bank_counts presence/shape as a fresh one, or the final merge
            # concatenates None with arrays (ADVICE.md r1 item 3)
            "solidity_kind": params.solidity_kind,
            "solidity_custom": params.solidity_custom,
            "histo2d": params.histo2d,
            "engine": params.engine,
        },
        sort_keys=True,
    )


class PassCheckpoint:
    def __init__(self, path: str, params, n_passes: int):
        self.path = path
        self.fingerprint = _fingerprint(params, n_passes)

    def load(self) -> dict[int, CountResult]:
        """Completed pass results, {} if absent or fingerprint mismatch."""
        if not os.path.exists(self.path):
            return {}
        out: dict[int, CountResult] = {}
        try:
            f = container.Container(self.path, "r")
            if f.attrs.get("fingerprint") != self.fingerprint:
                return {}
            k = int(f.attrs["k"])
            nb_bins = int(f.attrs["nb_bins"])
            for name in f:
                p = int(name.split("_")[1])
                g = f[name]
                hist = np.zeros(nb_bins + 1, np.int64)
                rec = g["histogram"][:]
                hist[: rec.shape[0]] = rec
                out[p] = CountResult(
                    k=k,
                    kmers=g["kmers"][:],
                    counts=g["counts"][:],
                    histogram=hist,
                    bank_counts=(
                        g["bank_counts"][:] if "bank_counts" in g else None
                    ),
                    info=json.loads(g.attrs["info"]),
                )
        except (OSError, KeyError, ValueError):
            return {}
        return out

    def save_pass(self, p: int, res: CountResult) -> None:
        mode = "a" if os.path.exists(self.path) else "w"
        f = container.Container(self.path, mode)
        if mode == "w" or "fingerprint" not in f.attrs:
            f.attrs["fingerprint"] = self.fingerprint
            f.attrs["k"] = res.k
            f.attrs["nb_bins"] = res.histogram.shape[0] - 1
        name = f"pass_{p}"
        if name in f:
            del f[name]
        g = f.create_group(name)
        g.create_dataset("kmers", data=res.kmers)
        g.create_dataset("counts", data=res.counts)
        g.create_dataset("histogram", data=res.histogram)
        if res.bank_counts is not None:
            g.create_dataset("bank_counts", data=res.bank_counts)
        g.attrs["info"] = json.dumps(res.info, default=str)

    def remove(self) -> None:
        container.remove(self.path)
