#!/bin/bash
# Real-data exactness gate (the reference's strongest parity oracle,
# /root/reference/test/test_ERR039477.sh): download run ERR039477 from
# EBI, count with PURE DEFAULTS (k=31, abundance-min=2 — exactly
# `dsk -file ERR039477.fastq.gz`, reference line 11), dump, and DIFF.
#
# Comparison contract (documented design decision, SURVEY.md §7.2 item 3):
# the reference's committed md5 (test/ERR039477.md5 =
# 9e0327344593cfefb0f8957017297bfe) is over dsk2ascii's PARTITION-ORDER
# dump; dsk_tpu's partition count/order differs by design (partitions =
# owner chips, not disk files), so the normative oracle here is the
# SORTED (kmer, count) SET:
#   1. the sorted dump is diffed byte-for-byte against the trusted Python
#      oracle (dsk_tpu.oracle — itself pinned by every reference fixture)
#      run on the same downloaded file -> machine-checked exactness;
#   2. the sorted-dump md5 is compared against
#      tests/data/ERR039477.sorted.md5 when that file exists (commit it
#      from the first network-enabled verified run);
#   3. equivalence to the reference md5 then follows because dsk2ascii
#      dumps are permutations of the same (kmer, count) lines.
#
# SKIPs (exit 0) ONLY when the download fails (zero-egress environment);
# any comparison mismatch is a hard failure.

set -e
cd "$(dirname "$0")/.."

URL="ftp://ftp.sra.ebi.ac.uk/vol1/fastq/ERR039/ERR039477/ERR039477.fastq.gz"
F=/tmp/ERR039477.fastq.gz

if [ ! -f "$F" ]; then
    echo "downloading ERR039477..."
    if ! timeout 600 wget -q -O "$F" "$URL"; then
        echo "SKIP: no network access (zero-egress environment)"
        rm -f "$F"
        exit 0
    fi
fi

# reference defaults: only -file is given a value; -out for a stable path
python -m dsk_tpu.cli.dsk -file "$F" -out /tmp/ERR039477 -verbose 1
python -m dsk_tpu.cli.dsk2ascii -file /tmp/ERR039477.dsk -out /tmp/ERR039477.txt

LC_ALL=C sort /tmp/ERR039477.txt > /tmp/ERR039477.sorted.txt
md5sum /tmp/ERR039477.sorted.txt | awk '{print $1}' > /tmp/ERR039477.sorted.md5
echo "sorted dump md5: $(cat /tmp/ERR039477.sorted.md5) ($(wc -l < /tmp/ERR039477.sorted.txt) kmers)"

# 1) oracle diff (the hard gate)
python - <<'EOF'
from dsk_tpu.oracle import count_bank
from dsk_tpu.kmer import codec

oracle = count_bank("/tmp/ERR039477.fastq.gz", 31)
expected = sorted(
    f"{codec.kmer_to_string(v, 31)} {c}"
    for v, c in oracle.items()
    if c >= 2  # default -abundance-min
)
got = [ln.rstrip("\n") for ln in open("/tmp/ERR039477.sorted.txt")]
assert got == expected, (
    f"dump mismatch: {len(got)} lines vs oracle {len(expected)}"
)
print(f"oracle diff OK ({len(got)} solid kmers)")
EOF

# 2) pinned-md5 regression (when committed)
if [ -f tests/data/ERR039477.sorted.md5 ]; then
    if ! diff -q /tmp/ERR039477.sorted.md5 tests/data/ERR039477.sorted.md5; then
        echo "FAIL: sorted-dump md5 changed vs pinned tests/data/ERR039477.sorted.md5"
        exit 1
    fi
    echo "pinned md5 OK"
else
    echo "note: tests/data/ERR039477.sorted.md5 not committed yet; commit"
    echo "      /tmp/ERR039477.sorted.md5 after verifying against reference dsk"
fi
echo "PASS"
