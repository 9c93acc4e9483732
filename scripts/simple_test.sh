#!/bin/bash
# Golden-fixture end-to-end suite: the dsk_tpu mirror of the reference's
# scripts/simple_test.sh (same six tests, same fixtures, driven through
# the CLI tools; the pytest suite covers these and more — this script is
# the shell-level parity check).

set -u
cd "$(dirname "$0")/.."
export PYTHONPATH="$PWD${PYTHONPATH:+:$PYTHONPATH}"
export JAX_PLATFORMS="${DSK_TEST_PLATFORM:-cpu}"
DATA=tests/data
TMP=$(mktemp -d)
trap 'rm -rf "$TMP"' EXIT
DSK="python -m dsk_tpu.cli.dsk"
DSK2ASCII="python -m dsk_tpu.cli.dsk2ascii"
DSKDUMP="python -m dsk_tpu.cli.dskdump"
RET=0

check() {  # name, status
    if [ "$2" -eq 0 ]; then echo "PASSED: $1"; else echo "FAILED: $1"; RET=1; fi
}

# 1. single gzipped file, k=27, histogram vs k27.histo
# (reference-exact invocation: DEFAULT abundance-min, -max-memory 200 —
# /root/reference/scripts/simple_test.sh:36; the histogram must count
# ALL distinct kmers regardless of the solidity threshold)
$DSK -file $DATA/read50x_ref10K_e001.fasta.gz -kmer-size 27 \
    -out "$TMP/t1" -max-memory 200 -verbose 0
$DSKDUMP -y -d histogram/histogram "$TMP/t1.dsk" > "$TMP/t1.histo"
diff -q "$TMP/t1.histo" $DATA/k27.histo > /dev/null
check "one gzipped fasta file" $?

# 2. multiple gzipped files (comma list) == same histogram
$DSK -file $DATA/c1.fasta.gz,$DATA/c2.fasta.gz,$DATA/c3.fasta.gz,$DATA/c4.fasta.gz \
    -kmer-size 27 -out "$TMP/t2" -max-memory 200 -verbose 0
$DSKDUMP -y -d histogram/histogram "$TMP/t2.dsk" > "$TMP/t2.histo"
diff -q "$TMP/t2.histo" $DATA/k27.histo > /dev/null
check "multiple gzipped fasta files" $?

# 3. long reads, k=27 vs rlong.histo
$DSK -file $DATA/longread.fasta -kmer-size 27 \
    -out "$TMP/t3" -max-memory 200 -verbose 0
$DSKDUMP -y -d histogram/histogram "$TMP/t3.dsk" > "$TMP/t3.histo"
diff -q "$TMP/t3.histo" $DATA/rlong.histo > /dev/null
check "long reads" $?

# 4. k == read length (needs -abundance-min 1), exact ascii dump
$DSK -file $DATA/shortread.fasta -kmer-size 15 -abundance-min 1 \
    -out "$TMP/t4" -verbose 0
$DSK2ASCII -file "$TMP/t4.dsk" -out "$TMP/t4.txt" -verbose 0
diff -q "$TMP/t4.txt" $DATA/short.parse_results > /dev/null
check "kmer size == read size" $?

# 5. k == read length + 1: runs cleanly, zero solid kmers
$DSK -file $DATA/shortread.fasta -kmer-size 16 -out "$TMP/t5" -verbose 0
N=$($DSK2ASCII -file "$TMP/t5.dsk" -c -verbose 0 | wc -l)
[ "$N" -eq 0 ]; check "kmer size > read size" $?

# 6. reads with N: split-at-invalid semantics vs readN.histo
$DSK -file $DATA/readN.fasta -kmer-size 20 \
    -out "$TMP/t6" -max-memory 200 -verbose 0
$DSKDUMP -y -d histogram/histogram "$TMP/t6.dsk" > "$TMP/t6.histo"
diff -q "$TMP/t6.histo" $DATA/readN.histo > /dev/null
check "reads with N" $?

exit $RET
