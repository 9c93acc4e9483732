"""CLI tools: `dsk` and `dsk2ascii` equivalents.

Flag surface matches the reference (SURVEY.md section 2.2 CLI list), with
single-dash long options exactly like the gatb OptionsParser
(e.g. `-file`, `-kmer-size`, `-abundance-min`).

Usage:
    python -m dsk_tpu.cli.dsk -file reads.fasta.gz -kmer-size 27 -out out
    python -m dsk_tpu.cli.dsk2ascii -file out.dsk -out out.txt
"""
