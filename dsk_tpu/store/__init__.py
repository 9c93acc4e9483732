"""Self-describing output store + text dump tools.

Replaces the reference's Storage/StorageHDF5/Group/Partition/Collection
stack (gatb-core tools/storage, SURVEY.md C8) and the histogram/text
writers (C12).  Layout mirrors the reference contract (README.md:77-78):

    dsk/solid/<i>        per-partition (kmer, abundance) datasets
    histogram/histogram  (index, abundance) pairs
    dsk attrs            kmer_size, nb_words, xml / json run info
"""

from dsk_tpu.store.output import OutputStore  # noqa: F401
