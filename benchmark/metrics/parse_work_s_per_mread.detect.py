"""parse_work_s_per_mread.detect: StageTimer "parse_work" (the native FASTQ or FASTA parser
over one window of input) seconds summed over every worker role and thread that times it,
per 10^6 reads of the unprofiled stretch."""

from harness.readers import per_mread


def read(rec):
    return per_mread(rec, "*:parse_work")
