"""Whole-file record loading.

Behavior parity with the reference's ``load_reads``
(reference: ribodetector/data_loader/seq_encoder.py:56-72, inference path
only -- the training-era ``label`` branch is a separate tool concern and
intentionally not replicated here).
"""

from ribodetector_tpu_torch.io.fastx import open_seq_file, seq_parser


def load_reads(seq_file):
    """Load every record of a sequence file into a list."""
    fh, seq_type = open_seq_file(seq_file)
    with fh:
        return list(seq_parser(fh, seq_type))
