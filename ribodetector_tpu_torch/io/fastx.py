"""Streaming FASTQ/FASTA parsing.

Behavior parity with the reference parser
(reference: ribodetector/data_loader/fastx_parser.py:15-55):

- FASTQ records are yielded as 4-tuples ``(header, seq, plus, qual)``, each
  line ``rstrip()``-ed. The sequence is **not** uppercased (quirk preserved:
  lowercase bases later encode to the zero vector, fastx_parser.py:26-27).
- FASTA records are yielded as 2-tuples ``(header, seq)``; sequence lines are
  ``strip()``-ed, concatenated across lines and **uppercased**
  (fastx_parser.py:53). Blank lines are skipped. A record started mid-file is
  yielded (even with an empty sequence) as soon as the next ``>`` header is
  seen; a trailing record with an empty sequence is dropped
  (fastx_parser.py:54-55).

Divergences (documented; malformed inputs only):

- FASTQ with stray blank/junk lines between records: the reference's state
  machine produces garbage records or raises IndexError; this parser skips
  blank lines at record boundaries and raises a clear ValueError on
  truncated records.
- FASTQ zero-length reads (``@r\\n\\n+\\n\\n``): the reference raises
  IndexError on any empty line; this parser yields the empty-seq record.
- FASTA pre-header sequence lines / headerless files: this parser matches
  the reference exactly (prepend to record 1 / a final ``('', seq)``
  record), but the NATIVE FASTA chunk parser drops pre-header junk.

Well-formed files parse identically everywhere.
"""

import gzip
from functools import partial

from ribodetector_tpu_torch.io.format import get_seq_format


def seq_parser(seq_fh, seq_type):
    """Yield records from an open text file handle.

    seq_type: "fastq" -> 4-tuples, anything else -> FASTA 2-tuples.
    """
    if seq_type == "fastq":
        it = iter(seq_fh)
        for header in it:
            header = header.rstrip()
            if not header:
                continue  # skip blank lines at record boundaries
            try:
                seq = next(it).rstrip()
                plus = next(it).rstrip()
                qual = next(it).rstrip()
            except StopIteration:
                raise ValueError(
                    "Truncated FASTQ record at end of file: {!r}".format(header)
                ) from None
            yield header, seq, plus, qual
    else:
        # reference-exact state machine (fastx_parser.py:38-55) including
        # its malformed-input quirks: `header` starts as '' (NOT None), so
        # sequence lines BEFORE the first '>' accumulate and prepend to
        # record 1 (the first header does not reset seq), and a headerless
        # file yields one ('', seq) record at EOF. The native FASTA parser
        # drops such pre-header junk instead (documented divergence,
        # malformed inputs only -- FastaChunkStream._eof_no_record).
        header = ""
        parts = []
        for line in seq_fh:
            line = line.strip()
            if not line:
                continue
            if line[0] == ">":
                if header:
                    yield header, "".join(parts)
                    parts = []
                header = line
            else:
                parts.append(line.upper())
        if parts:
            # trailing record with an empty sequence is dropped
            # (fastx_parser.py:54-55); parts holds only non-empty lines,
            # so the join is non-empty by construction
            yield header, "".join(parts)


def open_seq_file(seq_file):
    """Open a (possibly gzipped) sequence file for text reading.

    Returns (file_handle, seq_type) where seq_type is "fastq" or "fasta".
    Mirrors the open logic used throughout the reference
    (seq_encoder.py:44-47,59-61,77-79).
    """
    seq_format = get_seq_format(seq_file)
    # latin-1, NOT the locale default: input files are byte streams (the
    # native path and records_from_chunk_bytes already pin latin-1), so a
    # stray 0xE9 in a header must neither crash under a UTF-8 locale nor
    # decode two bytes into one char (which would change token counts
    # between the portable and native paths)
    if seq_format.endswith("gz"):
        _open = partial(gzip.open, mode="rt", encoding="latin-1")
    else:
        _open = partial(open, encoding="latin-1")
    seq_type = "fasta" if seq_format.startswith("fa") else "fastq"
    return _open(seq_file), seq_type


class _Records:
    """Iterator over a sequence file's records that owns the open file: it
    closes the file at the end of the records, on close(), on leaving a
    ``with`` block, or when it is dropped -- also when iteration never
    started (a generator's own ``with`` would only close a file it had
    entered)."""

    def __init__(self, fh, seq_type):
        self._fh = fh
        self._records = seq_parser(fh, seq_type)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self._records)
        except BaseException:
            self.close()
            raise

    def close(self):
        self._records.close()
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()


def parse_file(seq_file):
    """Stream all records of a sequence file (handles gzip + format
    sniffing). Validation and the open happen EAGERLY at call time -- a
    bad extension or missing file errors here, not at the first next().
    The returned iterator closes the file when exhausted, closed or
    dropped, started or not."""
    fh, seq_type = open_seq_file(seq_file)
    return _Records(fh, seq_type)
