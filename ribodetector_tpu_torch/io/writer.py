"""Output writers.

The reference's ``open_for_write`` (ribodetector/detect.py:729-741,
detect_cpu.py:742-754) picks gzip when the filename ends with "gz" and
plain text otherwise; so does ``open_for_write_bytes``. The runtime writes
records as verbatim byte ranges of the input, so header/+/qual lines pass
through unchanged (quirk #11).
"""


def open_for_write_bytes(read_file: str, gz_level=None):
    """Open an output file for the native byte-gather writers, binary,
    chosen by its extension. gz outputs go through
    io.gzfast.MemberGzipWriter: libdeflate level 3 by default, which
    matches the reference's zlib level 5 compression ratio at ~3.5x the
    speed (gzfast module docstring); each batch payload is an independent
    gzip member, which concatenates into a valid gzip file. gz_level
    overrides the libdeflate level (--gz-level: 1 = fastest deflate when
    the write stage bottlenecks)."""
    if read_file.endswith("gz"):
        from ribodetector_tpu_torch.io.gzfast import MemberGzipWriter

        return MemberGzipWriter(open(read_file, "wb"), level=gz_level)
    return open(read_file, "wb")
