from ribodetector_tpu_torch.io.format import get_seq_format
from ribodetector_tpu_torch.io.fastx import seq_parser, parse_file, open_seq_file
from ribodetector_tpu_torch.io.chunks import load_reads

__all__ = [
    "get_seq_format",
    "seq_parser",
    "parse_file",
    "open_seq_file",
    "load_reads",
]
