"""ctypes loader for the native FASTQ/FASTA parsers + encoders (fastx.cpp).

The shared object is built on first use with g++ into the package's
``_build/`` directory (ops/build.py; plain C ABI, no Python headers). The
port has no portable fallback path: when the parser cannot be built, the
first use raises and names the cause.
"""

import ctypes
import threading

import numpy as np

_lib = None
_lock = threading.Lock()


def _load():
    """The loaded parser library (built on first use); raises with the
    compiler's output when it cannot be built."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        from ribodetector_tpu_torch.ops.build import build_fastx

        path, _ = build_fastx()
        lib = ctypes.CDLL(path)
        i64 = ctypes.c_int64
        p = ctypes.POINTER
        lib.rd_parse_fastq.restype = i64
        lib.rd_parse_fastq.argtypes = [
            ctypes.c_char_p, i64, ctypes.c_int32, i64, ctypes.c_int32,
            p(ctypes.c_int64), p(ctypes.c_uint8), p(ctypes.c_int32),
            p(ctypes.c_uint8), p(ctypes.c_int64),
        ]
        lib.rd_parse_fastq_b5.restype = i64
        lib.rd_parse_fastq_b5.argtypes = [
            ctypes.c_char_p, i64, ctypes.c_int32, i64, ctypes.c_int32,
            ctypes.c_int32,
            p(ctypes.c_int64), p(ctypes.c_uint8), p(ctypes.c_int32),
            p(ctypes.c_uint8), p(ctypes.c_int64),
        ]
        lib.rd_parse_fastq_b5b2.restype = i64
        lib.rd_parse_fastq_b5b2.argtypes = [
            ctypes.c_char_p, i64, ctypes.c_int32, i64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
            p(ctypes.c_int64), p(ctypes.c_uint8), p(ctypes.c_uint8),
            p(ctypes.c_int32), p(ctypes.c_uint8), p(ctypes.c_uint8),
            p(ctypes.c_int64),
        ]
        lib.rd_parse_fasta_b5.restype = i64
        lib.rd_parse_fasta_b5.argtypes = [
            ctypes.c_char_p, i64, ctypes.c_int32,
            i64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_char_p, i64,
            p(ctypes.c_int64), p(ctypes.c_uint8), p(ctypes.c_int32),
            p(ctypes.c_int64), p(ctypes.c_int64),
        ]
        lib.rd_gather_records.restype = i64
        lib.rd_gather_records.argtypes = [
            ctypes.c_char_p, p(ctypes.c_int64), p(ctypes.c_int64), i64,
            ctypes.c_char_p,
        ]
        lib.rd_selection_size.restype = i64
        lib.rd_selection_size.argtypes = [p(ctypes.c_int64), p(ctypes.c_int64), i64]
        _lib = lib
        return _lib


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def b5_packed_len(max_len: int) -> int:
    """Bytes per base-5-packed token row (3 tokens per byte)."""
    return (max_len + 2) // 3


def b2_packed_len(max_len: int) -> int:
    """Bytes per 2-bit-packed token row (4 tokens per byte; clean
    ACGTU-only full-length reads, see ops/dispatch.unpack_b2_tokens)."""
    return (max_len + 3) // 4


def parse_fastq_chunk(data: bytes, max_len: int, at_eof=True):
    """Parse+encode a decompressed FASTQ byte buffer in one native pass.

    Returns (offsets [n,2] int64, tokens [n,max_len] uint8, lengths [n] int32,
    clean [n] uint8, consumed int). `consumed` is the resume offset past the
    last complete record (tail bytes belong to the next chunk). at_eof
    finalizes an unterminated final record (default: whole-buffer use).
    """
    lib = _load()
    n = len(data)
    max_records = data.count(b"\n") // 4 + 2
    offsets = np.empty((max_records, 2), np.int64)
    tokens = np.empty((max_records, max_len), np.uint8)
    lengths = np.empty(max_records, np.int32)
    clean = np.empty(max_records, np.uint8)
    consumed = np.zeros(1, np.int64)
    nrec = lib.rd_parse_fastq(
        data, n, 1 if at_eof else 0, max_records, max_len,
        _ptr(offsets, ctypes.c_int64), _ptr(tokens, ctypes.c_uint8),
        _ptr(lengths, ctypes.c_int32), _ptr(clean, ctypes.c_uint8),
        _ptr(consumed, ctypes.c_int64),
    )
    return (
        offsets[:nrec],
        tokens[:nrec],
        lengths[:nrec],
        clean[:nrec],
        int(consumed[0]),
    )


def parse_fastq_chunk_b5(data: bytes, max_len: int, at_eof=True):
    """Like parse_fastq_chunk but tokens come back base-5 packed
    ([n, (max_len+2)//3] uint8, 3 tokens/byte, pad trio byte = 124)."""
    lib = _load()
    n = len(data)
    max_records = data.count(b"\n") // 4 + 2
    pl = b5_packed_len(max_len)
    offsets = np.empty((max_records, 2), np.int64)
    packed = np.empty((max_records, pl), np.uint8)
    lengths = np.empty(max_records, np.int32)
    clean = np.empty(max_records, np.uint8)
    consumed = np.zeros(1, np.int64)
    nrec = lib.rd_parse_fastq_b5(
        data, n, 1 if at_eof else 0, max_records, max_len, pl,
        _ptr(offsets, ctypes.c_int64), _ptr(packed, ctypes.c_uint8),
        _ptr(lengths, ctypes.c_int32), _ptr(clean, ctypes.c_uint8),
        _ptr(consumed, ctypes.c_int64),
    )
    return (
        offsets[:nrec],
        packed[:nrec],
        lengths[:nrec],
        clean[:nrec],
        int(consumed[0]),
    )


def parse_fastq_chunk_b5b2(data: bytes, max_len: int, at_eof=True):
    """Like parse_fastq_chunk_b5 but additionally returns the 2-bit packed
    rows and the per-record b2ok eligibility flag (clean ACGTU call at full
    max_len length -- see fastx.cpp rd_parse_fastq_b5b2)."""
    lib = _load()
    n = len(data)
    max_records = data.count(b"\n") // 4 + 2
    pl = b5_packed_len(max_len)
    pl2 = b2_packed_len(max_len)
    offsets = np.empty((max_records, 2), np.int64)
    packed = np.empty((max_records, pl), np.uint8)
    packed2 = np.empty((max_records, pl2), np.uint8)
    lengths = np.empty(max_records, np.int32)
    clean = np.empty(max_records, np.uint8)
    b2ok = np.empty(max_records, np.uint8)
    consumed = np.zeros(1, np.int64)
    nrec = lib.rd_parse_fastq_b5b2(
        data, n, 1 if at_eof else 0, max_records, max_len, pl, pl2,
        _ptr(offsets, ctypes.c_int64), _ptr(packed, ctypes.c_uint8),
        _ptr(packed2, ctypes.c_uint8), _ptr(lengths, ctypes.c_int32),
        _ptr(clean, ctypes.c_uint8), _ptr(b2ok, ctypes.c_uint8),
        _ptr(consumed, ctypes.c_int64),
    )
    return (
        offsets[:nrec],
        packed[:nrec],
        packed2[:nrec],
        lengths[:nrec],
        clean[:nrec],
        b2ok[:nrec],
        int(consumed[0]),
    )


def pack_b2(tokens: np.ndarray) -> np.ndarray:
    """numpy twin of the native 2-bit packer: [B, T] uint8 tokens (all
    REQUIRED < 4) -> [B, (T+3)//4] uint8, 4 tokens/byte little-endian
    (tail slots pack as 0; unpack slices them off)."""
    B, T = tokens.shape
    Tp = b2_packed_len(T) * 4
    full = np.zeros((B, Tp), np.uint8)
    full[:, :T] = tokens
    quads = full.reshape(B, -1, 4).astype(np.uint16)
    return (
        quads[:, :, 0]
        + (quads[:, :, 1] << 2)
        + (quads[:, :, 2] << 4)
        + (quads[:, :, 3] << 6)
    ).astype(np.uint8)


def pack_b5(tokens: np.ndarray) -> np.ndarray:
    """numpy twin of the native packer: [B, T] uint8 tokens -> [B, (T+2)//3]
    uint8 base-5 packed (pads the tail trio with token 4)."""
    B, T = tokens.shape
    Tp = b5_packed_len(T) * 3
    full = np.full((B, Tp), 4, np.uint8)
    full[:, :T] = tokens
    trios = full.reshape(B, -1, 3).astype(np.uint16)
    return (trios[:, :, 0] + 5 * trios[:, :, 1] + 25 * trios[:, :, 2]).astype(
        np.uint8
    )


def gather_records(data, offsets: np.ndarray, sel: np.ndarray, scratch=None):
    """Concatenate the [start, end) slices of the selected records.

    `data` may be bytes or a bytearray (the chunk stream's reused parse
    window -- gathered from in place, zero-copy).

    With `scratch` (a growable bytearray) the gather reuses its storage and
    returns a memoryview into it. The caller MUST release() that view (or
    drop every reference) before the next call that may need to GROW the
    same scratch -- a live export blocks bytearray resizing with
    BufferError. (The engine's writer releases views on its writer thread
    before recycling, native_pipeline._Writer._run.) Avoids a fresh
    allocation per write (this host's first-touch page faults make
    per-call buffers expensive).
    """
    lib = _load()
    if isinstance(data, bytearray):
        data = (ctypes.c_char * len(data)).from_buffer(data)
    sel = np.ascontiguousarray(sel, np.int64)
    offsets = np.ascontiguousarray(offsets, np.int64)
    total = int(
        lib.rd_selection_size(
            _ptr(offsets, ctypes.c_int64), _ptr(sel, ctypes.c_int64), len(sel)
        )
    )
    if scratch is None:
        out = ctypes.create_string_buffer(total)
        lib.rd_gather_records(
            data, _ptr(offsets, ctypes.c_int64), _ptr(sel, ctypes.c_int64),
            len(sel), out,
        )
        return out.raw
    if len(scratch) < total:
        scratch.extend(b"\0" * (total - len(scratch)))
    buf = (ctypes.c_char * len(scratch)).from_buffer(scratch)
    lib.rd_gather_records(
        data, _ptr(offsets, ctypes.c_int64), _ptr(sel, ctypes.c_int64),
        len(sel), buf,
    )
    del buf  # release the exported buffer so the bytearray can resize later
    return memoryview(scratch)[:total]
