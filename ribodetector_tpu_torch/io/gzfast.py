"""Fast gzip codec built on the system libdeflate, with pure-zlib fallbacks.

The reference delegates all gzip work to Python's ``gzip`` module (zlib;
reference: ribodetector/data_loader/seq_encoder.py:45, detect.py:729-741).
On this framework's streaming hot path that is the host bottleneck: measured
on the bench host over a 215 MB FASTQ,

  - zlib gzip-wrapper streaming inflate:  157 MB/s   (zlib's scalar CRC32
    costs as much as the inflate itself)
  - zlib RAW inflate (this module's reader state machine, trailer CRC
    verified with libdeflate's vectorized crc32):  ~330 MB/s
  - zlib gzip compress level 5:            48 MB/s, ratio 0.174
  - libdeflate gzip compress level 3:     171 MB/s, ratio 0.173  (same
    ratio as zlib level 5 at 3.5x the speed -- what MemberGzipWriter uses)

Reader: ``RawInflater`` is a streaming multi-member gzip decoder: it parses
RFC 1952 member headers itself (FEXTRA/FNAME/FCOMMENT/FHCRC handled,
boundaries may straddle input blocks), runs zlib raw inflate (wbits=-15,
no per-byte CRC on the hot path), and verifies each member's trailer CRC32
and ISIZE using libdeflate's PCLMUL crc32 (~7.8 GB/s here; zlib.crc32
fallback). Integrity checking is therefore preserved end-to-end. Member
boundaries advance by O(1) memoryview slices with a capped body feed --
small-member streams (bgzf's 64 KB blocks, the htslib/samtools format)
decode at 364 MB/s here vs ~101 MB/s with whole-block slicing and
106 MB/s for Python's gzip module on the same input.

Writer: ``MemberGzipWriter`` compresses every write() as an independent
gzip member with libdeflate (concatenated members are a valid gzip file,
RFC 1952 section 2.2 -- exactly what pigz/bgzf produce and what our own
--resume part-merge already relies on). Falls back to per-member
``gzip.compress`` at the clamped configured level when libdeflate is
unavailable.
"""

import ctypes
import struct
import threading
import zlib

_HDR = b"\x1f\x8b"
_BODY_FEED = 256 << 10  # see the body branch in RawInflater.decompress
# deflate's largest expansion: a 258-byte match in 2 bits, 1032 bytes out
# per byte in (zlib's documented 1032:1 limit)
_MAX_INFLATE = 1032
_FHCRC, _FEXTRA, _FNAME, _FCOMMENT = 2, 4, 8, 16

_lib = None
_lib_tried = False
_lib_lock = threading.Lock()


def _libdeflate():
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    with _lib_lock:  # two threads racing the first load must not let one
        if _lib_tried:  # permanently observe "unavailable" (silent fallback)
            return _lib
        try:
            lib = ctypes.CDLL("libdeflate.so.0")
            lib.libdeflate_crc32.restype = ctypes.c_uint32
            lib.libdeflate_crc32.argtypes = [
                ctypes.c_uint32,
                ctypes.c_void_p,
                ctypes.c_size_t,
            ]
            lib.libdeflate_alloc_compressor.restype = ctypes.c_void_p
            lib.libdeflate_gzip_compress.restype = ctypes.c_size_t
            lib.libdeflate_gzip_compress.argtypes = [
                ctypes.c_void_p,
                ctypes.c_void_p,
                ctypes.c_size_t,
                ctypes.c_void_p,
                ctypes.c_size_t,
            ]
            lib.libdeflate_gzip_compress_bound.restype = ctypes.c_size_t
            lib.libdeflate_gzip_compress_bound.argtypes = [
                ctypes.c_void_p,
                ctypes.c_size_t,
            ]
            lib.libdeflate_deflate_compress.restype = ctypes.c_size_t
            lib.libdeflate_deflate_compress.argtypes = [
                ctypes.c_void_p,
                ctypes.c_void_p,
                ctypes.c_size_t,
                ctypes.c_void_p,
                ctypes.c_size_t,
            ]
            lib.libdeflate_deflate_compress_bound.restype = ctypes.c_size_t
            lib.libdeflate_deflate_compress_bound.argtypes = [
                ctypes.c_void_p,
                ctypes.c_size_t,
            ]
            lib.libdeflate_alloc_decompressor.restype = ctypes.c_void_p
            lib.libdeflate_alloc_decompressor.argtypes = []
            lib.libdeflate_free_decompressor.argtypes = [ctypes.c_void_p]
            lib.libdeflate_deflate_decompress.restype = ctypes.c_int
            lib.libdeflate_deflate_decompress.argtypes = [
                ctypes.c_void_p,
                ctypes.c_void_p,
                ctypes.c_size_t,
                ctypes.c_void_p,
                ctypes.c_size_t,
                ctypes.c_void_p,
            ]
            _lib = lib
        except OSError:  # pragma: no cover - libdeflate baked into the image
            _lib = None
        _lib_tried = True
    return _lib


class _Pin:
    """Pin a buffer for a ctypes call and GUARANTEE the export is dropped on
    exit. Passing a from_buffer array through ctypes.cast leaves the source
    buffer exported past the call (observed: a pooled scratch bytearray
    could never be resized again -> BufferError), so addresses are taken
    with addressof and the array/view are released explicitly."""

    def __init__(self, buf):
        self._arr = None
        self._view = None
        self._keep = None
        if not isinstance(buf, bytes):
            view = memoryview(buf)
            if not view.readonly:
                self._view = view
                self._arr = (ctypes.c_ubyte * view.nbytes).from_buffer(view)
                self.addr = ctypes.c_void_p(ctypes.addressof(self._arr))
                return
            buf = bytes(view)
            view.release()
        self._keep = buf  # bytes: immutable, a c_char_p borrow is safe
        self.addr = ctypes.cast(ctypes.c_char_p(buf), ctypes.c_void_p)

    def __enter__(self):
        return self.addr

    def __exit__(self, *exc):
        self.addr = None
        self._arr = None  # drops the buffer export
        if self._view is not None:
            self._view.release()
            self._view = None
        self._keep = None


def crc32(data, crc=0):
    """crc32 via libdeflate's vectorized kernel (zlib.crc32 fallback)."""
    lib = _libdeflate()
    if lib is None:
        return zlib.crc32(data, crc)
    nbytes = data.nbytes if isinstance(data, memoryview) else memoryview(data).nbytes
    with _Pin(data) as ptr:
        return lib.libdeflate_crc32(crc & 0xFFFFFFFF, ptr, nbytes)


# bgzf-style member-length hint: an FEXTRA subfield ('R','D', u32 = total
# member byte length incl. header and trailer). Standard gzip readers skip
# unknown subfields (RFC 1952 2.3.1.1); OUR reader uses it to decode the
# whole member with libdeflate's one-shot raw inflater (~2-3x zlib's
# streaming inflate), the same trick htslib's BGZF plays with its BSIZE
# field -- except u32, so multi-MB members fit. Header layout:
#   1f 8b 08 04 | mtime=0 (4) | XFL=0 OS=ff | XLEN=8 | 'R' 'D' 04 00 | u32
_HINT_HDR_LEN = 10 + 2 + 8
_HINT_SI = b"RD"


_PLAIN_HDR = b"\x1f\x8b\x08\x00\x00\x00\x00\x00\x00\xff"


def _member_header(member_len):
    """Hinted header, or the plain 10-byte header when the member's total
    length does not fit the u32 hint (a >=4 GiB member: valid gzip either
    way -- ISIZE wraps per RFC 1952 -- it just streams instead of fast-
    decoding). member_len must be computed WITH the hinted header size;
    the plain fallback only shrinks it."""
    if member_len >= 1 << 32:
        return _PLAIN_HDR
    return (
        b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
        + b"\x08\x00RD\x04\x00"
        + struct.pack("<I", member_len)
    )


def compress_member(payload, level=3):
    """Compress `payload` into ONE standalone gzip member (header with the
    'RD' member-length hint + raw deflate + crc32/ISIZE trailer) and
    return it as bytes.

    Thread-safe: a compressor is allocated and freed PER CALL (libdeflate
    compressors are stateful and must not be shared; a thread-local cache
    would leak one compressor per exiting pool thread -- the writer spins
    up a fresh deflate pool per run, fatal for the long-lived serve mode).
    Alloc/free is trivial next to deflating the multi-MB members this is
    called with. The ctypes call releases the GIL, so a small thread pool
    compresses independent members in parallel -- concatenated members are
    a valid gzip file, which is how the writer parallelizes output
    compression across host cores. gzip-module fallback at the clamped
    level (no hint) when libdeflate is unavailable.
    """
    lib = _libdeflate()
    n = len(payload)
    if lib is None:  # pragma: no cover - libdeflate baked into the image
        import gzip as _gzip

        return _gzip.compress(bytes(payload), min(max(level, 1), 9), mtime=0)
    comp = lib.libdeflate_alloc_compressor(level)
    if not comp:  # NULL: invalid level -- never pass NULL onward
        raise ValueError(f"libdeflate rejected compression level {level}")
    try:
        bound = lib.libdeflate_deflate_compress_bound(comp, n)
        obuf = bytearray(bound)
        with _Pin(payload) as in_ptr, _Pin(obuf) as out_ptr:
            wrote = lib.libdeflate_deflate_compress(comp, in_ptr, n, out_ptr, bound)
            crc = lib.libdeflate_crc32(0, in_ptr, n)
    finally:
        lib.libdeflate_free_compressor(ctypes.c_void_p(comp))
    if wrote == 0:  # pragma: no cover - bound guarantees success
        raise OSError("libdeflate_deflate_compress failed")
    del obuf[wrote:]
    member_len = _HINT_HDR_LEN + wrote + 8
    return (
        _member_header(member_len)
        + bytes(obuf)
        + struct.pack("<II", crc & 0xFFFFFFFF, n & 0xFFFFFFFF)
    )


class BadGzipFile(OSError):
    pass


class RawInflater:
    """Streaming multi-member gzip decoder (see module docstring).

    decompress(data, max_length) -> (out: bytes, leftover: bytes): consumes
    as much of `data` as fits in `max_length` output bytes; `leftover` is
    input withheld by the output cap (feed it back first on the next call).
    flush() returns any internally buffered output at stream end (matches
    zlib.decompressobj.flush() tolerance for truncated final members).
    """

    def __init__(self, verify=True):
        self._verify = verify
        self._state = "header"  # header | body | trailer
        self._hbuf = b""
        self._tbuf = b""
        self._dec = zlib.decompressobj(-zlib.MAX_WBITS)
        self._crc = 0
        self._isize = 0
        # 'RD'-hinted fast path: bytes of the current member remaining past
        # its header (body+trailer), or None when unknown / already being
        # streamed; _mbuf stashes a spanning member's bytes until complete;
        # _dctx is a reusable libdeflate decompressor
        self._body_rest = None
        self._mbuf = bytearray()
        self._dctx = None
        self.members = 0
        self.fast_members = 0  # decoded via the one-shot libdeflate path

    def _reset_member_state(self):
        """Member boundary: count it and arm a fresh decode state (shared
        by the fast path and the streaming trailer branch)."""
        self.members += 1
        self._state = "header"
        self._dec = zlib.decompressobj(-zlib.MAX_WBITS)
        self._crc = 0
        self._isize = 0

    def _member_done(self):
        """Advance past a fast-decoded member: trailer already verified."""
        self._reset_member_state()
        self.fast_members += 1

    def __del__(self):  # pragma: no cover - GC timing
        lib = _lib  # module global; may be gone at interpreter shutdown
        if self._dctx and lib is not None:
            try:
                lib.libdeflate_free_decompressor(ctypes.c_void_p(self._dctx))
            except Exception:
                pass
            self._dctx = None

    @property
    def mid_stream(self):
        """True if input ended inside a member body or trailer."""
        return self._state != "header" or bool(self._hbuf)

    def _scan_header(self, buf):
        """(header_len, member_len_hint) within bytes `buf`;
        (-1, None) if incomplete. member_len_hint is the 'RD' FEXTRA
        subfield's total member byte count (compress_member emits it), or
        None for foreign members."""
        if len(buf) < 10:
            return -1, None
        if buf[:2] != _HDR:
            raise BadGzipFile("Not a gzipped file")
        if buf[2] != 8:
            raise BadGzipFile(f"Unknown compression method {buf[2]}")
        flg = buf[3]
        i = 10
        hint = None
        if flg & _FEXTRA:
            if len(buf) < i + 2:
                return -1, None
            xlen = int.from_bytes(buf[i : i + 2], "little")
            i += 2
            end = i + xlen
            if len(buf) < end:
                return -1, None
            # walk the subfields for our member-length hint; unknown
            # subfields are skipped per RFC 1952 2.3.1.1
            j = i
            while j + 4 <= end:
                slen = int.from_bytes(buf[j + 2 : j + 4], "little")
                if buf[j : j + 2] == _HINT_SI and slen == 4 and j + 8 <= end:
                    hint = int.from_bytes(buf[j + 4 : j + 8], "little")
                j += 4 + slen
            i = end
        if flg & _FNAME:
            j = buf.find(b"\0", i)
            if j < 0:
                return -1, None
            i = j + 1
        if flg & _FCOMMENT:
            j = buf.find(b"\0", i)
            if j < 0:
                return -1, None
            i = j + 1
        if flg & _FHCRC:
            if len(buf) < i + 2:
                return -1, None
            i += 2
        return i, hint

    _HDR_PREFIX = 4096  # headers are tiny; a giant FNAME takes the stash path

    def _parse_header_mv(self, mv):
        """Consume a member header from memoryview `mv`; returns the byte
        count consumed. Incomplete headers stash ALL of mv (consumed =
        len(mv)) and resume on the next call. O(header) per member -- the
        old implementation sliced the whole remaining block per member,
        which made bgzf-style small-member streams quadratic (measured
        121 MB/s vs 707 MB/s for 2 MB members)."""
        if not self._hbuf:
            prefix = bytes(mv[: self._HDR_PREFIX])
            i, hint = self._scan_header(prefix)
            if i >= 0:
                self._state = "body"
                self._set_hint(i, hint)
                return i
            if len(mv) <= len(prefix):
                self._hbuf = prefix
                return len(mv)
            # header longer than the prefix bound: fall through to stash
        buf = self._hbuf + bytes(mv)
        i, hint = self._scan_header(buf)
        if i < 0:
            self._hbuf = buf
            return len(mv)
        consumed = i - len(self._hbuf)
        self._hbuf = b""
        self._state = "body"
        self._set_hint(i, hint)
        return consumed

    _HINT_MAX = 256 << 20  # ignore absurd hints: the stash must stay bounded

    def _set_hint(self, header_len, hint):
        """Remaining body+trailer bytes of the member, if the header
        carried a credible 'RD' hint (must cover at least the trailer and
        stay within the stash bound -- a corrupt u32 must not make the
        decoder buffer gigabytes). Without libdeflate the hint is useless,
        and arming it would only buy the pure-zlib fallback extra copies."""
        if (
            hint is not None
            and header_len + 8 < hint <= self._HINT_MAX
            and _libdeflate() is not None
        ):
            self._body_rest = hint - header_len
        else:
            self._body_rest = None

    def _member_trailer_ints(self, mv):
        """(want_crc, isize) of the in-hand member whose body+trailer span
        self._mbuf then mv (combined length >= self._body_rest)."""
        tr = self._body_rest - 8
        sl = len(self._mbuf)
        if tr >= sl:
            trailer = bytes(mv[tr - sl : tr - sl + 8])
        else:
            trailer = (bytes(self._mbuf[tr:]) + bytes(mv))[:8]
        return struct.unpack("<II", trailer)

    def _fast_member(self, mv, isize, want_crc):
        """One-shot libdeflate decode of a whole hinted member sitting in
        `mv` (body+trailer = self._body_rest bytes). Returns the
        decompressed bytes, or None on any decode disagreement -- the
        zlib path then re-decodes from the same position and raises the
        proper errors if the data is truly bad. (Note: pinning a readonly
        input slice copies it -- ~0.1 ms per MB, noise next to the decode
        itself.)"""
        lib = _libdeflate()
        rest = self._body_rest
        if lib is None:  # pragma: no cover - _set_hint gates on the lib
            return None
        if self._dctx is None:
            self._dctx = lib.libdeflate_alloc_decompressor()
            if not self._dctx:  # pragma: no cover - OOM
                return None
        out = bytearray(isize)
        actual = ctypes.c_size_t(0)
        comp = mv[: rest - 8]
        with _Pin(comp) as in_ptr, _Pin(out) as out_ptr:
            rc = lib.libdeflate_deflate_decompress(
                ctypes.c_void_p(self._dctx), in_ptr, rest - 8,
                out_ptr, isize, ctypes.byref(actual),
            )
        comp.release()
        if rc != 0 or actual.value != isize:
            return None
        if self._verify and crc32(out) != want_crc:
            return None
        return bytes(out)

    def decompress(self, data, max_length):
        out_parts = []
        budget = max_length
        mv = data if isinstance(data, memoryview) else memoryview(data)
        while len(mv) and budget > 0:
            if self._state == "header":
                mv = mv[self._parse_header_mv(mv) :]
            elif self._state == "body":
                if self._body_rest is not None:
                    rest = self._body_rest
                    if len(self._mbuf) + len(mv) < rest:
                        # member spans input blocks: stash its bytes until
                        # complete (bgzf-style buffering) -- without the
                        # stash only alignment-lucky members would ever
                        # hit the fast path (measured 1/50)
                        self._mbuf += mv
                        mv = mv[len(mv) :]
                        continue
                    # whole member in hand (stash + mv): decide by its
                    # trailer's ISIZE before assembling anything
                    want_crc, isize = self._member_trailer_ints(mv)
                    if isize > max_length or isize > _MAX_INFLATE * (rest - 8):
                        # can never fit one call's contract, or more than
                        # this body can inflate to (a corrupt trailer; flush()
                        # passes an unbounded budget, and the fast path
                        # allocates isize up front): stream it, and zlib
                        # raises or tolerates as for any member
                        # (re-inject any stash ahead of mv first)
                        self._body_rest = None
                        if self._mbuf:
                            stash = self._mbuf
                            self._mbuf = bytearray()
                            mv = memoryview(bytes(stash) + bytes(mv))
                        continue
                    if isize > budget:
                        # budget partially consumed this call: hand every
                        # unread byte back and keep the hint armed -- the
                        # caller's next call has a fresh budget that fits
                        # (isize <= max_length), so the member still fast-
                        # decodes instead of silently dropping to zlib
                        left = bytes(self._mbuf) + bytes(mv)
                        self._mbuf = bytearray()
                        return b"".join(out_parts), left
                    if self._mbuf:
                        need = rest - len(self._mbuf)
                        self._mbuf += mv[:need]
                        mv = mv[need:]
                        with memoryview(self._mbuf) as smv:
                            out = self._fast_member(smv, isize, want_crc)
                        consumed_stash = True
                    else:
                        out = self._fast_member(mv, isize, want_crc)
                        consumed_stash = False
                    self._body_rest = None
                    if out is not None:
                        if consumed_stash:
                            self._mbuf = bytearray()
                        else:
                            mv = mv[rest:]
                        if out:
                            out_parts.append(out)
                            budget -= len(out)
                        self._member_done()
                        continue
                    # decode disagreement: re-decode from the same
                    # position via zlib, which raises the proper error
                    # if the member is really bad
                    if consumed_stash:
                        stash = self._mbuf
                        self._mbuf = bytearray()
                        mv = memoryview(bytes(stash) + bytes(mv))
                    continue
                # feed the decompressor a CAPPED slice: at a member end
                # zlib copies every unconsumed input byte into unused_data,
                # so feeding the whole remaining block makes small-member
                # (bgzf) streams quadratic. The cap bounds that copy per
                # member; position advances by computed consumed count and
                # zlib's copy is never read.
                feed = mv[:_BODY_FEED] if len(mv) > _BODY_FEED else mv
                out = self._dec.decompress(feed, budget)
                if out:
                    if self._verify:
                        self._crc = crc32(out, self._crc)
                        self._isize += len(out)
                    out_parts.append(out)
                    budget -= len(out)
                if self._dec.eof:
                    # member body done (eof => the deflate stream fully
                    # consumed; do NOT look at unconsumed_tail here: when
                    # the body ends inside a max_length-truncated call
                    # zlib can set BOTH)
                    mv = mv[len(feed) - len(self._dec.unused_data) :]
                    self._state = "trailer"
                    self._tbuf = b""
                elif self._dec.unconsumed_tail:
                    # output budget filled mid-member: hand back the unread
                    # remainder (one copy per outer call, not per member)
                    rest = mv[len(feed) :]
                    tail = self._dec.unconsumed_tail
                    return (
                        b"".join(out_parts),
                        tail + bytes(rest) if len(rest) else tail,
                    )
                else:
                    mv = mv[len(feed) :]
            else:  # trailer
                need = 8 - len(self._tbuf)
                self._tbuf += bytes(mv[:need])
                mv = mv[need:]
                if len(self._tbuf) == 8:
                    if self._verify:
                        crc, isize = struct.unpack("<II", self._tbuf)
                        if crc != self._crc & 0xFFFFFFFF:
                            raise BadGzipFile(
                                f"CRC check failed in member {self.members}"
                            )
                        if isize != self._isize & 0xFFFFFFFF:
                            raise BadGzipFile("Incorrect length of data produced")
                    self._reset_member_state()
        return b"".join(out_parts), bytes(mv) if len(mv) else b""

    def flush(self):
        out_parts = []
        # an armed hint at stream end must not hide data: an OVERSHOOTING
        # 'RD' hint (corrupt u32, or a foreign producer using the same
        # subfield id with other semantics) would leave intact members
        # sitting in the stash forever. Re-run the full member state
        # machine over the stash with the hint disarmed -- complete
        # members (and their CRC checks) come out exactly as streaming
        # would have produced them; only a genuinely truncated tail
        # remains, with zlib's usual truncated-final-member tolerance.
        while self._mbuf:
            stash = bytes(self._mbuf)
            self._mbuf = bytearray()
            self._body_rest = None
            o, left = self.decompress(stash, 1 << 62)
            if o:
                out_parts.append(o)
            if left:  # pragma: no cover - the budget is effectively infinite
                self._mbuf += left
            if len(self._mbuf) >= len(stash):  # pragma: no cover
                break  # no progress: corrupt framing, stop re-running
        if self._state == "body":
            out_parts.append(self._dec.flush())
        return b"".join(out_parts)


class MemberGzipWriter:
    """Binary file-like gz writer: each write() is one gzip member
    compressed with libdeflate (default level 3: ratio parity with the
    reference's zlib level 5 -- module docstring -- at ~3.5x the speed;
    level 1 trades ~4% ratio for ~2x deflate speed when the write stage is
    the bottleneck, --gz-level). Concatenated members form a valid gzip
    file readable by gzip/zcat/the reference's parser. NOT for many tiny
    writes (18+ bytes of member overhead each); the runtime writes
    multi-KB..MB batch payloads.
    """

    LEVEL = 3  # libdeflate level with zlib-level-5 ratio parity

    def __init__(self, fh, level=None):
        self._fh = fh
        self._wrote_any = False
        self.level = self.LEVEL if level is None else int(level)
        lib = _libdeflate()
        self._comp = (
            lib.libdeflate_alloc_compressor(self.level) if lib is not None else None
        )
        if lib is not None and not self._comp:
            try:
                fh.close()  # we own it per documented usage; don't leak it
            except Exception:
                pass
            raise ValueError(
                f"libdeflate rejected compression level {self.level}"
            )
        self._lib = lib
        self._obuf = bytearray()

    def write(self, payload):
        n = len(payload)
        if n == 0:
            return 0
        self._wrote_any = True
        if self._comp is None:  # pragma: no cover - libdeflate baked in
            import gzip as _gzip

            self._fh.write(
                _gzip.compress(bytes(payload), min(max(self.level, 1), 9), mtime=0)
            )
            return n
        # hinted member (same layout as compress_member): raw deflate at
        # offset _HINT_HDR_LEN of the reused buffer, header + trailer
        # filled in around it, so re-reading our own outputs takes the
        # one-shot libdeflate decode path
        bound = self._lib.libdeflate_deflate_compress_bound(self._comp, n)
        need = _HINT_HDR_LEN + bound + 8
        if len(self._obuf) < need:
            self._obuf = bytearray(need)
        with _Pin(payload) as in_ptr, _Pin(self._obuf) as out_ptr:
            wrote = self._lib.libdeflate_deflate_compress(
                self._comp, in_ptr, n,
                ctypes.c_void_p(out_ptr.value + _HINT_HDR_LEN), bound,
            )
            crc = self._lib.libdeflate_crc32(0, in_ptr, n)
        if wrote == 0:  # pragma: no cover - bound guarantees success
            raise OSError("libdeflate_deflate_compress failed")
        total = _HINT_HDR_LEN + wrote + 8
        header = _member_header(total)
        struct.pack_into(
            "<II", self._obuf, _HINT_HDR_LEN + wrote,
            crc & 0xFFFFFFFF, n & 0xFFFFFFFF,
        )
        if len(header) == _HINT_HDR_LEN:
            self._obuf[:_HINT_HDR_LEN] = header
            with memoryview(self._obuf) as mv:
                self._fh.write(mv[:total])
        else:  # pragma: no cover - >=4 GiB member: plain header fallback
            self._fh.write(header)
            with memoryview(self._obuf) as mv:
                self._fh.write(mv[_HINT_HDR_LEN:total])
        return n

    def set_level(self, level):
        """Swap the compression level mid-stream (adaptive gz: the writer
        drops to level 1 when the deflate stage is the measured run
        bottleneck). Safe at any member boundary -- every write() is an
        independent member, so mixed-level members form a valid gzip file.
        Caller must serialize with write() (the runtime calls both only on
        its writer thread)."""
        level = int(level)
        if level == self.level:
            return
        if self._lib is not None:
            comp = self._lib.libdeflate_alloc_compressor(level)
            if not comp:
                raise ValueError(f"libdeflate rejected compression level {level}")
            if self._comp is not None:
                self._lib.libdeflate_free_compressor(ctypes.c_void_p(self._comp))
            self._comp = comp
        self.level = level

    def write_raw(self, data):
        """Append an already-compressed gzip member (from compress_member)."""
        if data:
            self._wrote_any = True
        self._fh.write(data)

    def flush(self):
        self._fh.flush()

    def tell(self):
        """Compressed byte offset. Every write() / write_raw() ends exactly
        at a gzip member boundary, so this offset is always a valid
        truncation point (--resume byte-offset manifests)."""
        return self._fh.tell()

    def close(self):
        try:
            if not self._wrote_any and not getattr(self._fh, "closed", False):
                # a .gz file with zero members is not a valid gzip stream
                # (gzip -d: "unexpected end of file"); the reference's
                # gzip.open path emits a valid empty member on close, so
                # match it -- a class with no reads still yields a
                # readable (empty) output
                self._wrote_any = True
                self._fh.write(compress_member(b"", level=self.level))
            self._fh.close()
        finally:
            if self._comp is not None:
                self._lib.libdeflate_free_compressor(ctypes.c_void_p(self._comp))
                self._comp = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
