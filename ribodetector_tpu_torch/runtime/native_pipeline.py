"""Native fast path: zero-per-read-Python streaming runtime (FASTQ + FASTA).

Counterpart of ``ribodetector_tpu/runtime/native_pipeline.py`` with the
device calls in torch. Per chunk of R records, ONE native call parses +
token-encodes the decompressed byte buffer (native/fastx.cpp), batches are
numpy views copied into reusable padded staging buffers, and output files
are written as verbatim byte-range gathers of the input buffer -- no Python
string is ever created per read (records pass through byte-identical).

Pipeline shape:

- tokens cross the host->device link PACKED: base-5 (3 tokens/byte) for
  any read, 2-bit (4 tokens/byte) for clean full-length reads; both are
  unpacked on the device (ops/dispatch.py).
- the staging buffers are pinned host memory when the run is on the card,
  so each batch's host->device copy is asynchronous; up to DEPTH batches
  are in flight, and a staging slot is reused only after its batch's labels
  came back, which orders strictly after its copy.
- parse runs in a prefetch thread and file writes in a writer thread
  (gzip/zlib and file IO release the GIL), so decompress/parse of chunk
  i+1 and compressed writes of batch i-1 overlap the device.

All large buffers are allocated once and reused. FASTQ records with
CRLF/trailing whitespace (flagged per record by the native parser) are
re-parsed by the Python parser with identical behavior; FASTA is handled
natively by FastaChunkStream.

Restartable streaming (--resume, ResumeState) and the coordinated
multi-host layout (--coordinator, DistributedParts) run through the same
loop; with several cards on one host (-d a,b) each device batch is split
into row slices, one per card (NativeRunner._device_call_with).
"""

import io
import json
import os
import queue
import threading
import numpy as np

from ribodetector_tpu_torch import native
from ribodetector_tpu_torch.io.fastx import seq_parser
from ribodetector_tpu_torch.io.format import get_seq_format
from ribodetector_tpu_torch.io.gzfast import MemberGzipWriter, RawInflater, compress_member
from ribodetector_tpu_torch.parallel.sharded import host_chunk_assignment

from ribodetector_tpu_torch.runtime.buckets import PAD_B5 as _PAD_BYTE

_BLOCK = 4 << 20
# _PAD_BYTE: base-5 packed all-pad trio (124) -- single Python-side
# definition lives in runtime/buckets.py, matching native/fastx.cpp


class FastqChunkStream:
    """Streams (data, offsets, ptokens, lengths, clean, n) chunks of up to
    `records_per_chunk` FASTQ records from a plain or gzipped file; token
    rows are base-5 packed ([n, (max_len+2)//3] uint8), `data` is a reused
    window bytearray the offsets index into.

    Zero-churn design: bytes land ONCE in a fixed window buffer (readinto
    for plain files; zlib max_length decompression for gzip) and the native
    parser runs in place over it -- no intermediate bytes objects, joins, or
    newline counting, and the GIL is released for nearly all of the work so
    a prefetch thread overlaps cleanly with device dispatch. Windows and
    output arrays rotate through a slot pool sized from the consumer's
    pipeline depth (see below) so a chunk window is never overwritten while
    a batch referencing it is still in flight.

    Multi-member gzip (pigz/bgzf, or our own multi-member outputs) is handled
    by the RawInflater state machine (io/gzfast.py), which restarts raw
    inflate at each member boundary and CRC-verifies every member trailer
    with a vectorized crc32 -- ~2x the throughput of Python's gzip module.

    Slot sizing: with `depth` in-flight device batches (each possibly the
    only batch of its chunk, so each pinning one window) and `prefetch`
    chunks buffered in the consumer's prefetch queue, live windows =
    1 current + depth pending + prefetch queued + 1 being parsed, plus one
    slot of slack = depth + prefetch + 3. Callers that change their pipeline
    depth MUST pass it here -- the pool grows with it automatically.
    """

    def __init__(
        self,
        path,
        max_len,
        records_per_chunk,
        window_bytes=None,
        depth=3,
        prefetch=1,
        timer=None,
    ):
        if timer is None:
            from ribodetector_tpu_torch.runtime.profiling import StageTimer

            timer = StageTimer(enabled=False)
        self.timer = timer
        self.slots = depth + prefetch + 3
        self.max_len = max_len
        self.cap = records_per_chunk
        self._fh = open(path, "rb")
        self._gz = get_seq_format(path).endswith("gz")
        self._carry = b""  # decompressed bytes awaiting window placement
        self._tail = b""  # decompressed partial record from the last window
        self._eof = False
        # gz inputs: inflate runs in its own thread so decompression of
        # block i+1 overlaps the parse of block i (on one thread the two
        # serialize; pipelined they run at the inflate rate). The thread hands fully
        # decompressed blocks over a bounded queue; _fill_gz just memcpys
        # them into the parse window (~2% of the work).
        self._blockq = queue.Queue(maxsize=8) if self._gz else None
        self._decomp_started = False
        self._decomp_thread = None
        self._closing = False
        self.win_bytes = window_bytes or min(
            max(records_per_chunk * 280, 8 << 20), 256 << 20
        )
        # adaptive fill target keeps the leftover tail small: aim slightly
        # past cap records at the running mean record size
        self._avg_rec = 280.0
        # per slot: window, offsets, base-5 rows, lengths, clean flags,
        # 2-bit rows + per-record b2 eligibility (the FASTQ parser emits
        # both packings in one pass; b2ok records route to the 25%-smaller
        # 2-bit transfer lane -- fastx.cpp rd_parse_fastq_b5b2).
        # Slots allocate LAZILY on first rotation: eagerly memsetting the
        # whole pool would charge the first-touch page faults of every slot
        # to startup, even in runs that never cycle past slot 2; lazily they
        # overlap device compute instead of preceding it.
        self._slots = [None] * self.slots
        self._si = 0

    def _slot(self, si):
        s = self._slots[si]
        if s is None:
            cap = self.cap + 2
            pl = native.b5_packed_len(self.max_len)
            pl2 = native.b2_packed_len(self.max_len)
            s = (
                bytearray(self.win_bytes),
                np.zeros((cap, 2), np.int64),
                np.zeros((cap, pl), np.uint8),
                np.zeros(cap, np.int32),
                np.zeros(cap, np.uint8),
                np.zeros((cap, pl2), np.uint8),
                np.zeros(cap, np.uint8),
            )
            self._slots[si] = s
        return s

    def _fill_plain(self, mv, pos, target):
        while pos < target and not self._eof:
            nread = self._fh.readinto(mv[pos:target])
            if not nread:
                self._eof = True
                self._fh.close()
                break
            pos += nread
        return pos

    def _decomp_loop(self):
        """Inflate thread: file -> RawInflater -> bounded queue of
        decompressed blocks (None = EOF, BaseException = error). RawInflater
        (io/gzfast.py) handles member headers/trailers and multi-member
        restarts itself: raw inflate with vectorized trailer CRC runs ~2x
        faster than zlib's gzip wrapper (whose scalar per-byte CRC costs as
        much as the inflate itself)."""
        q = self._blockq
        inf = RawInflater()
        timer = self.timer

        def put(item):
            # bounded put that aborts when the stream is being closed
            # (failed-job cleanup): a plain q.put could block forever if
            # the consumer is gone and the drain raced past an Empty,
            # leaking this thread and its buffered blocks
            while not self._closing:
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        try:
            while not self._closing:
                raw = self._fh.read(_BLOCK)
                if not raw:
                    self._fh.close()
                    out = inf.flush()
                    if inf.mid_stream:
                        # a member body/trailer was cut off: surface the
                        # same hard error the reference's gzip path raises
                        # instead of silently classifying a partial file
                        raise EOFError(
                            "Compressed file ended before the "
                            "end-of-stream marker was reached"
                        )
                    if out:  # pragma: no cover - empty when not mid_stream
                        put(out)
                    put(None)
                    return
                while raw:
                    with timer.stage("inflate"):
                        out, raw = inf.decompress(raw, _BLOCK)
                    if out and not put(out):
                        return
        except BaseException as e:  # propagated to the consumer
            put(e)

    def _fill_gz(self, mv, pos, target):
        if not self._decomp_started:
            self._decomp_started = True
            self._decomp_thread = threading.Thread(
                target=self._decomp_loop, daemon=True, name="rd-inflate"
            )
            self._decomp_thread.start()
        while pos < target and (self._carry or not self._eof):
            if self._carry:
                blk, self._carry = self._carry, b""
            else:
                blk = self._get_block()
                if blk is None:
                    self._eof = True
                    break
                if isinstance(blk, BaseException):
                    self._eof = True
                    raise blk
            take = min(len(blk), target - pos)
            mv[pos : pos + take] = blk[:take] if take < len(blk) else blk
            pos += take
            if take < len(blk):
                self._carry = blk[take:]
        return pos

    def _get_block(self):
        """Next decompressed block from the inflate thread; checks
        _closing while it waits, so a consumer being torn down (close() from
        another thread) is never stuck on an empty queue forever."""
        while True:
            try:
                return self._blockq.get(timeout=0.2)
            except queue.Empty:
                if self._closing:
                    raise RuntimeError("chunk stream closed while reading")

    # -- format hooks (overridden by FastaChunkStream) ------------------

    def _parse_window(self, si, pos, at_eof):
        """Run the native FASTQ parser over slot si's window[:pos]. Returns
        (n, used, data) where `data` is the buffer the offsets index."""
        import ctypes

        lib = native._load()
        win, offsets, ptokens, lengths, clean, ptokens2, b2ok = self._slot(si)
        pl = native.b5_packed_len(self.max_len)
        pl2 = native.b2_packed_len(self.max_len)
        consumed = np.zeros(1, np.int64)
        buf = (ctypes.c_char * pos).from_buffer(win)
        with self.timer.stage("parse_work"):
            n = lib.rd_parse_fastq_b5b2(
                buf,
                pos,
                1 if at_eof else 0,
                self.cap,
                self.max_len,
                pl,
                pl2,
                native._ptr(offsets, ctypes.c_int64),
                native._ptr(ptokens, ctypes.c_uint8),
                native._ptr(ptokens2, ctypes.c_uint8),
                native._ptr(lengths, ctypes.c_int32),
                native._ptr(clean, ctypes.c_uint8),
                native._ptr(b2ok, ctypes.c_uint8),
                native._ptr(consumed, ctypes.c_int64),
            )
        del buf  # release the buffer export
        return n, int(consumed[0]), win

    def _eof_no_record(self, win, pos):
        """EOF with leftover bytes that frame no record. The native parser
        consumes blank separator lines itself and (via its at_eof flag)
        finalizes an unterminated final record, so any remainder here is a
        genuinely truncated record -- raise the portable parser's error
        (io/fastx.py seq_parser)."""
        if pos >= self.win_bytes:
            raise RuntimeError(
                "record larger than the {} MB parse window".format(
                    self.win_bytes >> 20
                )
            )
        blob = bytes(win[: min(pos, 1 << 16)])
        if b"\n" not in blob and b"\r" in blob:
            raise ValueError(
                "input uses lone-CR (classic Mac) line endings, which the "
                "native parser does not support; convert the file (e.g. "
                "tr '\\r' '\\n')"
            )
        head = blob.split(b"\n")[0][:80]
        raise ValueError(
            "Truncated FASTQ record at end of file: {!r}".format(head)
        )

    # -- shared window loop ---------------------------------------------

    def __iter__(self):
        """ONE loop serves both formats (the parser call and EOF policy are
        the format hooks above; round 4 consolidated the two near-identical
        copies). Slot discipline: a NEW slot is taken only per YIELDED
        window -- the n==0 retry path rewinds _si and reuses the same slot,
        otherwise consecutive retries (a record much larger than the
        adaptive estimate) could wrap the pool onto a window still pinned
        by an in-flight accumulator and corrupt its byte-gather output."""
        while True:
            si = self._si
            self._si = (self._si + 1) % self.slots
            win = self._slot(si)[0]
            mv = memoryview(win)
            pos = len(self._tail)
            mv[:pos] = self._tail
            target = min(
                self.win_bytes, pos + int(self.cap * self._avg_rec * 1.05) + 4096
            )
            pos = (
                self._fill_gz(mv, pos, target)
                if self._gz
                else self._fill_plain(mv, pos, target)
            )
            del mv
            if pos == 0:
                return
            at_eof = self._eof and not self._carry
            n, used, data = self._parse_window(si, pos, at_eof)
            if n == 0:
                self._si = si  # reuse this slot on every no-record path
                if used > 0:  # separator lines consumed, no record yet
                    self._tail = bytes(win[used:pos])
                    if at_eof and not self._tail:
                        return
                    continue
                if at_eof:
                    if self._eof_no_record(win, pos):
                        continue
                    return
                if pos >= self.win_bytes:
                    raise RuntimeError(
                        "record larger than the {} MB parse window".format(
                            self.win_bytes >> 20
                        )
                    )
                # window underfilled (adaptive target too small for these
                # record sizes): retry with a bigger target
                self._avg_rec = min(self._avg_rec * 2, float(self.win_bytes))
                self._tail = bytes(win[:pos])
                continue
            self._avg_rec = 0.5 * self._avg_rec + 0.5 * (used / n)
            self._tail = bytes(win[used:pos])
            _, offsets, ptokens, lengths, clean, ptokens2, b2ok = self._slot(si)
            yield (
                data, offsets[:n], ptokens[:n], ptokens2[:n], lengths[:n],
                clean[:n], b2ok[:n], n,
            )
            if self._eof and not self._carry and not self._tail:
                return

    def close(self):
        """Release the input fd and unblock the decomp thread (idempotent;
        failed-job cleanup for the long-lived serve mode). The drain loops
        until the inflate thread actually exits -- a fixed-count drain
        could race its refill and leave it blocked on a full queue
        forever, leaking the thread and its buffered blocks."""
        self._closing = True
        try:
            self._fh.close()
        except Exception:
            pass
        q, t = self._blockq, self._decomp_thread
        if q is not None:
            deadline = 50  # ~5 s bound; the thread checks _closing every 0.2 s
            while t is not None and t.is_alive() and deadline:
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
                deadline -= 1
            while True:  # leftover blocks after the thread exited
                try:
                    q.get_nowait()
                except queue.Empty:
                    break


class FastaChunkStream(FastqChunkStream):
    """FASTA twin of FastqChunkStream. The reference re-emits FASTA records
    as stripped header + single-line UPPERCASED concatenated sequence
    (fastx_parser.py:40-55), so output is not a verbatim input slice; the
    native parser (fastx.cpp rd_parse_fasta_b5) writes that normalized text
    into a per-slot buffer and offsets index into it. Everything downstream
    (byte-gather writers, batching) is shared with the FASTQ path.
    Records are always 'clean' by construction (normalization IS the
    reference text)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # normalization can GROW text (\">x\\n\" -> \">x\\n\\n\"; an\n        # unterminated final line gains its newline): worst case 4/3 x
        self._norms = [None] * self.slots  # lazy, like the base slots

    def _norm(self, si):
        n = self._norms[si]
        if n is None:
            n = bytearray(self.win_bytes * 4 // 3 + 16)
            self._norms[si] = n
        return n

    def _parse_window(self, si, pos, at_eof):
        import ctypes

        lib = native._load()
        win, offsets, ptokens, lengths, clean, ptokens2, b2ok = self._slot(si)
        norm = self._norm(si)
        pl = native.b5_packed_len(self.max_len)
        consumed = np.zeros(1, np.int64)
        norm_used = np.zeros(1, np.int64)
        buf = (ctypes.c_char * pos).from_buffer(win)
        nbuf = (ctypes.c_char * len(norm)).from_buffer(norm)
        with self.timer.stage("parse_work"):
            n = lib.rd_parse_fasta_b5(
                buf,
                pos,
                1 if at_eof else 0,
                self.cap,
                self.max_len,
                pl,
                nbuf,
                len(norm),
                native._ptr(offsets, ctypes.c_int64),
                native._ptr(ptokens, ctypes.c_uint8),
                native._ptr(lengths, ctypes.c_int32),
                native._ptr(consumed, ctypes.c_int64),
                native._ptr(norm_used, ctypes.c_int64),
            )
        del buf, nbuf  # release the buffer exports
        if n:
            clean[:n] = 1  # normalization IS the reference text
            b2ok[:n] = 0  # FASTA keeps the base-5 lane (no 2-bit emit)
        return n, int(consumed[0]), norm

    def _eof_no_record(self, win, pos):
        """FASTA trailing junk / empty-sequence record: silently dropped,
        matching the portable parser (io/fastx.py seq_parser FASTA arm) --
        rd_parse_fasta_b5 already finalizes unterminated trailing records
        itself via its at_eof flag. Exception: a lone-CR (classic Mac)
        file looks like one header-only line to the native parser and
        would silently drop EVERY record; fail loudly instead."""
        blob = bytes(win[: min(pos, 1 << 16)])
        if b"\n" not in blob and b"\r" in blob:
            raise ValueError(
                "input uses lone-CR (classic Mac) line endings, which the "
                "native parser does not support; convert the file (e.g. "
                "tr '\\r' '\\n')"
            )
        return False


def make_chunk_stream(path, max_len, records_per_chunk, **kwargs):
    """FastqChunkStream or FastaChunkStream by file extension."""
    cls = (
        FastaChunkStream
        if get_seq_format(path).startswith("fa")
        else FastqChunkStream
    )
    return cls(path, max_len, records_per_chunk, **kwargs)


class _Prefetcher:
    """Pulls items off an iterator in a daemon thread (bounded queue) so
    decompress+parse of the next chunk overlaps device compute and writes.
    Safe with FastqChunkStream's rotating slots as long as the stream was
    constructed with prefetch >= this queue's depth (see slot sizing in
    FastqChunkStream's docstring)."""

    _DONE = object()

    def __init__(self, it, depth=1):
        self._q = queue.Queue(maxsize=depth)
        self._exc = None
        self._stopped = False
        self._t = threading.Thread(
            target=self._run, args=(it,), daemon=True, name="rd-parse"
        )
        self._t.start()

    def _run(self, it):
        try:
            for item in it:
                while not self._stopped:
                    try:
                        self._q.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if self._stopped:
                    return
        except BaseException as e:  # propagated to the consumer
            self._exc = e
        finally:
            if not self._stopped:
                self._q.put(self._DONE)

    def get(self):
        item = self._q.get()
        if item is self._DONE:
            if self._exc is not None:
                raise self._exc
            return None
        return item

    def stop(self):
        """Abandon the producer (failed-job cleanup): unblocks its put()
        and lets the thread exit without draining the source iterator."""
        self._stopped = True
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                return


class _RecordCursor:
    """Record-exact cursor over a prefetched chunk stream.

    The chunk streams yield window-adaptive record counts: a window can
    legitimately hold fewer than `cap` records mid-file when record sizes
    vary faster than the adaptive fill target tracks them. The paired
    runner therefore can NOT zip stream chunks and truncate each pair of
    chunks to the shorter one -- that silently drops the longer chunk's
    tail rows and desynchronizes the two files from then on. A cursor
    instead tracks an exact per-file record position; consumers cut
    batches at window boundaries (`take` never spans two windows, so every
    batch's byte-gather source is a single buffer) and the two sides of a
    pair advance in lockstep to the record. File-end truncation to the
    shorter input (reference quirk #8, seq_encoder.py:90-92) happens
    naturally when one cursor's `ready()` goes False.
    """

    def __init__(self, prefetcher):
        self._pf = prefetcher
        self._c = None  # [data, offsets, ptokens, ptokens2, lengths, b2ok, n, clean, recs]
        self._pos = 0
        self.eof = False

    _RECS_UNSET = object()
    _N = 6  # record count's index in self._c

    def ready(self):
        """Ensure a non-exhausted current chunk; False at end of stream."""
        while not self.eof and (self._c is None or self._pos >= self._c[self._N]):
            chunk = self._pf.get()
            if chunk is None:
                self._c, self.eof = None, True
                return False
            data, offsets, ptokens, ptokens2, lengths, clean, b2ok, n = chunk
            # dirty-record text is materialized lazily at first take():
            # skip() drives ready() over every chunk too (--hosts round
            # robin, --resume restart), and re-parsing windows the host
            # never processes would waste (N-1)/N of the dirty-parse cost
            self._c = [
                data, offsets, ptokens, ptokens2, lengths, b2ok, n, clean,
                self._RECS_UNSET,
            ]
            self._pos = 0
        return not self.eof

    def chunk_avail(self):
        """Rows left in the current window (call after ready() is True)."""
        return self._c[self._N] - self._pos

    def skip(self, k):
        """Skip up to k records (another host's chunk, or --resume restart);
        returns the number actually skipped (< k only at end of stream)."""
        done = 0
        while done < k and self.ready():
            step = min(k - done, self.chunk_avail())
            self._pos += step
            done += step
        return done

    def take(self, k):
        """Advance k rows (k <= chunk_avail()). Returns (data,
        offsets_rows_copy, ptokens_rows, ptokens2_rows, lengths_rows,
        b2ok_rows, recs, start): offsets rows are copied because the
        stream's slot arrays rotate while the batch is in flight;
        token/length views are copied into the staging buffers
        synchronously by the caller."""
        data, offsets, ptokens, ptokens2, lengths, b2ok, n, clean, recs = self._c
        if recs is self._RECS_UNSET:
            recs = (
                None
                if clean[:n].all()
                else records_from_chunk_bytes(data, offsets, n)
            )
            self._c[8] = recs
        s = self._pos
        self._pos = s + k
        return (
            data,
            offsets[s : s + k].copy(),
            ptokens[s : s + k],
            ptokens2[s : s + k],
            lengths[s : s + k],
            b2ok[s : s + k],
            recs,
            s,
        )


class _Compressed:
    """Ordered-write token for payload blocks compressing in the pool."""

    __slots__ = ("futs", "view")

    def __init__(self, futs, view):
        self.futs = futs
        self.view = view


class _Writer:
    """Single writer thread: preserves per-file write order, hides gzip
    deflate + file IO behind device compute.

    Gather payloads are passed ZERO-COPY as memoryviews into pooled scratch
    bytearrays: acquire_scratch() blocks until a pool buffer is free (natural
    backpressure), and the writer returns the buffer to the pool after the
    write -- no per-payload bytes() copy holding the GIL.

    With compress_threads > 1, large payloads bound for a gz output are
    split into ~BLOCK-byte slices and compressed CONCURRENTLY as independent
    gzip members (io/gzfast.compress_member releases the GIL; concatenated
    members are a valid gzip file). The writer thread then appends the
    compressed members in submission order, so per-file byte order stays
    deterministic. This lifts the single-thread deflate ceiling that
    otherwise caps end-to-end throughput when outputs are gzipped -- the
    reference has the same serial-deflate bottleneck
    (detect.py:739, compresslevel=5 on one thread).

    Adaptive gz level: when NO explicit --gz-level was given and producers
    spend a sustained fraction of wall time blocked in acquire_scratch()
    (every scratch buffer stuck behind the deflate/write stage -- the
    signature of a write-bound run, e.g. six gz outputs on two cores),
    the writer drops the libdeflate level from the default 3 to 1 for the
    REST of the run, at a slightly worse ratio. Mixed-level members are a
    valid gzip file and decompressed content is unchanged, so outputs stay
    content-identical; an explicit --gz-level (CLI or config) disables
    adaptation entirely."""

    _DONE = object()
    _CLOSE = object()
    POOL = 4
    BLOCK = 2 << 20
    # adaptive-drop trigger: > ADAPT_FRAC of wall blocked on scratch, with
    # at least ADAPT_MIN_BLOCKED s accumulated (guards tiny runs/noise)
    ADAPT_MIN_BLOCKED = 0.5
    ADAPT_FRAC = 0.10
    ADAPT_LEVEL = 1

    def __init__(self, compress_threads=0, gz_level=None, on_level_drop=None,
                 timer=None):
        self._gz_level = gz_level
        self._adapt = gz_level is None
        self._on_level_drop = on_level_drop
        self._dropped = False
        self._blocked = 0.0
        if timer is None:
            from ribodetector_tpu_torch.runtime.profiling import StageTimer

            timer = StageTimer(enabled=False)
        self._timer = timer
        import time as _time

        self._mono = _time.monotonic
        self._start = self._mono()
        self._pool = None
        if compress_threads > 1:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(
                compress_threads, thread_name_prefix="rd-deflate"
            )
        self._q = queue.Queue()
        self._free = queue.Queue()
        # deeper scratch pool when compression is pipelined in parallel
        for _ in range(self.POOL + (compress_threads if self._pool else 0)):
            self._free.put(bytearray())
        self._exc = None
        self._t = threading.Thread(target=self._run, daemon=True, name="rd-write")
        self._t.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is self._DONE:
                return
            fh, payload, scratch = item
            if fh is None:  # ordered callback (see call())
                try:
                    if self._exc is None:
                        payload()
                except BaseException as e:
                    if self._exc is None:
                        self._exc = e
                continue
            if payload is self._CLOSE:
                try:
                    fh.close()
                except BaseException as e:  # pragma: no cover - disk errors
                    if self._exc is None:
                        self._exc = e
                continue
            try:
                # after a write error, keep draining so producers unblock
                # and see the stored error
                if (
                    self._dropped
                    and isinstance(fh, MemberGzipWriter)
                    and fh.level != self.ADAPT_LEVEL
                ):
                    # adaptive drop reached a streaming handle: switch it at
                    # this member boundary (only ever reached when the run
                    # had NO explicit level, so every handle holds the
                    # default; both calls stay on this thread)
                    fh.set_level(self.ADAPT_LEVEL)
                if isinstance(payload, _Compressed):
                    for fut in payload.futs:
                        member = fut.result()
                        if self._exc is None:
                            with self._timer.stage("write_io"):
                                fh.write_raw(member)
                elif self._exc is None or not payload:
                    with self._timer.stage("write_io"):
                        fh.write(payload)
            except BaseException as e:  # pragma: no cover - disk errors
                if self._exc is None:  # keep the root cause, not a follow-on
                    self._exc = e
            finally:
                if isinstance(payload, _Compressed):
                    # every compress task must finish before its source view
                    # is released and the scratch recycled (a pool thread
                    # could otherwise read a buffer being overwritten)
                    for fut in payload.futs:
                        try:
                            fut.result()
                        except BaseException:  # pragma: no cover
                            pass
                    payload.view.release()
                elif isinstance(payload, memoryview):
                    payload.release()
                if scratch is not None:
                    # views dropped above: a live memoryview would block the
                    # pooled bytearray's next resize (BufferError)
                    self._free.put(scratch)

    def acquire_scratch(self):
        """Take a pooled bytearray; hand it back via write(..., scratch=).
        Blocking here means every buffer is stuck behind the deflate/write
        stage -- the adaptive-gz-level signal (class docstring)."""
        if self._exc is not None:
            raise self._exc
        try:
            return self._free.get_nowait()
        except queue.Empty:
            pass
        t0 = self._mono()
        s = self._free.get()
        self._blocked += self._mono() - t0
        if (
            self._adapt
            and not self._dropped
            and self._blocked > self.ADAPT_MIN_BLOCKED
            and self._blocked > self.ADAPT_FRAC * (self._mono() - self._start)
        ):
            # flip ONCE for the rest of the run: the pool path reads
            # _gz_level at submit time; streaming MemberGzipWriter handles
            # are switched by the writer thread as their items pass (_run)
            self._dropped = True
            self._gz_level = self.ADAPT_LEVEL
            if self._on_level_drop is not None:
                try:
                    self._on_level_drop(self.ADAPT_LEVEL)
                except Exception:  # pragma: no cover - logging only
                    pass
        return s

    def write(self, fh, payload, scratch=None):
        if self._exc is not None:
            # release the payload view BEFORE recycling its scratch: the
            # caller's traceback frames keep the view alive while the
            # error propagates, and a still-exported bytearray back in the
            # pool would turn the real disk error into a confusing
            # BufferError at the next producer's resize
            if isinstance(payload, memoryview):
                payload.release()
            if scratch is not None:
                self._free.put(scratch)
            raise self._exc
        if (
            self._pool is not None
            and len(payload) > self.BLOCK
            and isinstance(fh, MemberGzipWriter)
        ):
            view = payload if isinstance(payload, memoryview) else memoryview(payload)
            futs = [
                self._pool.submit(
                    self._compress_slice, view, o, o + self.BLOCK, self._gz_level
                )
                for o in range(0, len(view), self.BLOCK)
            ]
            payload = _Compressed(futs, view)
        self._q.put((fh, payload, scratch))

    def _compress_slice(self, view, start, end, level=None):
        """Pool-task body: the sub-view is created AND released inside the
        task, so no export of the pooled scratch buffer can outlive the
        future's completion. (Submitting pre-made slices would let the
        executor's work item retain them slightly past fut.result() --
        CPython deletes the item only after run() returns -- and the
        recycled scratch's next resize would hit BufferError.)"""
        sub = view[start:end]
        try:
            with self._timer.stage("deflate"):
                if level is None:
                    return compress_member(sub)
                return compress_member(sub, level=level)
        finally:
            sub.release()

    def close_fh(self, fh):
        """Enqueue an ordered close for fh: it happens strictly after every
        write already enqueued for it."""
        self._q.put((fh, self._CLOSE, None))

    def call(self, fn):
        """Enqueue fn to run on the writer thread strictly after everything
        already enqueued (ordered side effects -- e.g. a --resume manifest
        update that must not land before its chunk's writes are on disk).
        Skipped after a write error; an exception from fn is stored and
        propagated like a write error."""
        self._q.put((None, fn, None))

    def close(self):
        self._q.put(self._DONE)
        self._t.join()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
        if self._exc is not None:
            raise self._exc


def records_per_chunk(p):
    """Logical chunk size in records. --chunk_size parity with the
    reference (chunk = batch_size * chunk_size reads, detect.py:371); in
    whole-file mode, moderate streaming chunks so the host allocator reuses
    warm arenas (fresh multi-hundred-MB buffers hit this host's slow
    first-touch page faults) -- memory stays bounded either way, strictly
    better than the reference's load-everything behavior (detect.py:131-132).
    Shared by the runner and the --resume manifest so a resumed run always
    skips the same record count per completed chunk."""
    if p.chunk_size is not None:
        return p.batch_size * p.chunk_size
    return max(p.batch_size, 131072)


def card_slices(st, sl, n, paired):
    """[(token blocks, length blocks)] of each of n cards: contiguous row
    slices of the staged batch, as equal as the row count allows. For a
    pair batch (R1 rows in the first half, R2 in the second) a card takes
    the same slice of both halves, R1 block first."""
    rows = len(st) // 2 if paired else len(st)
    bounds = [rows * k // n for k in range(n + 1)]
    out = []
    for a, b in zip(bounds, bounds[1:]):
        if paired:
            out.append(([st[a:b], st[rows + a : rows + b]],
                        [sl[a:b], sl[rows + a : rows + b]]))
        else:
            out.append(([st[a:b]], [sl[a:b]]))
    return out


def _to_device(blocks, dev):
    """numpy row blocks -> one tensor on dev holding them in order. A
    single block is copied as it is (asynchronously from pinned memory);
    several land in one device buffer, block by block."""
    import torch

    if len(blocks) == 1:
        return torch.from_numpy(blocks[0]).to(dev, non_blocking=True)
    first = blocks[0]
    out = torch.empty((sum(len(b) for b in blocks), *first.shape[1:]),
                      dtype=torch.from_numpy(first[:0]).dtype, device=dev)
    row = 0
    for b in blocks:
        out[row : row + len(b)].copy_(torch.from_numpy(b), non_blocking=True)
        row += len(b)
    return out


def records_from_chunk_bytes(data, offsets, n):
    """Python-tuple records for a (rare) dirty chunk: identical semantics to
    the portable parser (rstrip quirks included)."""
    end = int(offsets[n - 1, 1]) if n else 0
    fh = io.TextIOWrapper(io.BytesIO(data[:end]), encoding="latin-1")
    return list(seq_parser(fh, "fastq"))


class _BucketStager:
    """Reusable staging buffers for one length bucket: acquire() pops a free
    (tokens [rows, pl_b] uint8, lengths [rows] int32, rows_idx [cap] int32)
    triple or allocates one; release() returns it once the batch's labels
    were fetched. Lazy, so buckets that never see a read cost nothing.

    With pinned=True (a run on the card) the token and length buffers are
    page-locked host tensors viewed as numpy, so their host->device copies
    run asynchronously; a triple is released only after its labels came
    back, so a pinned source is never overwritten while its copy is in
    flight."""

    def __init__(self, rows, pl, cap, pinned=False):
        self.rows, self.pl, self.cap = rows, pl, cap
        self.pinned = pinned
        self._free = []

    def _host(self, shape, dtype):
        if not self.pinned:
            return np.zeros(shape, dtype)
        import torch

        tdt = {np.uint8: torch.uint8, np.int32: torch.int32}[dtype]
        return torch.zeros(shape, dtype=tdt, pin_memory=True).numpy()

    def acquire(self):
        if self._free:
            return self._free.pop()
        tok = self._host((self.rows, self.pl), np.uint8)
        tok.fill(_PAD_BYTE)
        return (
            tok,
            self._host((self.rows,), np.int32),
            np.zeros(self.cap, np.int32),
        )

    def release(self, bufs):
        self._free.append(bufs)


class _ChunkAcc:
    """Write accumulator for bucketed runs (normally one per logical chunk).

    Bucket routing reorders device batches, so labels scatter back into an
    accumulator-ordered array and the accumulator writes only when its last
    batch finished; batches finish FIFO, so accumulators complete (and
    write) in input order and the output files keep the unbucketed path's
    record order. segs/segs2 remember which parse-window rows each aligned
    cursor take covered, for the in-order byte-gather writes.

    Window-span bound: the byte-gather sources stay pinned until the
    accumulator writes, but the chunk streams recycle their window slots
    unconditionally (slot-pool sizing in FastqChunkStream). Records much
    larger than the sizing estimate make accumulators span many windows,
    and several unwritten accumulators can be alive at once (their batches
    queue up to DEPTH deep) -- so the runner enforces a GLOBAL per-side
    budget of pinned windows (NativeRunner._pinned refcounts +
    WINDOW_BUDGET): before consuming a new window it drains finished
    batches until older accumulators have written and unpinned, and it
    splits the current
    accumulator (same chunk, same file handles) when that accumulator
    alone would span too many windows. close_fhs marks the chunk's final
    accumulator (parts mode closes the chunk's part files after it
    writes).
    """

    MAX_WINDOWS = 3  # per side, per accumulator

    __slots__ = (
        "ci", "fhs", "labels", "n", "inflight", "closed", "segs", "segs2",
        "close_fhs", "winids", "records_cum",
    )

    def __init__(self, ci, fhs, cap):
        self.ci = ci
        self.fhs = fhs
        self.labels = np.empty(cap, np.int8)
        self.n = 0
        self.inflight = 0
        self.closed = False
        self.segs = []  # (data, offsets_rows_copy, recs, start, cnt, row0)
        self.segs2 = []  # paired: same boundaries for the R2 side
        self.close_fhs = True
        self.winids = (set(), set())  # per-side window ids this acc pins
        self.records_cum = 0  # records through this chunk, for the manifest

    def would_overflow(self, new_ids):
        """True when noting these per-side window ids would exceed this
        accumulator's own per-side span bound."""
        return any(
            len(self.winids[s] | {wid}) > self.MAX_WINDOWS
            for s, wid in enumerate(new_ids)
        )


class NativeRunner:
    """Drives the native chunk streams through the Predictor's classify
    step and byte-gather writers. Owns the reusable staging buffers; one
    instance per detect() run."""

    DEPTH = 8  # in-flight device batches
    PREFETCH = 1  # chunks buffered per _Prefetcher queue

    def __init__(self, predictor):
        self.p = predictor
        self._hosts = getattr(predictor, "hosts", 1)
        self._host_id = getattr(predictor, "host_id", 0)
        # tuning knobs (config runtime.depth / runtime.dispatchers):
        # pipeline depth and H2D dispatcher-thread count
        rt = predictor.config.get("runtime", {})
        self.DEPTH = int(rt.get("depth", self.DEPTH))
        # config values bypass any CLI validation (same reasoning as the
        # gz_level check): depth < 2 would shrink the pinned-window budget
        # below _ChunkAcc.MAX_WINDOWS and break the slot-pool sizing proof
        if not 2 <= self.DEPTH <= 64:
            raise RuntimeError(
                f"runtime.depth must be in [2, 64], got {self.DEPTH}"
            )
        self._dispatchers_cfg = rt.get("dispatchers", None)
        if self._dispatchers_cfg is not None:
            self._dispatchers_cfg = int(self._dispatchers_cfg)
            if not 1 <= self._dispatchers_cfg <= 32:
                raise RuntimeError(
                    "runtime.dispatchers must be in [1, 32], got "
                    f"{self._dispatchers_cfg}"
                )
        # Device batch: the reference's -m formula (quirk #9) sizes chunks
        # (--chunk_size parity) and bounds host memory; the device call
        # itself is lifted to up to 131072 rows per input file to cut
        # per-call overhead.
        self.dbs = max(predictor.batch_size, min(131072, self._records_per_chunk()))
        self._need_lengths = predictor.semantics == "packed"
        # 2-bit transfer lane for clean full-length reads (runtime.b2=false
        # pins everything to base-5; labels are identical either way)
        self._b2_enabled = rt.get("b2", True) is not False
        self._writer = None
        import time

        self._last_log = time.monotonic()
        self._last_read = 0
        self._resume = None
        self._parts = None
        self._bucket_dispatcher = None
        # live progress bar (visual parity with the reference's tqdm):
        # tqdm auto-disables on non-tty (disable=None), so logs/pipes keep
        # the throttled text lines instead
        self._pbar = None
        try:
            from tqdm import tqdm
        except ImportError:  # pragma: no cover - tqdm is optional
            tqdm = None
        if tqdm is not None:
            self._pbar = tqdm(
                total=None, unit=" reads", disable=None, smoothing=0.1,
                mininterval=1.0,
            )
            if getattr(self._pbar, "disable", True):
                self._pbar.close()
                self._pbar = None

    # -- writing -------------------------------------------------------

    def _write_sel(self, fh, data, offsets, sel):
        if len(sel):
            with self.p.timer.stage("write"):
                scratch = self._writer.acquire_scratch()
                payload = native.gather_records(data, offsets, sel, scratch)
                self._writer.write(fh, payload, scratch=scratch)

    def _write_text(self, fh, records, sel):
        if len(sel):
            payload = (
                "\n".join("\n".join(records[i]) for i in sel) + "\n"
            ).encode("latin-1")
            self._writer.write(fh, payload)

    # -- length-bucketed mode ------------------------------------------
    #
    # Variable-length inputs route per read to the smallest padded-T bucket
    # (runtime/buckets.py): the recurrence runs T_bucket steps instead of
    # the full -l, with exact full-length dense semantics restored by the
    # zero-prefix backward-carry init (pad_gap in Predictor._build_infer).
    # Labels scatter back into chunk order (_ChunkAcc), so outputs are
    # byte-identical to the unbucketed path.

    # window pinning: a parse window must not be recycled by its stream
    # while an unwritten accumulator still references it for the deferred
    # byte-gather write. Budget per side = the slot pool minus the 3 slots
    # the stream itself cycles (1 being parsed + prefetch queue + slack),
    # i.e. DEPTH + PREFETCH.

    WINDOW_BUDGET = property(lambda self: self.DEPTH + self.PREFETCH)

    def _pin_overflow(self, new_ids):
        """Would consuming these windows exceed the per-side pinned-window
        budget across all unwritten accumulators?"""
        return any(
            len(self._pinned[s]) + (0 if wid in self._pinned[s] else 1)
            > self.WINDOW_BUDGET
            for s, wid in enumerate(new_ids)
        )

    def _pin_windows(self, acc, takes):
        for s, t in enumerate(takes):
            wid = id(t[0])
            if wid not in acc.winids[s]:
                acc.winids[s].add(wid)
                self._pinned[s][wid] += 1

    def _unpin_windows(self, acc):
        for s, ids in enumerate(acc.winids):
            c = self._pinned[s]
            for wid in ids:
                c[wid] -= 1
                if c[wid] <= 0:
                    del c[wid]
            ids.clear()

    def _bucket_infers(self, buckets):
        p = self.p
        emit = (
            ("pair_labels", p.args.ensure) if p.is_paired else "labels"
        )
        # one classify step per card for each lane (a tuple of one on a
        # single card)
        infers = [
            p._build_infers(packed_max_len=tb, emit=emit, pad_gap=p.len - tb)
            for tb in buckets
        ]
        rows = 2 * self.dbs if p.is_paired else self.dbs
        pinned = p.devices[0].type == "cuda"
        stagers = [
            _BucketStager(rows, native.b5_packed_len(tb), self.dbs, pinned)
            for tb in buckets
        ]
        if self._b2_enabled:
            # extra transfer lane for b2-eligible records (clean ACGTU at
            # full -l): the 2-bit rows are 25% smaller than base-5 on the
            # dominant H2D path. Such reads are full-length by definition,
            # so the lane is a twin of the top bucket (pad_gap 0); label
            # scatter-back by absolute index makes lane routing invisible
            # to output order. Building an infer launches nothing, so the
            # extra lane costs nothing unless a b2 record arrives.
            infers.append(
                p._build_infers(packed_max_len=p.len, emit=emit, pad_gap=0, fmt="b2")
            )
            stagers.append(
                _BucketStager(rows, native.b2_packed_len(p.len), self.dbs, pinned)
            )
        return infers, stagers

    def _device_call_with(self, infers, st, sl):
        """Runs on an rd-dispatch pool thread: host->device copy of the
        packed rows (asynchronous from pinned staging memory), the classify
        step, and a blocking copy of the labels back -- so the staging slot
        is free to reuse once the future resolves.

        With several cards (-d a,b) the batch splits into contiguous row
        slices, one per card, each copied to its card and classified there
        on that card's current stream; every slice is launched before any
        labels are fetched, and the labels come back in row order. A pair
        batch holds R1 in its first half and R2 in its second, so a card
        takes the same slice of both halves and reconciles its own pairs
        (ensure "none" sums the two ends' logits, which per-read labels
        could not). A read's logits do not depend on its batch (the
        kernels' row invariance), so the labels equal a one-card run's."""
        devices = self.p.devices
        with self.p.timer.stage("h2d_call"):
            if len(devices) == 1:
                return self._classify_on(infers[0], devices[0], [st], [sl]).cpu().numpy()
            outs = [
                self._classify_on(infer, dev, toks, lens)
                for infer, dev, (toks, lens) in zip(
                    infers, devices,
                    card_slices(st, sl, len(devices), self.p.is_paired),
                )
            ]
            return np.concatenate([o.cpu().numpy() for o in outs])

    def _classify_on(self, infer, dev, toks, lens):
        """Launch `infer` on dev over the row blocks `toks` (and `lens`,
        for packed semantics) stacked in order; returns the device result."""
        import contextlib

        import torch

        ctx = torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
        with ctx:
            st_dev = _to_device(toks, dev)
            if self._need_lengths:
                return infer(st_dev, _to_device(lens, dev))
            return infer(st_dev)

    def _dispatch_bucket(self, pending, infers, stagers, partial, b, acc):
        tok, lens, idxs, fill = partial[b]
        partial[b] = None
        bs = self.dbs
        # Partial batches (the per-chunk bucket flush) dispatch at the
        # smallest power-of-two ladder size >= fill instead of the full
        # device batch: a flush remnant pays <= 2x its own rows, not a full
        # [dbs, T_b] compute + transfer.
        bsel = bs
        for k in (4, 3, 2, 1):
            cand = bs >> k
            if cand >= 1024 and fill <= cand:
                bsel = cand
                break
        paired = self.p.is_paired
        if bsel < bs:
            if paired:
                # R2 rows move from the full-batch offset to the sliced one
                # (regions never overlap: bsel + fill <= 2*bsel <= bs)
                tok[bsel : bsel + fill] = tok[bs : bs + fill]
                if self._need_lengths:
                    lens[bsel : bsel + fill] = lens[bs : bs + fill]
            st = tok[: 2 * bsel] if paired else tok[:bsel]
            sl = lens[: 2 * bsel] if paired else lens[:bsel]
        else:
            st, sl = tok, lens
        with self.p.timer.stage("infer_dispatch"):
            fut = self._bucket_dispatcher.submit(
                self._device_call_with, infers[b], st, sl
            )
        acc.inflight += 1
        pending.append((acc, (tok, lens, idxs), fill, fut, stagers[b]))
        if len(pending) > self.DEPTH:
            self._finish_bucketed(*pending.popleft())

    def _finish_bucketed(self, acc, bufs, fill, fut, stager):
        with self.p.timer.stage("infer_wait"):
            labels = fut.result()[:fill]
        tok, lens, idxs = bufs
        acc.labels[idxs[:fill]] = labels
        stager.release(bufs)
        acc.inflight -= 1
        if acc.closed and acc.inflight == 0:
            self._write_chunk_bucketed(acc)

    def _route_into(self, pending, infers, stagers, partial, acc, b_idx,
                    sides, row0=0):
        """Copy routed rows into per-lane partial batches; dispatch full
        ones. b_idx holds each record's lane index (bucket, or the extra
        2-bit lane); `sides` is one (b5_rows, b2_rows, lengths) triple per
        input file -- the 2-bit lane copies from the b2 rows, every other
        lane from base-5."""
        bs = self.dbs
        need_len = self._need_lengths
        b2lane = len(stagers) - 1 if self._b2_enabled else -1
        t5a, t2a, lna = sides[0]
        paired = len(sides) == 2
        if paired:
            t5b, t2b, lnb = sides[1]
        for b in range(len(stagers)):
            sel = np.flatnonzero(b_idx == b)
            if not len(sel):
                continue
            src_a = t2a if b == b2lane else t5a
            src_b = (t2b if b == b2lane else t5b) if paired else None
            pl = stagers[b].pl
            contiguous = len(sel) == len(b_idx)
            off = 0
            while off < len(sel):
                if partial[b] is None:
                    partial[b] = [*stagers[b].acquire(), 0]
                tok, ln, idxs, fill = partial[b]
                m = min(bs - fill, len(sel) - off)
                s = slice(off, off + m) if contiguous else sel[off : off + m]
                tok[fill : fill + m] = src_a[s, :pl]
                if src_b is not None:
                    tok[bs + fill : bs + fill + m] = src_b[s, :pl]
                if need_len:
                    ln[fill : fill + m] = lna[s]
                    if paired:
                        ln[bs + fill : bs + fill + m] = lnb[s]
                idxs[fill : fill + m] = (
                    np.arange(off, off + m, dtype=np.int32) + row0
                    if contiguous
                    else sel[off : off + m].astype(np.int32) + row0
                )
                fill += m
                partial[b][3] = fill
                off += m
                if fill == bs:
                    self._dispatch_bucket(pending, infers, stagers, partial, b, acc)

    def _flush_buckets(self, pending, infers, stagers, partial, acc):
        for b in range(len(stagers)):
            if partial[b] is not None and partial[b][3]:
                self._dispatch_bucket(pending, infers, stagers, partial, b, acc)
        acc.closed = True
        if acc.inflight == 0 and acc.n:
            self._write_chunk_bucketed(acc)

    def _write_chunk_bucketed(self, acc):
        counts, fhs = self._counts, acc.fhs
        paired = self.p.is_paired
        labels = acc.labels
        seg_pairs = zip(acc.segs, acc.segs2) if paired else zip(acc.segs)
        for segs in seg_pairs:
            data0, bo0, recs0, start0, cnt, row0 = segs[0]
            if self._pbar is not None:
                self._pbar.update(cnt)  # records finished + being written
            lab = labels[row0 : row0 + cnt]
            sel = {v: np.flatnonzero(lab == v) for v in ((0, 1, -1) if paired else (0, 1))}
            counts["norrna"] += len(sel[0])
            counts["rrna"] += len(sel[1])
            if paired and "unclf" in fhs:
                counts["unclf"] += len(sel[-1])
            for side, (data, bo, recs, start, _, _) in enumerate(segs):
                if recs is None:
                    w = lambda fh, s: self._write_sel(fh, data, bo, s)
                else:
                    w = lambda fh, s: self._write_text(fh, recs, s + start)
                w(fhs["norrna"][side], sel[0])
                if "rrna" in fhs:
                    w(fhs["rrna"][side], sel[1])
                if paired and "unclf" in fhs:
                    w(fhs["unclf"][side], sel[-1])
        acc.segs.clear()
        acc.segs2.clear()
        self._unpin_windows(acc)
        if not acc.close_fhs:
            return
        # chunk complete: the manifest update runs ON THE WRITER THREAD,
        # ordered after every write just enqueued for this chunk, so there
        # is no per-chunk barrier here and DEPTH batches stay in flight
        # across chunk boundaries. The counts/records snapshots cover
        # exactly the chunks <= acc.ci because accumulators write FIFO.
        p, ci = self.p, acc.ci
        records, snap = acc.records_cum, dict(counts)
        if self._resume is not None:
            resume = self._resume
            self._writer.call(
                lambda: resume.complete_chunk(p, ci, fhs, records, snap)
            )
        elif self._parts is not None:
            for group in fhs.values():
                for fh in group:
                    self._writer.close_fh(fh)
            # own-chunk completion manifest: strictly AFTER the ordered
            # closes above, so it never names a chunk whose parts are still
            # open (a group relaunch skips it)
            parts = self._parts
            self._writer.call(
                lambda: parts.complete_chunk(p, ci, records, snap)
            )

    def _skip_records(self, curs, k):
        with self.p.timer.stage("parse"):
            for c in curs:
                c.skip(k)

    def run_bucketed(self, buckets):
        """THE run loop: single- and paired-end bucketed streaming (the
        paired case routes by the pair's larger bucket so both mates share
        one device call for on-device ensure reconciliation). Buckets-off
        runs go through here too, with a single full-size bucket list
        [max_len] -- routing is then the identity and each partial chunk
        tail still gets the power-of-two ladder flush sizes.

        --resume writes straight to the final outputs and completes the
        offset manifest on the writer thread (ResumeState); --hosts skips
        the chunks other hosts own (parse only); --coordinator writes each
        own chunk to part files (DistributedParts), and with --resume skips
        the own chunks an earlier run of the group completed."""
        p = self.p
        from ribodetector_tpu_torch.runtime.buckets import route_records

        paired = p.is_paired
        p._resume_buckets = list(buckets)  # part of the manifest config key
        distributed = getattr(p, "distributed", False)
        counts = {"norrna": 0, "rrna": 0, "unclf": 0}
        num_read = 0
        rpc = self._records_per_chunk()
        # everything that opens fds/threads happens INSIDE the try: a
        # failure in manifest restore or output opening must still release
        # the input streams
        ok = False
        resume = parts = fhs = None
        streams, curs = [], []
        try:
            streams = [
                make_chunk_stream(
                    f, p.len, rpc, depth=self.DEPTH, prefetch=self.PREFETCH,
                    timer=p.timer,
                )
                for f in p.input
            ]
            want_resume = getattr(p.args, "resume", False)
            resume = ResumeState(p) if want_resume and not distributed else None
            self._resume = resume
            parts = DistributedParts(p) if distributed else None
            self._parts = parts
            if resume:
                num_read, counts = resume.restore(p)
            elif parts and want_resume:
                # coordinated group relaunch: seed from this host's
                # completion manifest; completed own chunks are skipped
                # parse-only below
                num_read, counts = parts.restore(p)
            elif not parts:
                fhs = p._open_outputs(binary=True)
            if self._pbar is not None and num_read:
                # the live bar resumes from the restored record count so
                # its total agrees with the final summary
                self._pbar.n = num_read
                self._pbar.refresh()
            self._counts = counts
            self._writer = _Writer(
                compress_threads=self._compress_threads(),
                gz_level=getattr(p, "gz_level", None),
                timer=p.timer,
                on_level_drop=lambda lvl: p.logger.info(
                    "write stage is the bottleneck: dropping gz output "
                    "compression to libdeflate level %d for the rest of the "
                    "run (~4%% larger files; pass --gz-level to pin a level "
                    "instead)",
                    lvl,
                ),
            )
            timer = p.timer
            curs = [
                _RecordCursor(_Prefetcher(iter(s), depth=self.PREFETCH))
                for s in streams
            ]
            # Every batch owns a pooled staging buffer (released only after
            # its labels are fetched), so a pool of dispatcher threads can
            # keep several copies and classify steps queued on the device.
            # Labels scatter by index, so completion order is irrelevant.
            from concurrent.futures import ThreadPoolExecutor

            workers = self._dispatchers_cfg
            if workers is None:
                workers = 2 if len(buckets) == 1 else 4
            self._bucket_dispatcher = ThreadPoolExecutor(
                max_workers=int(workers), thread_name_prefix="rd-dispatch"
            )
            from collections import Counter, deque

            self._pinned = (Counter(), Counter())
            infers, stagers = self._bucket_infers(buckets)
            partial = [None] * len(stagers)
            pending = deque()
            ci = resume.chunks_done if resume else 0
            if ci:
                self._skip_records(curs, ci * rpc)
            while True:
                with timer.stage("parse"):
                    if not all(c.ready() for c in curs):
                        break
                if self._hosts > 1 and not host_chunk_assignment(
                    ci, self._hosts, self._host_id
                ):
                    self._skip_records(curs, rpc)
                    ci += 1
                    continue
                if parts and parts.skip_chunk(ci):
                    # own chunk already completed before a group relaunch:
                    # its parts are final on disk -- advance parse-only
                    self._skip_records(curs, rpc)
                    ci += 1
                    continue
                if resume:
                    chunk_fhs = resume.open_chunk(p, ci)
                elif parts:
                    chunk_fhs = parts.open_chunk(p, ci)
                else:
                    chunk_fhs = fhs
                acc = _ChunkAcc(ci, chunk_fhs, rpc)
                done = 0
                while done < rpc:
                    with timer.stage("parse"):
                        if not all(c.ready() for c in curs):
                            break
                    cnt = min(rpc - done, *(c.chunk_avail() for c in curs))
                    takes = [c.take(cnt) for c in curs]
                    new_ids = [id(t[0]) for t in takes]
                    if acc.segs and acc.would_overflow(new_ids):
                        # per-acc window-span bound (see _ChunkAcc): split the
                        # write accumulator mid-chunk
                        acc.close_fhs = False
                        self._flush_buckets(pending, infers, stagers, partial, acc)
                        acc = _ChunkAcc(ci, chunk_fhs, rpc)
                    # global budget: drain finished batches until the pinned
                    # window count (all unwritten accs) fits the stream slot
                    # pools -- older accs write FIFO and unpin as we drain
                    while pending and self._pin_overflow(new_ids):
                        self._finish_bucketed(*pending.popleft())
                    self._pin_windows(acc, takes)
                    row0 = acc.n
                    d, bo, toks, toks_b2, lens, ok2, recs, start = takes[0]
                    acc.segs.append((d, bo, recs, start, cnt, row0))
                    b_idx = route_records(lens, toks, buckets, p.len)
                    nb = np.int16(len(buckets))  # the 2-bit lane's index
                    if paired:
                        (d2, bo2, toksB, toksB_b2, lensB, ok2B, recs2,
                         start2) = takes[1]
                        acc.segs2.append((d2, bo2, recs2, start2, cnt, row0))
                        b_idx = np.maximum(
                            b_idx, route_records(lensB, toksB, buckets, p.len)
                        )
                        if self._b2_enabled:
                            # a pair rides the 2-bit lane only when BOTH
                            # ends are eligible (one device batch per pair)
                            b_idx = np.where(
                                (ok2 != 0) & (ok2B != 0), nb, b_idx
                            )
                        self._route_into(
                            pending, infers, stagers, partial, acc, b_idx,
                            [(toks, toks_b2, lens), (toksB, toksB_b2, lensB)],
                            row0=row0,
                        )
                    else:
                        if self._b2_enabled:
                            b_idx = np.where(ok2 != 0, nb, b_idx)
                        self._route_into(
                            pending, infers, stagers, partial, acc, b_idx,
                            [(toks, toks_b2, lens)], row0=row0,
                        )
                    acc.n += cnt
                    done += cnt
                num_read += done
                # the manifest's record count, set before the flush:
                # _flush_buckets may write and complete the chunk at once
                acc.records_cum = num_read
                self._flush_buckets(pending, infers, stagers, partial, acc)
                ci += 1
                self._log_progress(num_read)
            while pending:
                self._finish_bucketed(*pending.popleft())
            self._writer.close()
            if self._pbar is not None:
                self._pbar.close()
                self._pbar = None
            if resume:
                resume.merge(p)
            elif not parts:
                p._close_outputs(fhs)
            p._log_summary(num_read, counts)
            ok = True
        finally:
            # producer threads + input fds are released on BOTH paths (a
            # paired run truncated to the shorter file leaves the longer
            # side's prefetcher alive); writer/handles only on failure
            for c in curs:
                c._pf.stop()
            for s in streams:
                s.close()
            if not ok:
                self._abort_cleanup(resume, parts, fhs)

    def _abort_cleanup(self, resume, parts, fhs):
        """Best-effort teardown after a FAILED run (the primary exception
        is already propagating; nothing here may mask it): the writer
        thread + deflate pool, open output handles, and the progress bar.
        A --resume manifest and completed part files stay on disk: the
        run remains resumable."""
        if self._pbar is not None:
            try:
                self._pbar.close()
            except Exception:
                pass
            self._pbar = None
        if self._writer is not None:
            try:
                self._writer.close()
            except BaseException:
                pass
        try:
            if resume is not None:
                resume.close_handles()
            elif parts is not None:
                # in-flight per-chunk part handles; completed chunks'
                # handles were already closed by the writer thread (close
                # is idempotent)
                parts.close_handles()
            elif fhs is not None:
                self.p._close_outputs(fhs)
        except Exception:
            pass

    # ------------------------------------------------------------------

    def _log_progress(self, num_read):
        """Per-chunk progress. On a tty a live tqdm bar advances as records
        finish. Chunked mode additionally logs every chunk (the reference's
        per-chunk "N sequences finished!" message); whole-file mode without
        a tty logs the same message throttled to every >= 5 s, with
        reads/s."""
        import time

        if self.p.chunk_size is not None:
            self.p._log_progress(num_read)
            return
        if self._pbar is not None:
            return  # the live bar carries count + rate
        now = time.monotonic()
        if now - self._last_log >= 5.0:
            rate = (num_read - self._last_read) / (now - self._last_log)
            self.p._log_progress(num_read, rate=rate)
            self._last_log = now
            self._last_read = num_read

    def _compress_threads(self):
        """Deflate pool size: the CLI's -t host-thread budget, capped at the
        machine and at 8 (past that the members are write-bound)."""
        t = getattr(self.p.args, "threads", 0) or 0
        return max(0, min(int(t), os.cpu_count() or 1, 8))

    def _records_per_chunk(self):
        return records_per_chunk(self.p)

    def run(self):
        from ribodetector_tpu_torch.runtime.buckets import choose_buckets

        p = self.p
        spec = getattr(p.args, "buckets", None) or p.config.get(
            "runtime", {}
        ).get("buckets", "auto")
        # one engine for every mode: buckets off (or degenerate at this -l)
        # runs the same loop with a single full-size bucket
        buckets = choose_buckets(p.len, spec) or [p.len]
        try:
            self.run_bucketed(buckets)
        finally:
            if self._bucket_dispatcher is not None:
                self._bucket_dispatcher.shutdown(wait=False, cancel_futures=True)


def resolved_kernel(p):
    """The kernel as this process runs it, for the --resume config keys:
    "cuda" with the CUDA kernel that runs the precision mode under the
    compute dtype and the build key of the kernel library (a rebuilt
    tensor-core kernel sums in another order, so its logits differ in the
    last bits), or "plain" (the CPU recurrence)."""
    if p.kernel != "cuda":
        return {"kernel": p.kernel, "kernel_mode": None, "kernel_build": None}
    import torch

    from ribodetector_tpu_torch.ops.build import kernel_library_key
    from ribodetector_tpu_torch.ops.dispatch import kernel_mode

    return {
        "kernel": "cuda",
        "kernel_mode": kernel_mode(p.precision_mode, getattr(torch, p.compute_dtype)),
        "kernel_build": kernel_library_key(),
    }


def _atomic_json_dump(path, obj):
    """Write obj as JSON via tmp+fsync+rename: the rename must never beat
    the data to disk (shared by both resume-manifest writers)."""
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(obj, fh)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def _load_manifest(path, want_config, what="--resume manifest"):
    """Load a completion manifest, refusing corrupt or mismatched-config
    files with the same wording both resume flavors use. Returns the
    parsed dict or None when the file does not exist."""
    if not os.path.exists(path):
        return None
    try:
        with open(path) as fh:
            m = json.load(fh)
    except ValueError as e:
        raise RuntimeError(
            "{} {} is corrupt (interrupted while being written?); remove "
            "it to start fresh.".format(what, path)
        ) from e
    got = m.get("config")
    if got != want_config:
        # name what differs: a manifest of the JAX package records its
        # kernel as "pallas" or "scan", one of another kernel build records
        # another build key
        if isinstance(got, dict):
            diff = sorted(k for k in set(got) | set(want_config)
                          if got.get(k) != want_config.get(k))
            detail = ", ".join(
                f"{k}: {got.get(k)!r} here {want_config.get(k)!r}" for k in diff
            )
        else:
            detail = "no config"
        raise RuntimeError(
            "{} {} was written by a different run configuration ({}); "
            "remove it to start fresh.".format(what, path, detail)
        )
    return m


def output_groups(p):
    """{group: [final output paths]} for a Predictor's run (norrna always;
    rrna when requested; unclf for paired -e both, quirk #5)."""
    groups = {"norrna": list(p.output)}
    if p.rrna is not None:
        groups["rrna"] = list(p.rrna)
    if p.is_paired and p.args.ensure == "both":
        groups["unclf"] = [f + ".unclassified.gz" for f in p.output]
    return groups


class ResumeState:
    """Byte-offset completion manifest enabling restartable streaming.

    The reference loses ALL work on a crash mid-run. With --resume, writes go STRAIGHT to the final
    output files and a manifest (`<output[0]>.progress.json`) atomically
    records, after each completed chunk, the byte offset every output had
    reached; an interrupted run reopens the outputs, truncates each to its
    last completed offset (discarding the partial chunk's tail), and skips
    the completed records. gz outputs are safe to cut at any write
    boundary because the native writer emits one gzip member per payload
    (io/gzfast.MemberGzipWriter; concatenated members are a valid gzip
    file).

    Offsets make resume IO-identical to a normal run plus one small
    manifest write per chunk (a part-file layout would write every output
    twice). Manifest updates run on the writer thread (ordered after the
    chunk's writes + flush), so the pipeline keeps its full depth.
    """

    MANIFEST_SUFFIX = ".progress.json"

    def __init__(self, p):
        self.manifest_path = p.output[0] + self.MANIFEST_SUFFIX
        self.chunks_done = 0
        self._offsets = {}
        self._fhs = None
        self._wd = None  # cached weights digest (hashed once per run)

    def _config_key(self, p):
        # v3: byte-offset manifests over the final outputs.
        # EVERY setting that affects labels or the output-file set is part
        # of the key -- resuming with a changed --semantics / --precision /
        # --kernel / --buckets / compute dtype / WEIGHTS would mix numeric
        # regimes (or models) in one file, and a changed output list would
        # truncate a file the interrupted run never tracked. The kernel is
        # recorded RESOLVED (resolved_kernel), so resuming on a host that
        # runs another kernel, or another build of it, is refused too.
        # (gz_level is deliberately absent: it only changes compressed
        # bytes, not content; so is the number of cards, which changes no
        # label.)
        return {
            "v": 3,
            "inputs": list(p.input),
            "outputs": list(p.output),
            "rrna": None if p.rrna is None else list(p.rrna),
            "len": p.len,
            "ensure": p.args.ensure,
            "records_per_chunk": records_per_chunk(p),
            "semantics": p.semantics,
            "precision": p.precision_mode,
            "compute_dtype": str(p.compute_dtype),
            **resolved_kernel(p),
            "buckets": getattr(p, "_resume_buckets", None),
            "weights": self._weights_digest(p),
        }

    def _weights_digest(self, p):
        """Identity of the loaded weights (path alone can alias different
        checkpoints across runs). Hashed once per run (cached: the config
        key is rebuilt per completed chunk on the writer thread)."""
        if self._wd is None:
            import hashlib

            h = hashlib.sha1()
            try:
                with open(p.state_file, "rb") as fh:
                    for blk in iter(lambda: fh.read(1 << 20), b""):
                        h.update(blk)
                self._wd = h.hexdigest()[:16]
            except OSError:  # pragma: no cover - state_file was just loaded
                self._wd = "unknown"
        return self._wd

    # -- lifecycle -----------------------------------------------------

    def restore(self, p):
        """Load the manifest (if any) and return (num_read, counts); the
        runner then skips chunks_done * records_per_chunk records on every
        input cursor (record-exact, so paired inputs stay aligned)."""
        counts = {"norrna": 0, "rrna": 0, "unclf": 0}
        num_read = 0
        m = _load_manifest(self.manifest_path, self._config_key(p))
        if m is not None:
            self.chunks_done = int(m["chunks_done"])
            num_read = int(m["records_done"])
            counts.update(m["counts"])
            self._offsets = dict(m.get("offsets", {}))
            p.logger.info(
                "Resuming after {} completed chunks ({} records)".format(
                    self.chunks_done, num_read
                )
            )
        return num_read, counts

    def open_chunk(self, p, ci):
        """The final output handles (opened once, truncated to the restored
        offsets -- a partial chunk's tail from the interrupted run is
        discarded). Every chunk shares them."""
        if self._fhs is None:
            from ribodetector_tpu_torch.io.gzfast import MemberGzipWriter

            self._fhs = {}
            for group, files in output_groups(p).items():
                handles = []
                for f in files:
                    open(f, "ab").close()  # ensure it exists
                    off = int(self._offsets.get(f, 0))
                    if os.path.getsize(f) < off:
                        # os.truncate would EXTEND a shorter file with NUL
                        # bytes -- silent corruption. The output was
                        # deleted/modified since the interrupted run.
                        raise RuntimeError(
                            "--resume: output {} is shorter than the "
                            "manifest's recorded offset ({} < {}); it was "
                            "modified or removed since the interrupted "
                            "run. Remove the manifest and outputs to "
                            "start fresh.".format(
                                f, os.path.getsize(f), off
                            )
                        )
                    os.truncate(f, off)
                    raw = open(f, "ab")
                    handles.append(
                        MemberGzipWriter(raw, level=getattr(p, "gz_level", None))
                        if f.endswith("gz")
                        else raw
                    )
                self._fhs[group] = handles
        return self._fhs

    def complete_chunk(self, p, ci, fhs, num_read, counts):
        """Record chunk completion: flush every output, capture its byte
        offset, and atomically replace the manifest. Runs on the writer
        thread, strictly after the chunk's writes (see _Writer.call)."""
        offsets = {}
        groups = output_groups(p)
        for group, handles in fhs.items():
            for f, fh in zip(groups[group], handles):
                fh.flush()
                offsets[f] = fh.tell()
        _atomic_json_dump(
            self.manifest_path,
            {
                "config": self._config_key(p),
                "chunks_done": ci + 1,
                "records_done": num_read,
                "counts": counts,
                "offsets": offsets,
            },
        )
        self.chunks_done = ci + 1

    def close_handles(self):
        """Close the output handles WITHOUT touching the manifest (failed-
        run cleanup: the interrupted run stays resumable)."""
        if self._fhs is not None:
            for group in self._fhs.values():
                for fh in group:
                    try:
                        fh.close()
                    except Exception:  # pragma: no cover - disk errors
                        pass
            self._fhs = None

    def merge(self, p):
        """Epilogue: close the outputs and drop the manifest (nothing to
        concatenate in the offset design). Ensures outputs exist even for
        an empty input."""
        if self._fhs is None:
            self.open_chunk(p, 0)
        for group in self._fhs.values():
            for fh in group:
                fh.close()
        self._fhs = None
        if self.manifest_path and os.path.exists(self.manifest_path):
            os.remove(self.manifest_path)


class DistributedParts:
    """Write layout for the coordinated multi-host mode (--coordinator).

    Every host writes its owned logical chunks to per-chunk part files
    (`<output>.parts/chunk_NNNNNN[.gz]`) in the SAME shared .parts
    directories, so after all hosts pass the global barrier, host 0's
    merge concatenates ALL hosts' parts in chunk order -- the round-robin
    chunk assignment interleaves back into input order and the merged
    outputs are byte-identical to a single-host run of the same command.
    (Unlike single-host --resume, hosts cannot share one output file, so
    the parts layout is load-bearing here.) The reference has no
    multi-host counterpart; the hosts' counters are summed over the gloo
    group (parallel/sharded.py merge_counts).

    Restartability: every coordinated run ALWAYS records, in a
    per-host manifest (`<output[0]>.parts.hostNNN.progress.json`, atomic
    replace on the writer thread after the chunk's part files close), how
    many of its own chunks completed plus the cumulative record/class
    counts. When the group is relaunched with --resume after a host died
    (the survivors fail their --barrier-timeout watchdog, so the
    operational unit of restart is the whole group, same commands), each
    host skips its already-completed chunks -- parse-only, no device work,
    parts untouched on disk -- and only the dead host's unfinished chunk
    is reprocessed (its partial part files are truncated on open). The
    manifest is keyed to the full run configuration + weights digest like
    single-host --resume; a mismatch refuses loudly.
    """

    def __init__(self, p):
        self.host_id = int(getattr(p, "host_id", 0) or 0)
        self.hosts = max(1, int(getattr(p, "hosts", 1) or 1))
        self.manifest_path = "{}.parts.host{:03d}.progress.json".format(
            p.output[0], self.host_id
        )
        self.chunks_done = 0  # completed OWN chunks (FIFO => a prefix)
        self.records_done = 0
        self.counts = {}
        self._own_seen = 0
        self._last_ci = -1
        self._part_sizes = {}  # part path -> bytes, for completed chunks
        self._open_handles = []  # every handle opened, for abort cleanup
        self._wd = None

    # -- config identity (same policy as ResumeState._config_key) -------

    def _config_key(self, p):
        key = ResumeState._config_key(self, p)
        key["pv"] = 1  # parts-manifest layout version
        key["hosts"] = p.hosts
        key["host_id"] = self.host_id
        return key

    _weights_digest = ResumeState._weights_digest

    # -- lifecycle -------------------------------------------------------

    def restore(self, p):
        """Load this host's manifest (--resume relaunch) and VERIFY every
        completed chunk's part files still exist at their recorded sizes
        (an intervening non-resume relaunch truncates parts on open, so a
        stale manifest without this check would silently merge a partial
        part). Returns (records_done, counts) to seed the run."""
        counts = {"norrna": 0, "rrna": 0, "unclf": 0}
        m = _load_manifest(self.manifest_path, self._config_key(p))
        if m is not None:
            self._part_sizes = dict(m.get("parts", {}))
            for path, size in self._part_sizes.items():
                try:
                    got = os.path.getsize(path)
                except OSError:
                    got = -1
                if got != int(size):
                    raise RuntimeError(
                        "--resume: part file {} is {} bytes but the "
                        "manifest recorded {} -- it was truncated or "
                        "removed since the run it belongs to (e.g. by a "
                        "relaunch WITHOUT --resume). Remove the manifest "
                        "and the .parts directories to start "
                        "fresh.".format(path, got, size)
                    )
            self.chunks_done = int(m["chunks_done"])
            self.records_done = int(m["records_done"])
            counts.update(m["counts"])
            p.logger.info(
                "Coordinated resume: skipping {} completed chunks "
                "({} records) on host {}".format(
                    self.chunks_done, self.records_done, self.host_id
                )
            )
        return self.records_done, counts

    def skip_chunk(self, ci):
        """True when this own chunk already completed in an earlier run
        (completion is FIFO, so the first chunks_done own chunks are
        exactly the completed set). Call once per OWN chunk, in order --
        both halves of that contract are checked and raise (also under
        python -O), so a future reordering of run_bucketed's early-continue
        paths fails loudly instead of silently skipping the wrong chunks."""
        if not host_chunk_assignment(ci, self.hosts, self.host_id):
            raise RuntimeError(
                f"skip_chunk called for chunk {ci} not owned by host "
                f"{self.host_id}/{self.hosts}"
            )
        if ci <= self._last_ci:
            raise RuntimeError(
                f"skip_chunk out of order: chunk {ci} after {self._last_ci}"
            )
        self._last_ci = ci
        self._own_seen += 1
        return self._own_seen <= self.chunks_done

    def complete_chunk(self, p, ci, num_read, counts):
        """Record own-chunk completion. Runs on the writer thread strictly
        after the chunk's part files were closed (ordered close_fh), so a
        manifest entry always refers to fully-written parts -- whose byte
        sizes are recorded for the restore-time integrity check."""
        for files in output_groups(p).values():
            for f in files:
                path = self._part_path(f, ci)
                try:
                    self._part_sizes[path] = os.path.getsize(path)
                except OSError:  # pragma: no cover - shared-fs races
                    self._part_sizes[path] = 0
        self.chunks_done += 1
        _atomic_json_dump(
            self.manifest_path,
            {
                "config": self._config_key(p),
                "chunks_done": self.chunks_done,
                "last_chunk": ci,
                "records_done": num_read,
                "counts": counts,
                "parts": self._part_sizes,
            },
        )

    @staticmethod
    def _part_path(final_path, ci):
        suffix = ".gz" if final_path.endswith("gz") else ""
        return os.path.join(final_path + ".parts", f"chunk_{ci:06d}{suffix}")

    def open_chunk(self, p, ci):
        from ribodetector_tpu_torch.io.writer import open_for_write_bytes

        fhs = {}
        for group, files in output_groups(p).items():
            handles = []
            for f in files:
                os.makedirs(f + ".parts", exist_ok=True)
                fh = open_for_write_bytes(
                    self._part_path(f, ci),
                    gz_level=getattr(p, "gz_level", None),
                )
                self._open_handles.append(fh)
                handles.append(fh)
            fhs[group] = handles
        return fhs

    def close_handles(self):
        """Failed-run cleanup: close every part handle this instance ever
        opened (close is idempotent, so handles the writer thread already
        closed are harmless). Completed parts and the manifest stay on
        disk -- the run remains relaunchable with --resume."""
        for fh in self._open_handles:
            try:
                fh.close()
            except Exception:  # pragma: no cover - disk errors
                pass
        self._open_handles = []

    def merge(self, p):
        """Concatenate all hosts' part files into the final outputs (chunk
        order) and clean up, including every host's completion manifest."""
        import glob
        import shutil

        def chunk_index(name):
            # numeric, NOT lexicographic: past chunk 999999 the %06d name
            # grows a digit and string order would interleave wrongly
            return int(name.split("_", 1)[1].split(".", 1)[0])

        for files in output_groups(p).values():
            for f in files:
                parts_dir = f + ".parts"
                if os.path.isdir(parts_dir):
                    with open(f, "wb") as out:
                        for name in sorted(os.listdir(parts_dir), key=chunk_index):
                            with open(os.path.join(parts_dir, name), "rb") as part:
                                shutil.copyfileobj(part, out, 8 << 20)
                    shutil.rmtree(parts_dir)
                elif not os.path.exists(f):
                    # empty run: the output must still exist -- but NEVER
                    # truncate a pre-existing file that has no parts to
                    # rebuild it from (defense against misconfigured
                    # calls). A gz output needs one empty member: a
                    # zero-byte .gz is not a valid gzip stream.
                    with open(f, "wb") as out:
                        if f.endswith("gz"):
                            out.write(compress_member(b""))
        # every host is past the pre-merge barrier (manifests final): the
        # run succeeded, so completion state must not leak. glob.escape:
        # an output path containing [, ? or * must not be treated as a
        # pattern (a missed match here would leak a stale manifest that a
        # later --resume run could restore from)
        for m in glob.glob(glob.escape(p.output[0]) + ".parts.host*.progress.json"):
            try:
                os.remove(m)
            except OSError:  # pragma: no cover - shared-fs races
                pass

