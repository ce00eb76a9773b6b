"""The inference engine: the Predictor around the classify step.

Counterpart of ``ribodetector_tpu/runtime/pipeline.py``. Orchestration
parity with the reference:

- file-count validation and error messages (detect.py:536-553)
- weight selection: "recall" iff ensure == "norrna", else "mcc"
  (quirk #6, detect.py:64-71)
- batch size formula (quirk #9, detect.py:555-570)
- ensure-mode reconciliation + output bucketing (runtime/ensure.py)
- whole-file mode (`run`) and bounded-memory chunked mode (`run_with_chunks`,
  chunk = batch_size * chunk_size reads, detect.py:371)
- per-batch '\n'.join writes, gzip level 5 (quirks #7, #11)
- run-summary log messages (detect.py:210-247)

The run itself is the native streaming runner
(runtime/native_pipeline.py), or the portable runner below (`run`,
`run_with_chunks`: Python parsing and encoding, one [rows, len] token batch
per device call) when the config sets runtime.native=false. The classify
step runs on the card through the hand-written CUDA kernels
(ops/lstm_cuda.py), or on the CPU through the plain recurrence when the
caller asks for the CPU (cli.main_cpu). Paths of the JAX package that this
package does not carry yet refuse with an explicit "not yet ported" error
instead of being ignored.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ribodetector_tpu_torch.config import PACKAGE_DIR, colors
from ribodetector_tpu_torch.encode import PAD_TOKEN, encode_batch
from ribodetector_tpu_torch.io import (
    get_pairedread_chunks,
    get_seq_chunks,
    load_reads,
    open_for_write,
)
from ribodetector_tpu_torch.runtime.batching import auto_batch_size
from ribodetector_tpu_torch.runtime.ensure import separate_paired_reads, separate_reads

try:
    from tqdm import tqdm
except ImportError:  # pragma: no cover
    def tqdm(it, **kw):
        return it

COMPUTE_DTYPES = ("float32", "bfloat16")

NOT_PORTED = "not yet ported in ribodetector_tpu_torch"


def resolve_state_path(path):
    """Weight-file path resolution: relative paths live under the package
    dir."""
    if path and not os.path.isabs(path):
        path = os.path.join(PACKAGE_DIR, path)
    return os.path.normpath(path) if path else path


def refuse_unported(config, args):
    """Raise for every flag or config key whose path this package does not
    carry, before any work starts (never silently ignore one)."""
    checks = [
        (getattr(args, "resume", False), "--resume"),
        (int(getattr(args, "hosts", 1) or 1) > 1, "--hosts > 1"),
        (getattr(args, "coordinator", None) is not None, "--coordinator"),
    ]
    for bad, what in checks:
        if bad:
            raise NotImplementedError(f"{what} is {NOT_PORTED}")


class Predictor:
    """End-to-end rRNA detection over FASTQ/FASTA files.

    device: "cuda" (the default; the run fails when no card is visible) or
    "cpu" (the plain recurrence, cli.main_cpu)."""

    def __init__(self, config, args, device="cuda"):
        self.config = config
        self.args = args
        self.device_type = device
        self.logger = config.get_logger("predict", 1, getattr(args, "log", None))
        self.chunk_size = getattr(args, "chunk_size", None)
        refuse_unported(config, args)
        # classify-step memo (keyed by shape/emit/pad_gap/fmt): one
        # Predictor can serve many detect() runs without rebuilding steps;
        # the lock serializes memo misses
        import threading

        self._infer_cache = {}
        self._infer_lock = threading.Lock()
        from ribodetector_tpu_torch.runtime.profiling import StageTimer

        self.timer = StageTimer(enabled=bool(getattr(args, "profile", False)))

    # ------------------------------------------------------------- model

    def get_state_file(self):
        self.len = self.args.len
        if self.len < 40:
            # accuracy warning only, never an error (quirk #12, detect.py:54-62)
            self.logger.info("The accuracy will drop with reads shorter than 40.")
        model_file_ext = "recall" if self.args.ensure == "norrna" else "mcc"
        self.state_file = resolve_state_path(
            self.config["state_file"][model_file_ext]
        )
        self.logger.info("Using high {} model".format(model_file_ext.upper()))
        self.logger.info("Log file: {}".format(getattr(self.args, "log", None)))

    def _select_device(self):
        """The torch device of this run, with -d/--deviceid parity
        (reference detect.py:90-91): on the card -d N selects cuda:N and is
        checked to have taken effect; on the CPU it has no effect."""
        import torch

        deviceid = getattr(self.args, "deviceid", None)
        ids = None
        if deviceid is not None:
            ids = [d for d in str(deviceid).split(",") if d != ""]
            if not ids:
                raise RuntimeError(f"--deviceid {deviceid!r} names no devices")
        if self.device_type == "cpu":
            if ids is not None:
                self.logger.warning("--deviceid has no effect on the cpu backend")
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible: ribodetector_tpu_torch runs its "
                "classify step on the card (use main_cpu / "
                "ribodetector_tpu_torch_cpu to run on the CPU)"
            )
        if ids is not None and len(ids) > 1:
            raise NotImplementedError(f"--deviceid with several GPUs is {NOT_PORTED}")
        try:
            index = int(ids[0]) if ids else torch.cuda.current_device()
        except ValueError:
            raise RuntimeError(f"--deviceid {deviceid!r} is not a CUDA device index")
        n_dev = torch.cuda.device_count()
        if not 0 <= index < n_dev:
            raise RuntimeError(
                f"--deviceid {deviceid} did not take effect: {n_dev} CUDA "
                f"device(s) visible"
            )
        device = torch.device("cuda", index)
        torch.cuda.set_device(device)
        if torch.empty(0, device=device).device != device:
            raise RuntimeError(f"--deviceid {deviceid} did not take effect")
        return device

    def load_model(self):
        """Select the device, load weights, run the startup parity probe and
        build the portable runner's classify step."""
        import torch

        from ribodetector_tpu_torch.models import load_params
        from ribodetector_tpu_torch.ops.dispatch import (
            PRECISIONS,
            kernel_mode,
            resolve_kernel,
        )

        self.get_state_file()
        self.device = self._select_device()
        self.params = load_params(self.state_file, self.device)
        runtime_cfg = self.config.get("runtime", {})
        self.semantics = getattr(self.args, "semantics", None) or runtime_cfg.get(
            "semantics", "dense"
        )
        self.compute_dtype = runtime_cfg.get("compute_dtype", "float32")
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(
                f"runtime.compute_dtype must be one of {COMPUTE_DTYPES}, got "
                f"{self.compute_dtype!r}"
            )
        self.kernel = resolve_kernel(runtime_cfg.get("kernel", "auto"), self.device)
        # precision of the CUDA kernels: "exact" = fp32 recurrence, "high" =
        # 2-limb bf16 split accumulated in fp32 (the default, gated by the
        # startup parity probe), "fast" = one bf16 pass; bf16 compute runs
        # the one-pass kernel with bf16 state (ops/dispatch.kernel_mode)
        self.precision_mode = getattr(self.args, "precision", None) or runtime_cfg.get(
            "precision", "high"
        )
        if self.precision_mode not in PRECISIONS:
            raise ValueError(f"unknown precision mode: {self.precision_mode}")
        if self.kernel == "cuda":  # refuse exact under bf16 before any work
            kernel_mode(self.precision_mode, getattr(torch, self.compute_dtype))
        hidden = self.params.w_hh_f.shape[0]
        if self.kernel == "cuda" and hidden != 128:
            raise NotImplementedError(
                f"a checkpoint of hidden width {hidden} on the card is "
                f"{NOT_PORTED} (the CUDA kernels take hidden 128)"
            )
        self._maybe_parity_probe()
        self.logger.info(
            "Model using {} ({} device{}) for read length {}{}{}{} loaded".format(
                self.device.type,
                1,
                "",
                colors.BOLD,
                colors.OKCYAN,
                self.len,
                colors.ENDC,
            )
        )
        self._infer = self._build_infer()

    def _probe_marker(self):
        """Pass-marker path: the verdict is a property of (torch version,
        package version, card, len, semantics, WEIGHTS), so repeat runs of
        the same combination skip the probe."""
        import hashlib

        import torch

        from ribodetector_tpu_torch import __version__
        from ribodetector_tpu_torch.config import cache_dir

        h = hashlib.sha1()
        with open(self.state_file, "rb") as fh:
            h.update(fh.read())
        h.update(
            "|".join(
                [
                    torch.__version__,
                    __version__,
                    torch.cuda.get_device_name(self.device),
                    str(self.len),
                    self.semantics,
                ]
            ).encode()
        )
        return os.path.join(cache_dir(), f"parity_ok_{h.hexdigest()[:16]}")

    def _maybe_parity_probe(self):
        """Startup argmax-parity gate for the default 'high' precision mode.

        One [16384, len] random batch (random tokens put far more mass near
        the decision boundary than real reads) runs through both kernels:
        the exact kernel is the reference arm, high the arm under test. Any
        flip on a read with reference margin >= 5e-3, or more than
        max(2, 1e-4 B) flips in total, falls back to the 'exact' mode. A
        pass is cached as a marker file; opt out with
        runtime.parity_probe=false in the config."""
        if (
            self.kernel != "cuda"
            or self.precision_mode != "high"
            or self.compute_dtype != "float32"
            or self.config.get("runtime", {}).get("parity_probe", True) is False
        ):
            return
        import torch

        from ribodetector_tpu_torch.ops.lstm_cuda import bilstm_logits_cuda

        marker = self._probe_marker()
        if os.path.exists(marker):
            return
        B = 16384
        rng = np.random.default_rng(0)
        tokens = torch.from_numpy(
            rng.integers(0, 5, (B, self.len)).astype(np.uint8)
        ).to(self.device)
        lengths = torch.full((B,), self.len, dtype=torch.int32, device=self.device)
        sem = self.semantics
        with torch.no_grad():
            ref = bilstm_logits_cuda(self.params, tokens, lengths, semantics=sem,
                                     mode="exact").cpu().numpy()
            got = bilstm_logits_cuda(self.params, tokens, lengths, semantics=sem,
                                     mode="high").cpu().numpy()
        flipped = got.argmax(1) != ref.argmax(1)
        margin = np.abs(ref[:, 1] - ref[:, 0])
        if flipped[margin >= 5e-3].any() or flipped.sum() > max(2, 1e-4 * B):
            self.precision_mode = "exact"
            self.logger.warning(
                "CUDA 'high' precision failed the startup argmax-parity "
                "probe on this card (%d/%d flips); falling back to the "
                "'exact' mode.",
                int(flipped.sum()),
                B,
            )
            return
        try:
            os.makedirs(os.path.dirname(marker), exist_ok=True)
            with open(marker, "w") as fh:
                fh.write("pass\n")
        except OSError as e:  # the marker only saves a later probe
            self.logger.warning("could not write the parity marker: %s", e)

    def _build_infer(self, packed_max_len=None, emit="logits", pad_gap=0,
                     fmt="b5"):
        """Classify step (eager torch on the run's device).

        packed_max_len=None: infer(tokens [B,T] uint8, lengths) -- the
        portable runner. packed_max_len=T: infer(ptokens [B,(T+2)//3] uint8
        base-5 packed, lengths) -- unpacked on the device
        (ops.dispatch.unpack_b5_tokens); lengths is ignored for dense
        semantics.

        fmt: packed-row format -- "b5" (base-5,
        any token) or "b2" (2-bit, clean ACGTU-only full-length reads;
        ops.dispatch.unpack_b2_tokens). Tokens after unpack are identical,
        so logits/labels are bit-identical between formats.

        emit: "logits" -> [B, 2] fp32; "labels" -> [B] int8 per-read argmax;
        ("pair_labels", ensure) -> [B//2] int8 final pair labels with R1 in
        rows [0, B//2) and R2 in rows [B//2, B) -- ensure-mode
        reconciliation runs on the device (runtime/ensure.py
        paired_final_labels_torch) and the device->host result shrinks 32x.

        pad_gap: length-bucketed batching (runtime/buckets.py). The step
        runs the recurrence over only packed_max_len steps but reproduces
        the full [B, len] dense semantics by starting the backward carry at
        zero_prefix_state(params, pad_gap).

        Memoized per (packed_max_len, emit, pad_gap, fmt).
        """
        memo_key = (packed_max_len, emit, pad_gap, fmt)
        cached = self._infer_cache.get(memo_key)
        if cached is not None:
            return cached
        with self._infer_lock:
            cached = self._infer_cache.get(memo_key)
            if cached is not None:
                return cached
            infer = self._build_infer_locked(memo_key)
            self._infer_cache[memo_key] = infer
            return infer

    def _build_infer_locked(self, memo_key):
        packed_max_len, emit, pad_gap, fmt = memo_key
        import torch

        from ribodetector_tpu_torch.models.bilstm import zero_prefix_state
        from ribodetector_tpu_torch.ops import classify_logits
        from ribodetector_tpu_torch.ops.dispatch import (
            unpack_b2_tokens,
            unpack_b5_tokens,
        )
        from ribodetector_tpu_torch.runtime.ensure import paired_final_labels_torch

        unpack = unpack_b2_tokens if fmt == "b2" else unpack_b5_tokens
        params = self.params
        semantics = self.semantics
        kernel = self.kernel
        mode = self.precision_mode
        compute_dtype = getattr(torch, self.compute_dtype)

        if emit == "logits":
            post = lambda logits: logits
        elif emit == "labels":
            post = lambda logits: torch.argmax(logits, dim=1).to(torch.int8)
        elif isinstance(emit, tuple) and emit[0] == "pair_labels":
            ensure = emit[1]

            def post(logits):
                half = logits.shape[0] // 2
                return paired_final_labels_torch(logits[:half], logits[half:], ensure)
        else:
            raise ValueError(f"unknown emit: {emit}")

        bwd_init = None
        if pad_gap and semantics == "dense":
            with torch.no_grad():
                bwd_init = zero_prefix_state(params, pad_gap,
                                             compute_dtype=compute_dtype)

        def classify(tokens, lengths):
            with torch.no_grad():
                return post(
                    classify_logits(
                        params,
                        tokens,
                        lengths,
                        semantics=semantics,
                        kernel=kernel,
                        mode=mode,
                        compute_dtype=compute_dtype,
                        bwd_init=bwd_init,
                    )
                )

        if packed_max_len is None:
            return classify
        max_len = packed_max_len
        if semantics == "packed":
            return lambda ptokens, lengths: classify(unpack(ptokens, max_len), lengths)
        return lambda ptokens, lengths=None: classify(unpack(ptokens, max_len), None)

    # ------------------------------------------------------------ encode

    def _encode_padded(self, seqs, rows):
        """Encode to a fixed [rows, len] token matrix (pad rows with PAD_TOKEN)."""
        tokens = np.full((rows, self.len), PAD_TOKEN, dtype=np.uint8)
        _, lengths_n = encode_batch(seqs, self.len, out_tokens=tokens)
        lengths = np.zeros(rows, dtype=np.int32)
        lengths[: len(seqs)] = lengths_n
        return tokens, lengths

    def _classify(self, seqs, rows):
        """Launch one classify step; returns the [rows, 2] logits as a tensor
        on the run's device (the card computes while the host goes on)."""
        import torch

        tokens, lengths = self._encode_padded(seqs, rows)
        return self._infer(torch.from_numpy(tokens).to(self.device),
                           torch.from_numpy(lengths).to(self.device))

    # ------------------------------------------------------------- runs

    def detect(self):
        self.input = self.args.input
        self.output = self.args.output
        self.rrna = self.args.rrna

        num_inputs = len(self.input)
        num_rrna_outputs = None if self.rrna is None else len(self.rrna)
        num_norrna_outputs = len(self.output)
        if num_inputs != num_norrna_outputs or num_inputs > 2:
            self.logger.error(
                "{}The number of input and output sequence files is invalid!{}".format(
                    colors.FAIL, colors.ENDC
                )
            )
            raise RuntimeError(
                "Input or output should have no more than two files and they should have the same number of files."
            )
        if num_rrna_outputs is not None and num_rrna_outputs != num_inputs:
            self.logger.error(
                "{}The number of output rRNA sequence files is invalid!{}".format(
                    colors.FAIL, colors.ENDC
                )
            )
            raise RuntimeError(
                "Ouput rRNA should have no more than two files and they should the same number with input files."
            )
        if self.chunk_size is not None and int(self.chunk_size) < 1:
            raise RuntimeError(
                f"--chunk_size must be >= 1, got {self.chunk_size} "
                "(0 would silently process nothing)"
            )

        self.is_paired = num_inputs == 2
        # native gz output compression level (libdeflate; default 3 =
        # reference zlib-5 ratio parity; 1 = fastest deflate)
        self.gz_level = getattr(self.args, "gz_level", None) or self.config.get(
            "runtime", {}
        ).get("gz_level", None)
        if self.gz_level is not None:
            # config-sourced values bypass the CLI's choices check, and an
            # out-of-range level makes libdeflate_alloc_compressor return
            # NULL (a crash in the parallel-compress path) -- validate here
            self.gz_level = int(self.gz_level)
            if not 1 <= self.gz_level <= 12:
                raise RuntimeError(
                    f"gz_level must be in [1, 12], got {self.gz_level}"
                )
        self.batch_size = auto_batch_size(self.args.memory, self.len, self.is_paired)
        self.logger.info(
            "Choose batch size: {}{}{}{} based on the given RAM size {}GB and max read length {}".format(
                colors.BOLD,
                colors.OKCYAN,
                self.batch_size,
                colors.ENDC,
                self.args.memory,
                self.len,
            )
        )

        from ribodetector_tpu_torch.runtime.profiling import maybe_trace

        with maybe_trace(getattr(self.args, "trace_dir", None), self.device.type):
            if self._use_native():
                from ribodetector_tpu_torch.runtime.native_pipeline import NativeRunner

                NativeRunner(self).run()
            elif self.chunk_size is None:
                self.run()
            else:
                self.run_with_chunks()
        if self.timer.enabled:
            self.logger.info(self.timer.summary())

    def _use_native(self):
        """The native streaming runner unless the config sets
        runtime.native=false (the portable runner). A native parser that
        cannot be built raises; it never selects the portable runner."""
        return self.config.get("runtime", {}).get("native", True) is not False

    def _log_progress(self, num_read, rate=None):
        self.logger.info(
            "{}{}{} sequences finished!{}".format(
                colors.OKGREEN,
                num_read,
                colors.ENDC,
                "" if rate is None else " ({:,.0f} reads/s)".format(rate),
            )
        )

    # -- output file management

    def _open_outputs(self, binary=False):
        """Output handles: binary for the native byte-gather writers, text
        for the portable runner."""
        from ribodetector_tpu_torch.io.writer import open_for_write_bytes

        if binary:
            gz_level = self.gz_level

            def opener(f):
                return open_for_write_bytes(f, gz_level=gz_level)

        else:
            opener = open_for_write

        fhs = {}
        if self.rrna is not None:
            self.logger.info(
                "Writing output rRNA sequences into file: {}{}{}".format(
                    colors.OKBLUE, ", ".join(self.rrna), colors.ENDC
                )
            )
            fhs["rrna"] = [opener(f) for f in self.rrna]
        self.logger.info(
            "Writing output non-rRNA sequences into file: {}{}{}".format(
                colors.OKBLUE, ", ".join(self.output), colors.ENDC
            )
        )
        fhs["norrna"] = [opener(f) for f in self.output]
        if self.is_paired and self.args.ensure == "both":
            # discordant pairs always land in gzipped .unclassified files
            # (quirk #5, detect.py:161-171)
            unclf = [f + ".unclassified.gz" for f in self.output]
            fhs["unclf"] = [opener(f) for f in unclf]
            self.logger.info(
                "Writing unclassified sequences into file: {}{}{}".format(
                    colors.OKYELLOW, ", ".join(unclf), colors.ENDC
                )
            )
        return fhs

    @staticmethod
    def _close_outputs(fhs):
        """Close every handle even when one close raises (ENOSPC flushing a
        gz trailer must not leak the remaining handles); the first error
        propagates after all closes were attempted."""
        first = None
        for group in fhs.values():
            for fh in group:
                try:
                    fh.close()
                except BaseException as e:
                    if first is None:
                        first = e
        if first is not None:
            raise first

    @staticmethod
    def _write_bucket(fh, bucket):
        if bucket:
            fh.write("\n".join(bucket) + "\n")

    def _emit_paired(self, fhs, r1_dict, r2_dict, counts):
        counts["norrna"] += len(r1_dict.get(0, ()))
        counts["rrna"] += len(r1_dict.get(1, ()))
        self._write_bucket(fhs["norrna"][0], r1_dict.get(0, ()))
        self._write_bucket(fhs["norrna"][1], r2_dict.get(0, ()))
        if "rrna" in fhs:
            self._write_bucket(fhs["rrna"][0], r1_dict.get(1, ()))
            self._write_bucket(fhs["rrna"][1], r2_dict.get(1, ()))
        if "unclf" in fhs:
            counts["unclf"] += len(r1_dict.get(-1, ()))
            self._write_bucket(fhs["unclf"][0], r1_dict.get(-1, ()))
            self._write_bucket(fhs["unclf"][1], r2_dict.get(-1, ()))

    def _emit_single(self, fhs, buckets, counts):
        counts["norrna"] += len(buckets.get(0, ()))
        counts["rrna"] += len(buckets.get(1, ()))
        self._write_bucket(fhs["norrna"][0], buckets.get(0, ()))
        if "rrna" in fhs:
            self._write_bucket(fhs["rrna"][0], buckets.get(1, ()))

    def _log_summary(self, num_seqs, counts):
        # the run's result, read by serve's run_job
        self._final = (num_seqs, dict(counts))
        self.logger.info(
            "Processed {}{}{}{} sequences in total".format(
                colors.BOLD, colors.OKCYAN, num_seqs, colors.ENDC
            )
        )
        self.logger.info(
            "Detected {}{}{}{} non-rRNA sequences".format(
                colors.BOLD, colors.OKCYAN, counts["norrna"], colors.ENDC
            )
        )
        self.logger.info(
            "Detected {}{}{}{} rRNA sequences".format(
                colors.BOLD, colors.OKCYAN, counts["rrna"], colors.ENDC
            )
        )
        if "unclf" in counts and self.is_paired and self.args.ensure == "both":
            self.logger.info(
                "Discarded {}{}{}{} unclassified sequences".format(
                    colors.BOLD, colors.OKCYAN, counts["unclf"], colors.ENDC
                )
            )

    # -- the portable runner: batch iteration with a one-deep async pipeline

    def _paired_batches(self, r1_reads, r2_reads):
        """Classify paired reads with one fused [2B, T] device call per batch.

        Yields (r1_records, r2_records, r1_logits, r2_logits) per batch; the
        device step of batch i runs while the host encodes batch i+1 and
        writes batch i-1.
        """
        bs = self.batch_size
        n = len(r1_reads)
        pending = None
        for start in range(0, n, bs):
            r1_b = r1_reads[start : start + bs]
            r2_b = r2_reads[start : start + bs]
            nb = len(r1_b)
            seqs = [r[1] for r in r1_b] + [r[1] for r in r2_b]
            logits_dev = self._classify(seqs, 2 * bs)
            if pending is not None:
                yield self._finalize_paired(*pending)
            pending = (r1_b, r2_b, logits_dev, nb)
        if pending is not None:
            yield self._finalize_paired(*pending)

    def _finalize_paired(self, r1_b, r2_b, logits_dev, nb):
        # the encoder packs R1 rows at [0, nb) and R2 rows at [nb, 2nb)
        # (remaining rows up to 2*batch_size are padding)
        logits = logits_dev.cpu().numpy()
        return r1_b, r2_b, logits[:nb], logits[nb : 2 * nb]

    def _single_batches(self, reads):
        bs = self.batch_size
        pending = None
        for start in range(0, len(reads), bs):
            batch = reads[start : start + bs]
            logits_dev = self._classify([r[1] for r in batch], bs)
            if pending is not None:
                yield self._finalize_single(*pending)
            pending = (batch, logits_dev)
        if pending is not None:
            yield self._finalize_single(*pending)

    @staticmethod
    def _finalize_single(batch, logits_dev):
        return batch, logits_dev.cpu().numpy()[: len(batch)]

    # -- whole-file mode (detect.py:121-324)

    def run(self):
        counts = {"norrna": 0, "rrna": 0, "unclf": 0}
        if self.is_paired:
            # parse R1/R2 concurrently (reference uses Pool(2), detect.py:131-132)
            with ThreadPoolExecutor(2) as ex:
                r1_reads, r2_reads = ex.map(load_reads, self.input)
            num_seqs = min(len(r1_reads), len(r2_reads))
            r1_reads, r2_reads = r1_reads[:num_seqs], r2_reads[:num_seqs]
            self.logger.info(
                "{}{}{}{} sequences loaded!".format(
                    colors.BOLD, colors.OKCYAN, num_seqs, colors.ENDC
                )
            )
            fhs = self._open_outputs()
            try:
                num_batches = -(-num_seqs // self.batch_size) if num_seqs else 0
                for r1_b, r2_b, l1, l2 in tqdm(
                    self._paired_batches(r1_reads, r2_reads), total=num_batches
                ):
                    r1_dict, r2_dict = separate_paired_reads(
                        r1_b, l1, r2_b, l2, self.args.ensure
                    )
                    self._emit_paired(fhs, r1_dict, r2_dict, counts)
                self._log_summary(num_seqs, counts)
            finally:
                # always close (serve keeps the process alive across failed
                # jobs; leaked handles leave .gz without trailers)
                self._close_outputs(fhs)
        else:
            reads = load_reads(*self.input)
            num_seqs = len(reads)
            self.logger.info(
                "{}{}{}{} sequences loaded!".format(
                    colors.BOLD, colors.OKCYAN, num_seqs, colors.ENDC
                )
            )
            fhs = self._open_outputs()
            try:
                num_batches = -(-num_seqs // self.batch_size) if num_seqs else 0
                for batch, logits in tqdm(
                    self._single_batches(reads), total=num_batches
                ):
                    buckets = separate_reads(batch, logits.argmax(1))
                    self._emit_single(fhs, buckets, counts)
                self._log_summary(num_seqs, counts)
            finally:
                self._close_outputs(fhs)

    # -- chunked low-memory mode (detect.py:326-523)

    def run_with_chunks(self):
        counts = {"norrna": 0, "rrna": 0, "unclf": 0}
        num_read = 0
        fhs = None
        chunk_reads = self.batch_size * self.chunk_size
        try:
            if self.is_paired:
                for r1_chunk, r2_chunk in get_pairedread_chunks(
                    *self.input, chunk_size=chunk_reads
                ):
                    if fhs is None:
                        fhs = self._open_outputs()
                    n = min(len(r1_chunk), len(r2_chunk))
                    num_read += n
                    for r1_b, r2_b, l1, l2 in self._paired_batches(
                        r1_chunk[:n], r2_chunk[:n]
                    ):
                        r1_dict, r2_dict = separate_paired_reads(
                            r1_b, l1, r2_b, l2, self.args.ensure
                        )
                        self._emit_paired(fhs, r1_dict, r2_dict, counts)
                    self._log_progress(num_read)
            else:
                for chunk in get_seq_chunks(*self.input, chunk_size=chunk_reads):
                    if fhs is None:
                        fhs = self._open_outputs()
                    num_read += len(chunk)
                    for batch, logits in self._single_batches(chunk):
                        buckets = separate_reads(batch, logits.argmax(1))
                        self._emit_single(fhs, buckets, counts)
                    self._log_progress(num_read)
            if fhs is None:
                fhs = self._open_outputs()
            self._log_summary(num_read, counts)
        finally:
            if fhs is not None:
                self._close_outputs(fhs)
