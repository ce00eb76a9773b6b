"""The inference engine: the Predictor around the classify step.

Counterpart of ``ribodetector_tpu/runtime/pipeline.py``. Orchestration
parity with the reference:

- file-count validation and error messages (detect.py:536-553)
- weight selection: "recall" iff ensure == "norrna", else "mcc"
  (quirk #6, detect.py:64-71)
- batch size formula (quirk #9, detect.py:555-570)
- ensure-mode reconciliation (runtime/ensure.py)
- whole-file mode and bounded-memory chunked mode (chunk = batch_size *
  chunk_size reads, detect.py:371)
- run-summary log messages (detect.py:210-247)

- restartable streaming (--resume), and multi-host runs (--hosts,
  --coordinator: per-host shards, or a gloo group whose host 0 merges the
  hosts' parts; _finalize_distributed)
- several cards on one host (-d a,b): parameters and classify steps per
  card, each device batch split into row slices, one per card

The run itself is the native streaming runner
(runtime/native_pipeline.py), the port's only runner. The classify step
runs on the card through the hand-written CUDA kernels (ops/lstm_cuda.py),
or on the CPU through the plain recurrence when the caller asks for the
CPU (cli.main_cpu).
"""

import os

import numpy as np

from ribodetector_tpu_torch.config import PACKAGE_DIR, colors
from ribodetector_tpu_torch.runtime.batching import auto_batch_size

COMPUTE_DTYPES = ("float32", "bfloat16")
# runtime keys of the JAX package that select or tune its runners; the port
# has one runner and refuses them rather than ignore them
RETIRED_RUNTIME_KEYS = ("native", "depth", "dispatchers", "b2")


def resolve_state_path(path):
    """Weight-file path resolution: relative paths live under the package
    dir."""
    if path and not os.path.isabs(path):
        path = os.path.join(PACKAGE_DIR, path)
    return os.path.normpath(path) if path else path


class Predictor:
    """End-to-end rRNA detection over FASTQ/FASTA files.

    device: "cuda" (the default; the run fails when no card is visible) or
    "cpu" (the plain recurrence, cli.main_cpu). replicas: on the CPU only,
    run the several-card split over this many CPU replicas of the model
    (tests hold the split against one replica with it; no CLI flag sets
    it)."""

    arch = "BiLSTMParams"  # the config's arch.type, set by load_model

    def __init__(self, config, args, device="cuda", replicas=1):
        self.config = config
        self.args = args
        self.device_type = device
        if replicas != 1 and device != "cpu":
            raise ValueError("replicas is a CPU-only test setting; cards are "
                             "chosen with -d a,b")
        self.replicas = int(replicas)
        self.logger = config.get_logger("predict", 1, getattr(args, "log", None))
        self.chunk_size = getattr(args, "chunk_size", None)
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

    def _select_devices(self):
        """The torch devices of this run, with -d/--deviceid parity
        (reference detect.py:90-91): on the card -d N selects cuda:N and
        -d a,b,... several cards, each checked to have taken effect; their
        count must be a power of two, as the JAX package's data mesh
        requires. Without -d the run keeps the current card (the JAX package
        instead shards over every visible chip: cards on a GPU host are
        often shared with other jobs). On the CPU -d has no effect."""
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
            return [torch.device("cpu")] * self.replicas
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible: ribodetector_tpu_torch runs its "
                "classify step on the card (use main_cpu / "
                "ribodetector_tpu_torch_cpu to run on the CPU)"
            )
        try:
            indices = [int(i) for i in ids] if ids else [torch.cuda.current_device()]
        except ValueError:
            raise RuntimeError(f"--deviceid {deviceid!r} is not a list of CUDA "
                               "device indices")
        n = len(indices)
        if len(set(indices)) != n:
            raise RuntimeError(f"--deviceid {deviceid} names a card twice")
        if n & (n - 1):
            raise RuntimeError(
                f"--deviceid {deviceid} names {n} cards: the count must be a "
                "power of two (each device batch splits into equal row slices)"
            )
        n_dev = torch.cuda.device_count()
        devices = []
        for index in indices:
            if not 0 <= index < n_dev:
                raise RuntimeError(
                    f"--deviceid {deviceid} did not take effect: {n_dev} CUDA "
                    f"device(s) visible"
                )
            device = torch.device("cuda", index)
            if torch.empty(0, device=device).device != device:
                raise RuntimeError(f"--deviceid {deviceid} did not take effect")
            devices.append(device)
        torch.cuda.set_device(devices[0])
        return devices

    def load_model(self):
        """Check the config's runtime section, select the device, load
        weights and run the startup parity probe."""
        import threading

        import torch

        from ribodetector_tpu_torch.models import check_arch, load_params
        from ribodetector_tpu_torch.ops.dispatch import (
            PRECISIONS,
            kernel_mode,
            resolve_kernel,
        )

        runtime_cfg = self.config.get("runtime", {})
        for key in RETIRED_RUNTIME_KEYS:
            if key in runtime_cfg:
                raise ValueError(
                    f"runtime.{key} is not a setting of ribodetector_tpu_torch: "
                    "the port has one runner, the native streaming runner, "
                    f"with fixed settings; remove runtime.{key} from the config"
                )
        self.get_state_file()
        # the config's arch.type selects the model; the npz must hold it
        self.arch = check_arch(self.config.get("arch", {}).get("type", "BiLSTMParams"))
        with self.timer.stage("load.devices"):
            self.devices = self._select_devices()
        self.device = self.devices[0]
        with self.timer.stage("load.weights"):
            # the weights on every card (554 KB each for the BiLSTM, 31 MB
            # for the Caduceus): each card's classify steps read their own
            # copy
            self._card_params = [load_params(self.state_file, d, arch=self.arch)
                                 for d in self.devices]
        self.params = self._card_params[0]
        # one Caduceus micro-batch's activations at a time on each card
        self._forward_locks = [threading.Lock() for _ in self.devices]
        if self.arch == "CaduceusParams":
            self._load_caduceus(runtime_cfg)
            return
        self.semantics = getattr(self.args, "semantics", None) or runtime_cfg.get(
            "semantics", "dense"
        )
        self.compute_dtype = runtime_cfg.get("compute_dtype", "float32")
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(
                f"runtime.compute_dtype must be one of {COMPUTE_DTYPES}, got "
                f"{self.compute_dtype!r}"
            )
        hidden = self.params.w_hh_f.shape[0]
        # a custom-width checkpoint runs the plain recurrence on the card
        # (auto), as the JAX package runs its scan where Pallas cannot
        self.kernel = resolve_kernel(runtime_cfg.get("kernel", "auto"),
                                     self.device, hidden)
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
        with self.timer.stage("load.probe"):
            self._maybe_parity_probe()
        n_dev = len(self.devices)
        self.logger.info(
            "Model using {} ({} device{}) for read length {}{}{}{} loaded{}".format(
                self.device.type,
                n_dev,
                "s" if n_dev != 1 else "",
                colors.BOLD,
                colors.OKCYAN,
                self.len,
                colors.ENDC,
                f" (kernel plain: hidden {hidden}, the CUDA kernels take 128)"
                if self.device.type == "cuda" and self.kernel == "plain" else "",
            )
        )

    def _load_caduceus(self, runtime_cfg):
        """The Caduceus's settings: packed semantics (each read over its own
        bases), the configuration's precision (compute_dtype bfloat16 on the
        card; float32 or bfloat16 on the CPU), its kernels on the card and
        the plain forward on the CPU. It has no precision modes and no
        parity probe: an explicit --precision other than the default, dense
        semantics, and widths that disagree with the config's arch.args are
        refused."""
        from ribodetector_tpu_torch.models.caduceus import dims

        have = dims(self.params)
        want = self.config.get("arch", {}).get("args", {})
        wrong = {k: (v, have[k]) for k, v in want.items() if k in have and v != have[k]}
        if wrong:
            raise ValueError(f"the config's arch.args disagree with {self.state_file} "
                             f"(config, weights): {wrong}")
        self.semantics = getattr(self.args, "semantics", None) or runtime_cfg.get(
            "semantics", "packed")
        if self.semantics != "packed":
            raise ValueError("a Caduceus runs packed semantics (each read over its "
                             f"own bases), not {self.semantics!r}")
        precision = getattr(self.args, "precision", None) or runtime_cfg.get("precision")
        if precision not in (None, "high"):
            raise ValueError(f"--precision {precision} applies to the BiLSTM's kernels; "
                             "a Caduceus computes in its configuration's precision")
        self.precision_mode = "caduceus"
        self.compute_dtype = runtime_cfg.get("compute_dtype", "float32")
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"runtime.compute_dtype must be one of {COMPUTE_DTYPES}, "
                             f"got {self.compute_dtype!r}")
        on_card = self.device.type == "cuda"
        kernel = runtime_cfg.get("kernel", "auto")
        if kernel not in ("auto", "cuda", "plain") or kernel == ("plain" if on_card else "cuda"):
            raise ValueError(f"kernel {kernel!r}: a Caduceus runs its kernels on the "
                             "card and the plain forward on the CPU")
        self.kernel = "cuda" if on_card else "plain"
        if on_card:
            from ribodetector_tpu_torch.ops.caduceus_cuda import check_widths

            check_widths(self.params)
            if self.compute_dtype != "bfloat16":
                raise ValueError("a Caduceus on the card computes in its configuration's "
                                 "precision: runtime.compute_dtype must be bfloat16")
        c = dims(self.params)
        self.logger.info(
            "Caduceus-Ph model (d_model {}, {} layers) using {} ({} device{}) for "
            "read length {}{}{}{} loaded".format(
                c["d_model"], c["n_layer"], self.device.type, len(self.devices),
                "s" if len(self.devices) != 1 else "", colors.BOLD, colors.OKCYAN,
                self.len, colors.ENDC))

    def _probe_marker(self):
        """Pass-marker path: the verdict is a property of (torch version,
        package version, card, len, semantics, WEIGHTS, the kernel
        library's build key), so repeat runs of the same combination skip
        the probe and an edited kernel source runs it again."""
        import hashlib

        import torch

        from ribodetector_tpu_torch import __version__
        from ribodetector_tpu_torch.config import cache_dir
        from ribodetector_tpu_torch.ops.build import kernel_library_key

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
                    kernel_library_key(),
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

    def _build_infers(self, packed_max_len=None, emit="logits", pad_gap=0,
                      fmt="b5"):
        """One classify step per card of the run (_build_infer), in the
        order of self.devices."""
        return tuple(self._build_infer(packed_max_len, emit, pad_gap, fmt, card)
                     for card in range(len(self.devices)))

    def _build_infer(self, packed_max_len=None, emit="logits", pad_gap=0,
                     fmt="b5", card=0):
        """Classify step (eager torch on card `card` of the run's devices,
        with that card's copy of the weights).

        packed_max_len=None: infer(tokens [B,T] uint8, lengths), over
        unpacked tokens. packed_max_len=T: infer(ptokens [B,(T+2)//3] uint8
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

        Memoized per (packed_max_len, emit, pad_gap, fmt, card).
        """
        memo_key = (packed_max_len, emit, pad_gap, fmt, card)
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
        packed_max_len, emit, pad_gap, fmt, card = memo_key
        import torch

        from ribodetector_tpu_torch.models.bilstm import zero_prefix_state
        from ribodetector_tpu_torch.ops import classify_logits
        from ribodetector_tpu_torch.ops.dispatch import (
            unpack_b2_tokens,
            unpack_b5_tokens,
        )
        from ribodetector_tpu_torch.runtime.ensure import paired_final_labels_torch

        unpack = unpack_b2_tokens if fmt == "b2" else unpack_b5_tokens
        params = self._card_params[card]
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

        if self.arch == "CaduceusParams":
            classify = self._caduceus_step(classify_logits, params, packed_max_len or self.len,
                                           card, post)

        if packed_max_len is None:
            return classify
        max_len = packed_max_len
        if semantics == "packed":
            return lambda ptokens, lengths: classify(unpack(ptokens, max_len), lengths)
        return lambda ptokens, lengths=None: classify(unpack(ptokens, max_len), None)

    def _caduceus_step(self, classify_logits, params, T, card, post):
        """The Caduceus's classify step over a device call of width T. The
        call's lengths come to the host once; the rows that hold a read (the
        rest, a flush batch's padding, get zero logits) are ordered longest
        first (a stable sort) and gathered on the card in that order, then
        cut by models.caduceus.micro_batches: each micro-batch runs at its
        longest read rounded up to WIDTH_STEP (at most T), holds at most
        micro_rows(params, W) reads (one micro-batch's activations, both
        strands, fit its 8 GiB at its own width) and only reads of that
        rounded width. Each is one classify_logits call on the first W
        columns under a "cad.forward" span; the card's lock holds while the
        micro-batches are launched, so that the dispatcher threads' calls
        never hold more than one micro-batch's activations on a card at
        once. The logits are put back in the call's row order before
        `post`. With the timer on it counts cad.micro_batches,
        cad.padded_tokens (rows x W x 2 strands, summed over the
        micro-batches: what the kernels compute) and cad.tokens (the reads'
        own bases, x 2 strands)."""
        import torch

        from ribodetector_tpu_torch.models.caduceus import micro_batches
        from ribodetector_tpu_torch.runtime.profiling import span

        lock = self._forward_locks[card]
        timer = self.timer
        kernel = self.kernel
        compute_dtype = getattr(torch, self.compute_dtype)
        classes = params.w_head.shape[1]

        def classify(tokens, lengths):
            B = tokens.shape[0]
            # one wait for this call's lengths, before the card's lock
            lens = lengths.cpu().long().clamp(0, T)
            lens, order = torch.sort(lens, descending=True, stable=True)
            n = int((lens > 0).sum())
            lens = lens[:n]
            cuts = micro_batches(params, lens, T)
            idx = order[:n].to(tokens.device)
            tokens, lengths = tokens.index_select(0, idx), lengths.index_select(0, idx)
            with torch.no_grad():
                with lock:
                    parts = []
                    for a, b, W in cuts:
                        with span("cad.forward"):
                            parts.append(classify_logits(
                                params, tokens[a:b, :W], lengths[a:b],
                                semantics="packed", kernel=kernel,
                                compute_dtype=compute_dtype))
                logits = torch.zeros((B, classes), dtype=torch.float32, device=tokens.device)
                if parts:
                    logits.index_copy_(0, idx, torch.cat(parts))
                out = post(logits)
            if timer.enabled:
                timer.count("cad.micro_batches", len(cuts))
                timer.count("cad.padded_tokens", sum(2 * (b - a) * W for a, b, W in cuts))
                timer.count("cad.tokens", 2 * int(lens.sum()))
            return out

        return classify

    # ------------------------------------------------------------- runs

    def detect(self):
        """Classify the input files into the outputs (the CLI's run). The
        stage "detect" holds the whole call; its self time is what no finer
        stage names. --profile logs the timer's summary after it."""
        with self.timer.stage("detect"):
            self._detect()
        if self.timer.enabled:
            self.logger.info(self.timer.summary())

    def _detect(self):
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

        # multi-host chunk sharding: each cooperating host takes its
        # round-robin share of the chunk stream and writes per-host output
        # shards. With --coordinator the hosts form one gloo process group
        # (cli.py): counts are summed over it and host 0 concatenates the
        # hosts' parts; without it the user concatenates <name>.host*.
        self.distributed = getattr(self.args, "coordinator", None) is not None
        self.hosts = max(1, int(getattr(self.args, "hosts", 1) or 1))
        self.host_id = int(getattr(self.args, "host_id", 0) or 0)
        if self.distributed and self.hosts < 2:
            # the CLI enforces --num-hosts >= 2; programmatic callers must
            # not reach _finalize_distributed with a single host (its merge
            # would rebuild outputs from nonexistent parts)
            raise RuntimeError("--coordinator requires hosts >= 2")
        if self.chunk_size is not None and int(self.chunk_size) < 1:
            raise RuntimeError(
                f"--chunk_size must be >= 1, got {self.chunk_size} "
                "(0 would silently process nothing)"
            )
        if self.hosts > 1:
            if not 0 <= self.host_id < self.hosts:
                raise RuntimeError(
                    f"--host-id {self.host_id} out of range [0, {self.hosts})"
                )
            if getattr(self.args, "resume", False) and not self.distributed:
                # uncoordinated shards have no completion manifest; the
                # coordinated parts mode records per-host progress and
                # supports group relaunch with --resume
                raise RuntimeError(
                    "--resume with --hosts requires the coordinated mode "
                    "(--coordinator): per-host completion manifests live "
                    "in the shared parts layout"
                )
            if self.distributed:
                self.logger.info(
                    "Coordinated host {}/{}: chunk parts on the shared "
                    "filesystem; host 0 merges the final outputs".format(
                        self.host_id, self.hosts
                    )
                )
            else:
                self.output = [self._host_shard_path(f) for f in self.output]
                if self.rrna is not None:
                    self.rrna = [self._host_shard_path(f) for f in self.rrna]
                self.logger.info(
                    "Host shard {}/{}: writing per-host outputs (concatenate "
                    "<name>.host* shards when all hosts finish)".format(
                        self.host_id, self.hosts
                    )
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

        from ribodetector_tpu_torch.runtime.native_pipeline import NativeRunner
        from ribodetector_tpu_torch.runtime.profiling import maybe_trace

        with maybe_trace(getattr(self.args, "trace_dir", None), self.device.type):
            NativeRunner(self).run()
        if self.distributed:
            self._finalize_distributed()

    def _host_shard_path(self, f):
        """Per-host output shard name. gz outputs keep their gz suffix so
        compression stays on and `cat name.host*.gz > name.gz` is a valid
        multi-member gzip file; plain shards concatenate the same way."""
        k = f"host{self.host_id:03d}"
        if f.endswith("gz"):
            return f[: -len("gz")] + k + ".gz"
        return f + "." + k

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

    def _open_outputs(self):
        """Output handles for the native runner's byte-gather writers."""
        from ribodetector_tpu_torch.io.writer import open_for_write_bytes

        def opener(f):
            return open_for_write_bytes(f, gz_level=self.gz_level)

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

    def _finalize_distributed(self):
        """Multi-host epilogue: sum the per-host summary counters over the
        gloo group, barrier so every host's chunk parts are closed and
        visible, then host 0 concatenates ALL hosts' parts in chunk order
        into the final outputs -- merged bytes identical to a single-host
        run.

        Failure semantics: the collectives block until EVERY host arrives,
        so a host that died mid-run would hang the survivors forever (or,
        where gloo sees the peer's socket close, fail with a transport
        error). Both BARRIERS therefore run under a watchdog
        (--barrier-timeout, default 1 h) and fail with one clear error;
        completed per-chunk parts stay on disk, so the group can be
        relaunched with --resume. Host 0's actual merge IO runs OUTSIDE the
        watchdog -- a legitimately slow merge on a big shared filesystem
        must never be aborted mid-copy (the other hosts wait for it at the
        final barrier, whose timeout message says so)."""
        import threading

        import torch.distributed as dist

        from ribodetector_tpu_torch.parallel.sharded import BarrierTimeout, merge_counts
        from ribodetector_tpu_torch.runtime.native_pipeline import DistributedParts

        timeout = getattr(self.args, "barrier_timeout", None)
        if timeout is None:
            timeout = 3600
        # (an explicit 0 means fail-fast: Thread.join(0) returns immediately)

        def bounded(fn, what):
            box = {}

            def run_body():
                try:
                    box["ret"] = fn()
                except BaseException as e:  # surfaced on the main thread
                    box["exc"] = e

            t = threading.Thread(target=run_body, daemon=True)
            t.start()
            t.join(timeout)
            if t.is_alive() or "exc" in box:
                # a dead peer shows as a timeout, or as a gloo transport
                # error once its sockets close: both get the same message
                how = (
                    "timed out after {}s".format(timeout)
                    if t.is_alive()
                    else "failed ({}: {})".format(
                        type(box["exc"]).__name__, box["exc"]
                    )
                )
                raise (BarrierTimeout if t.is_alive() else RuntimeError)(
                    "Coordinated run: {} {} -- {} (this host processed its "
                    "own chunks successfully; their part files remain in "
                    "the <output>.parts/ directories). Restart the failed "
                    "host's command to let the group complete, or raise "
                    "--barrier-timeout.".format(what[0], how, what[1])
                ) from box.get("exc")
            return box.get("ret")

        def pre_merge():
            num_read, counts = getattr(
                self, "_final", (0, {"norrna": 0, "rrna": 0, "unclf": 0})
            )
            merged = merge_counts({"num_read": num_read, **counts})
            dist.barrier()  # every host's parts are written
            return merged

        merged = bounded(
            pre_merge,
            ("end-of-run barrier", "a cooperating host likely died mid-run"),
        )
        if self.host_id == 0:
            # untimed: merge IO is legitimate work, not a liveness signal
            DistributedParts(self).merge(self)
            self.logger.info("Merged outputs from {} hosts:".format(self.hosts))
            self._log_summary(merged.pop("num_read"), merged)

        bounded(
            dist.barrier,  # no host may exit while host 0 still reads part files
            (
                "final merge barrier",
                "host 0's merge is still running or host 0 died -- check "
                "host 0's log; if its merge legitimately needs longer, "
                "raise --barrier-timeout on every host",
            ),
        )

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
