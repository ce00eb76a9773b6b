"""Server mode: amortize startup across many detection jobs.

Counterpart of ``ribodetector_tpu/serve.py``. Production farms classify
thousands of small FASTQ/FASTA files; the reference pays its full startup
(interpreter + torch import + model load) per file (reference:
ribodetector/detect.py:763-809 is a one-shot process; no server exists).
Here one long-lived process loads the model, builds the kernels and the
classify steps once (Predictor._build_infer memo), and then runs jobs as
they arrive:

  python -m ribodetector_tpu_torch.serve -l 100 < jobs.jsonl

Protocol: one JSON object per stdin line ->  one JSON response per stdout
line (logs go to stderr), in order:

  request : {"id": any, "input": [...], "output": [...],
             "rrna": [...] | null, "ensure": "none|rrna|norrna|both",
             "chunk_size": int | null}
  response: {"id": ..., "status": "ok", "num_read": N,
             "counts": {"norrna": N, "rrna": N, "unclf": N},
             "seconds": S}
          | {"id": ..., "status": "error", "error": "..."}

A malformed or failing job answers with status=error and the server keeps
serving (per-job errors never kill the process). EOF on stdin ends the
server. Read length, semantics/kernel/precision/buckets and host budgets
are fixed per server (they define the classify steps); ensure may vary
per job -- "norrna" jobs route to a second Predictor holding the "recall"
weights when the config maps that key to a different file (quirk #6;
the shipped config aliases both keys to one file, so the common case is a
single model instance).

``main`` runs on the card and fails when no CUDA device is visible;
``main_cpu`` pins the CPU (the plain recurrence).
"""

import argparse
import json
import sys
import time
from types import SimpleNamespace

from ribodetector_tpu_torch.runtime.ensure import ENSURE_MODES as _ENSURES


def build_arg_parser():
    # NOTE: the shared flags below mirror cli.build_arg_parser's choices
    # and defaults -- keep them in sync when a flag changes there
    ap = argparse.ArgumentParser(
        prog="python -m ribodetector_tpu_torch.serve",
        description="Long-lived rRNA detection server (JSONL on stdin/stdout)",
    )
    ap.add_argument("-c", "--config", default=None, type=str)
    ap.add_argument("-l", "--len", type=int, required=True,
                    help="read length every job is classified at (fixes the "
                    "classify steps' shapes)")
    ap.add_argument("-t", "--threads", default=10, type=int)
    ap.add_argument("-m", "--memory", default=32, type=int)
    ap.add_argument("--log", default=None, type=str)
    ap.add_argument("--semantics", default=None, choices=["dense", "packed"])
    ap.add_argument("--kernel", default=None, choices=["auto", "cuda", "plain"])
    ap.add_argument("--precision", default=None, choices=["exact", "high", "fast"])
    ap.add_argument("--buckets", default=None, type=str)
    ap.add_argument("--gz-level", default=None, type=int, choices=range(1, 13),
                    metavar="{1..12}")
    ap.add_argument("--concurrency", default=1, type=int,
                    help="jobs processed in parallel (default 1 = strictly "
                    "sequential). 2 overlaps job i+1's parse/prefetch with "
                    "job i's classify/write drain, lifting job-stream "
                    "throughput for many-small-files workloads; responses "
                    "still come back in request order, and per-job errors "
                    "stay isolated. Each in-flight job runs on a shallow "
                    "Predictor copy sharing the loaded weights and "
                    "classify steps. The -m RAM budget is divided by "
                    "the concurrency so N in-flight jobs together respect "
                    "it.")
    return ap


class Server:
    """Owns one Predictor per distinct weight file (ensure-keyed).

    device: "cuda" (main) or "cpu" (main_cpu), as for cli.Predictor."""

    def __init__(self, args, config, device="cuda"):
        self.args = args
        self.config = config
        self.device = device
        if getattr(args, "kernel", None) is not None:
            # Predictor reads the kernel from config runtime (cli.py does
            # this bridge too); do it here so DIRECT Server users get the
            # kernel they asked for, not silently the config default
            config.config.setdefault("runtime", {})["kernel"] = args.kernel
        import threading

        self._predictors = {}  # weight key ("mcc"/"recall") -> Predictor
        # --concurrency runs jobs on pool threads: constructing a (second)
        # Predictor must not race another job's lookup
        self._pred_lock = threading.Lock()

    def _job_args(self, req):
        ensure = req.get("ensure", "none")
        if ensure not in _ENSURES:
            raise ValueError(f"ensure must be one of {_ENSURES}, got {ensure!r}")
        inputs = req.get("input")
        outputs = req.get("output")
        rrna = req.get("rrna")
        for name, v in (("input", inputs), ("output", outputs), ("rrna", rrna)):
            if isinstance(v, (str, bytes)):
                raise ValueError(
                    f"'{name}' must be a LIST of paths, got a string "
                    f"(list(...) would explode it per character)"
                )
        if not inputs or not outputs:
            raise ValueError("request needs non-empty 'input' and 'output' lists")
        chunk_size = req.get("chunk_size")
        # pass 0 through so Predictor.detect's >= 1 guard rejects it
        # loudly instead of a falsy-coercion silently meaning whole-file
        chunk_size = None if chunk_size is None else int(chunk_size)
        # -m is the whole host's budget: N concurrent jobs each size their
        # batches/chunks from their share, so together they respect it
        conc = max(1, int(getattr(self.args, "concurrency", 1) or 1))
        return SimpleNamespace(
            len=self.args.len,
            input=list(inputs),
            output=list(outputs),
            rrna=list(rrna) if rrna else None,
            ensure=ensure,
            threads=self.args.threads,
            memory=max(3, self.args.memory // conc),
            chunk_size=chunk_size,
            log=self.args.log,
            profile=False,
            trace_dir=None,
            resume=False,
            semantics=self.args.semantics,
            kernel=self.args.kernel,
            precision=self.args.precision,
            buckets=self.args.buckets,
            gz_level=self.args.gz_level,
            hosts=1, host_id=0, coordinator=None, num_hosts=None,
            deviceid=None, config=self.args.config, barrier_timeout=None,
        )

    def _resolved_state(self, key):
        from ribodetector_tpu_torch.runtime.pipeline import resolve_state_path

        return resolve_state_path(self.config["state_file"].get(key))

    def _predictor_for(self, job_args):
        # quirk #6: -e norrna selects the "recall" weights key
        key = "recall" if job_args.ensure == "norrna" else "mcc"
        with self._pred_lock:
            return self._predictor_for_locked(job_args, key)

    def _predictor_for_locked(self, job_args, key):
        if key not in self._predictors:
            from ribodetector_tpu_torch.runtime import Predictor

            # alias detection on RESOLVED paths: the shipped config maps
            # both keys to one file -- share the Predictor (and its
            # classify steps) then
            other = "recall" if key == "mcc" else "mcc"
            if other in self._predictors and self._resolved_state(
                key
            ) == self._resolved_state(other):
                self._predictors[key] = self._predictors[other]
            else:
                ctor_args = self._job_args({"input": ["x"], "output": ["x"],
                                            "ensure": job_args.ensure})
                # (a second Predictor may reuse --log safely: get_logger
                # attaches at most one FileHandler per logfile path)
                p = Predictor(self.config, ctor_args, device=self.device)
                p.load_model()
                self._predictors[key] = p
        return self._predictors[key]

    def run_job(self, req):
        import copy

        job_args = self._job_args(req)
        p = self._predictor_for(job_args)
        # each job runs on a SHALLOW COPY of the long-lived Predictor:
        # per-job fields (args, input/output paths, batch size, counters)
        # live on the copy while the loaded params, classify-step memo (and
        # its lock) and logger are shared -- so --concurrency > 1 can
        # overlap jobs without cross-talk, and even sequential jobs can't
        # leak state into each other
        pj = copy.copy(p)
        pj.args = job_args
        pj.chunk_size = job_args.chunk_size
        t0 = time.time()
        pj.detect()
        num_read, counts = pj._final
        return {
            "status": "ok",
            "num_read": num_read,
            "counts": counts,
            "seconds": round(time.time() - t0, 3),
        }

    def serve(self, lines, out):
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        workers = max(1, int(getattr(self.args, "concurrency", 1) or 1))
        pending = deque()  # (rid, future) in request order

        def emit(rid, fut):
            try:
                resp = fut.result()
            except BaseException as e:  # noqa: BLE001 - per-job isolation
                if isinstance(e, (KeyboardInterrupt, SystemExit)):
                    raise
                resp = {"status": "error", "error": f"{type(e).__name__}: {e}"}
            resp["id"] = rid
            try:
                line = json.dumps(resp)
            except (TypeError, ValueError, UnicodeEncodeError):
                # an unserializable response (e.g. an OSError echoing a
                # surrogateescape-decoded path) must not kill the server:
                # per-job isolation extends to the response itself
                line = json.dumps({
                    "status": "error",
                    "error": "unserializable response",
                    "id": repr(rid),
                })
            out.write(line + "\n")
            out.flush()

        with ThreadPoolExecutor(workers, thread_name_prefix="rd-job") as pool:
            for line in lines:
                line = line.strip()
                if not line:
                    continue
                rid = None
                try:
                    req = json.loads(line)
                    rid = req.get("id")
                    fut = pool.submit(self.run_job, req)
                except BaseException as e:  # malformed request line
                    if isinstance(e, (KeyboardInterrupt, SystemExit)):
                        raise
                    emit_err = {"status": "error",
                                "error": f"{type(e).__name__}: {e}", "id": rid}
                    # responses stay in request order: flush prior jobs first
                    while pending:
                        emit(*pending.popleft())
                    out.write(json.dumps(emit_err) + "\n")
                    out.flush()
                    continue
                pending.append((rid, fut))
                # keep at most `workers` jobs in flight; with workers=1
                # this is exactly the strictly-sequential behavior
                while len(pending) >= workers + (1 if workers > 1 else 0):
                    emit(*pending.popleft())
            while pending:
                emit(*pending.popleft())


def _serve(argv, stdin, stdout, device):
    args = build_arg_parser().parse_args(argv)

    from ribodetector_tpu_torch.config import DEFAULT_CONFIG, ConfigParser

    config = ConfigParser.from_json(
        args.config if args.config is not None else DEFAULT_CONFIG
    )
    if device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible: ribodetector_tpu_torch.serve runs "
                "its classify step on the card (serve.main_cpu pins the CPU)"
            )
    # (Server.__init__ bridges args.kernel into the runtime config)
    srv = Server(args, config, device=device)
    print(f"ribodetector_tpu_torch serve: ready (len={args.len}, {device}); "
          "one JSON job per line on stdin", file=sys.stderr, flush=True)
    srv.serve(stdin if stdin is not None else sys.stdin,
              stdout if stdout is not None else sys.stdout)


def main(argv=None, stdin=None, stdout=None):
    """Serve on the card; raises when no CUDA device is visible."""
    _serve(argv, stdin, stdout, "cuda")


def main_cpu(argv=None, stdin=None, stdout=None):
    """Serve pinned to the host CPU (the plain recurrence)."""
    _serve(argv, stdin, stdout, "cpu")


if __name__ == "__main__":
    main()
