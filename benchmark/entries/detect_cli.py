"""Entry: the detect CLI (``ribodetector_tpu_torch.cli.main``) called
in-process, back to back, on one paired library, as a lab runs it on each
library it sequences.

The CLI's arguments come from the configuration file alone: its ``-l``,
``--precision`` and ``--buckets``, and a ``-c`` config file of its model,
weights, semantics and compute dtype; the mix adds its own (``-e``).

Set-up writes the library from the seed and makes one warm-up call (the
parity probe runs and fills its marker, the kernels load, as on a user's
first library on a machine). The window then calls the CLI until
``--seconds`` have passed; every call is whole.

A traced run turns the Predictors' StageTimers on and splits the window
into two stretches of whole calls, each until half of ``--seconds`` has
passed: first the unprofiled stretch, where no torch profiler runs, then
the profiled one under the trace's slice. The profiler records every op a
call launches and slows the calls by as much as they launch, so the
program's stage times and the wall-clock ratios are read over the
unprofiled stretch, at the untraced pace, and only the device trace over
the profiled one (``harness/readers.py`` ``part``). The record keeps each
stretch's calls, wall, reads, bases, start-up seconds and stage totals, and
the profiled stretch's kernel work and trace summary.

Only ``sample_calls`` calls, drawn from the seed as the window goes (a
reservoir sample), keep their outputs; every other call's are checked to
exist and deleted as soon as it returns, so that the window's files do not
pile up in the page cache and on disk. The check holds the kept outputs,
read for read, to the plain reference's labels: every read in the file of
its label, in input order, the two ends in step, each written once.

Where the mix asks for "kernel_sample", one call drawn from the seed also
keeps each classify call's tokens and logits, and the check judges the
stages apart: parse and encode (the tokens, as a multiset of rows, against
the reference's encoding of every read), the bucketed kernels (their
logits against the reference's full-length forward of the same tokens),
and ensure and write (no read in another file than the reference's where
its margin lies beyond what the kernels' logit gap can flip).
"""

import gc
import json
import os
import shutil
import time

import numpy as np

from harness import hooks, outputs, traffic, work
from harness.trace import Slice
from reference import model as ref

EXT = {"fastq": ".fq", "fasta": ".fa"}


def ensure_of(argv):
    return argv[argv.index("-e") + 1] if "-e" in argv else "none"


def cli_argv(run):
    """The CLI's arguments that the configuration states (see above)."""
    cfg = run.cfg
    path = run.path("cli_config.json")
    with open(path, "w") as fh:
        json.dump({"name": cfg["name"],
                   "arch": {"type": "BiLSTMParams", "args": cfg["model"]},
                   "state_file": {"mcc": run.weights, "recall": run.weights},
                   "runtime": {"semantics": cfg["semantics"],
                               "compute_dtype": cfg["compute_dtype"], "kernel": "auto"}}, fh)
    return ["-c", path, "-l", str(cfg["len"]), "--precision", cfg["precision"],
            "--buckets", ",".join(str(b) for b in cfg["buckets"])]


def call_dir(run, k):
    return os.path.join(run.tmp, "calls", str(k))


def call_files(run, state, k):
    """(the call's -o/-r argv, {label: [file per side]})."""
    ext = run.mix["out_ext"]
    norrna = [run.path("calls", str(k), f"norrna_{s}{ext}") for s in (1, 2)]
    rrna = [run.path("calls", str(k), f"rrna_{s}{ext}") for s in (1, 2)]
    files = {0: norrna, 1: rrna}
    if state["ensure"] == "both":
        files[-1] = [f + ".unclassified.gz" for f in norrna]
    return ["-o", *norrna, "-r", *rrna], files


def call(run, state, k):
    out, _ = call_files(run, state, k)
    state["main"]([*state["argv"], "-i", *state["inputs"], *out, *run.mix["argv"]])


def missing_files(run, state, k):
    _, files = call_files(run, state, k)
    return sum(not os.path.exists(f) for paths in files.values() for f in paths)


def make_library(run):
    lib = run.mix["library"]
    return traffic.make_pairs(run.rng("library"), lib["pairs"], lib["reads"])


def setup(run):
    from ribodetector_tpu_torch import cli

    lib = run.mix["library"]
    sides = make_library(run)
    ext = EXT[lib["format"]] + (".gz" if lib.get("gz_level") else "")
    inputs = [run.path("in", f"in_{s}{ext}") for s in (1, 2)]
    traffic.write_sides(inputs, sides, lib["format"], lib.get("gz_level"), lib.get("wrap", 80))
    state = {"sides": sides, "inputs": inputs, "ensure": ensure_of(run.mix["argv"]),
             "argv": cli_argv(run),
             "main": cli.main if run.device == "cuda" else cli.main_cpu}
    call(run, state, "warm")
    shutil.rmtree(call_dir(run, "warm"))
    return state


class Calls:
    """The window's calls, numbered from 0 across its stretches: each
    call's missing files counted, and a reservoir of ``sample_calls``
    calls drawn from the seed keeps its outputs."""

    def __init__(self, run, state, preds, kernel):
        self.run, self.state, self.preds, self.kernel = run, state, preds, kernel
        self.sample = int(run.rng("kernel").integers(0, 2)) if run.mix.get("kernel_sample") else -1
        self.keep_n, self.pick = run.mix["sample_calls"], run.rng("sample")
        self.n, self.kept, self.missing = 0, [], 0
        L = run.cfg["len"]
        self.reads = sum(len(lengths) for _, lengths in state["sides"])
        self.bases = sum(work.bases(lengths, L) for _, lengths in state["sides"])

    def one(self):
        run, state, k = self.run, self.state, self.n
        self.kernel.on = k == self.sample
        with run.span("bench.call"):
            call(run, state, k)
        self.kernel.on = False
        self.missing += missing_files(run, state, k)
        if len(self.kept) < self.keep_n:
            self.kept.append(k)
        else:
            j = int(self.pick.integers(0, k + 1))
            if j < self.keep_n:
                self.kept[j], dropped = k, self.kept[j]
            else:
                dropped = k
            shutil.rmtree(call_dir(run, dropped))
        gc.collect()
        self.n = k + 1

    def stretch(self, seconds, last):
        """Whole calls until `seconds` have passed, and in the window's last
        stretch until the sampled calls have run -> the stretch's tally."""
        first, timers, load_s = self.n, len(self.preds.timers), self.preds.load_s
        t0 = time.perf_counter()
        while True:
            self.one()
            if (time.perf_counter() - t0 >= seconds
                    and (not last or (self.n > self.sample and self.n >= self.keep_n))):
                break
        self.run.sync()
        wall = time.perf_counter() - t0
        calls = self.n - first
        return {"wall_s": wall, "calls": calls, "reads": calls * self.reads,
                "bases": calls * self.bases, "load_model_s": self.preds.load_s - load_s,
                "timers": (timers, len(self.preds.timers))}


def window(run, state):
    # what set-up left is never collected again: the collection after each
    # call walks only that call's objects
    gc.collect()
    gc.freeze()
    with hooks.predictors(run) as preds, hooks.kernel_outputs(run) as kernel:
        calls = Calls(run, state, preds, kernel)
        if run.trace:
            parts = {"unprofiled": calls.stretch(run.seconds / 2, last=False)}
            sl = Slice(run.tmp, run.device)
            sl.start()
            parts["profiled"] = calls.stretch(run.seconds / 2, last=True)
            sl.stop()
            sl.finish()
            parts["profiled"]["trace"] = sl.summary
        else:
            parts = {"window": calls.stretch(run.seconds, last=True)}
    gc.unfreeze()
    state.update(calls=calls.n, kept=sorted(calls.kept), missing=calls.missing,
                 kernel_rows=kernel.rows)
    # every read of the window ran on the one kernel mode the Predictors ran
    modes = sorted(preds.modes)
    for p in parts.values():
        first, last = p.pop("timers")
        p["kernel_work"] = {modes[0]: (p["bases"], p["reads"])} if len(modes) == 1 else {}
        if run.trace:
            p["stages"] = preds.stages(first, last)
    rec = {"attempted": calls.n, "failed": 0}
    if not run.trace:
        return {**rec, **parts["window"]}
    return {**rec, "stretches": parts,
            **{k: sum(p[k] for p in parts.values()) for k in ("wall_s", "reads", "bases")}}


def encoded(run, state):
    fasta = run.mix["library"]["format"] == "fasta"
    return [ref.encode(b, n, run.cfg["len"], fasta) for b, n in state["sides"]]


def reference_labels(run, state):
    """(each pair's label, how far it is from flipping) by the reference."""
    w = ref.load_weights(run.weights, run.device)
    lg = [ref.logits(w, tokens) for tokens in encoded(run, state)]
    ensure = state["ensure"]
    return ref.pair_labels(lg[0], lg[1], ensure), ref.pair_margin(lg[0], lg[1], ensure)


def row_set(tokens):
    """The rows of a token matrix that hold a call, as sorted bytes."""
    rows = tokens[(tokens != ref.PAD).any(axis=1)]
    return np.sort(np.ascontiguousarray(rows).view(f"V{rows.shape[1]}").ravel())


def kernel_numbers(run, state):
    """The stages judged apart from one sampled call's classify calls:
    (token rows that are not the reference's encoding of a read, the
    widest gap between a kernel's logit and the reference's)."""
    L = run.cfg["len"]
    w = ref.load_weights(run.weights, run.device)
    got_rows, gap = [], 0.0
    for tokens, logits in state["kernel_rows"]:
        full = np.full((len(tokens), L), ref.PAD, np.uint8)
        full[:, : tokens.shape[1]] = tokens
        # a batch's padding rows hold no call; under a shorter bucket their
        # output is taken at another row than at full length, and no read
        # is there to use it
        keep = (tokens != ref.PAD).any(axis=1) | (tokens.shape[1] == L)
        if keep.any():
            gap = max(gap, float(np.abs(ref.logits(w, full[keep]) - logits[keep]).max()))
        got_rows.append(full)
    want_rows = row_set(np.concatenate(encoded(run, state)))
    if not got_rows:  # nothing was captured: every row is missing
        return len(want_rows), 0.0
    got = row_set(np.concatenate(got_rows))
    if len(got) != len(want_rows):
        return abs(len(got) - len(want_rows)), gap
    return int(np.sum(got != want_rows)), gap


def check(run, state, rec):
    want, margin = reference_labels(run, state)
    n = len(want)
    sampled = run.mix.get("kernel_sample")
    if sampled:
        token_faults, gap = kernel_numbers(run, state)
    faults, mismatches, widest, wrong = state["missing"], 0, 0.0, 0
    for k in state["kept"]:
        _, files = call_files(run, state, k)
        got, f = outputs.partition(files, n)
        faults += sum(f.values())
        m, w = outputs.held(got, want, margin)
        mismatches, widest = max(mismatches, m), max(widest, w)
        if sampled:
            # a pair's label moves with its two ends' logits: it cannot
            # flip where its margin exceeds four times the kernels' gap
            bad = (got != want) & (got != -9) & (margin > 4 * gap)
            wrong = max(wrong, int(bad.sum()))
    if sampled:
        return {"layout_faults": faults, "token_faults": token_faults,
                "kernel_logit_gap": gap, "wrong_file": wrong}
    return {"layout_faults": faults, "mismatches": mismatches, "mismatch_margin": widest}
