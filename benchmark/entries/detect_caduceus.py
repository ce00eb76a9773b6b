"""Entry: the detect CLI (``ribodetector_tpu_torch.cli.main``) on a
Caduceus-Ph configuration, called in-process back to back on one paired
library, as entries/detect_cli.py calls it on the BiLSTM.

Set-up draws the weights from --seed with the plain reference's init
(reference/caduceus.py) and writes them under the run's tmp in the port's
npz layout, writes the library, builds the CLI's ``-c`` config
(``arch.type: "CaduceusParams"``, its widths, packed semantics and the
configuration's bfloat16 compute; ``-l`` and ``--buckets`` but no
``--precision``) and makes a warm-up call (the kernels build and load).

The window is detect_cli's, imported: its ``Calls``, its two stretches in
a traced run and its reservoir of kept calls. Two of its hooks are put in
the place of harness/hooks.py's for the window: the classify recorder also
keeps each call's lengths (an N at a read's end is token 4, as padding
is, so the tokens alone do not say where a read ends) and, from each
micro-batch's first-layer scan launch of the sampled call, a few rows of
the scan's input and output (``ScanRows``); and the Predictors' stage
totals carry the program's ``cad.*`` counters (``stages["counters"]``,
read by pad_share.caduceus).

The check, from one sampled call's classify calls and the kept calls'
outputs: ``token_faults`` (the classify rows, (length, tokens) as a
multiset, against the reference's encoding of every read: parse, route and
the packed rows), ``kernel_logit_gap`` (``gap_rows`` rows drawn from the
seed, against the reference's conjoined fp32 forward on the card, in
blocks), ``scan_gap`` (the kept scan rows against the reference's layer
at the configuration's own precision, from the same in-projection
output: the number that sees a scan state held in bf16, which the logits
do not, the configuration's bf16 products moving them more),
``layout_faults`` and ``wrong_file`` (over ``label_pairs`` pairs drawn
from the seed in each kept call, none in another file where the
reference's pair margin exceeds 4x kernel_logit_gap).
"""

import json
import shutil
from contextlib import contextmanager

import numpy as np

from entries import detect_cli
from harness import hooks, outputs, traffic
from reference import caduceus as cref
from reference import model as ref

PORT_ARGS = ("d_model", "n_layer", "vocab_size", "d_state", "d_conv", "expand", "dt_rank",
             "num_classes")


def model_of(run):
    """The configuration's widths; a CPU rehearsal may shrink them through
    the mix's "model_widths" (the measured mixes have none)."""
    return {**run.cfg["model"], **run.mix.get("model_widths", {})}


def cli_argv(run):
    cfg = run.cfg
    path = run.path("cli_config.json")
    model = model_of(run)
    with open(path, "w") as fh:
        json.dump({"name": cfg["name"],
                   "arch": {"type": "CaduceusParams",
                            "args": {k: model[k] for k in PORT_ARGS}},
                   "state_file": {"mcc": run.weights, "recall": run.weights},
                   "runtime": {"semantics": cfg["semantics"],
                               "compute_dtype": cfg["compute_dtype"], "kernel": "auto"}}, fh)
    return ["-c", path, "-l", str(cfg["len"]),
            "--buckets", ",".join(str(b) for b in cfg["buckets"])]


def setup(run):
    from ribodetector_tpu_torch import cli

    model = model_of(run)
    run.weights = run.path("weights", "caduceus.npz")
    cref.save(run.weights, cref.init(int(run.rng("weights").integers(0, 2**63)), model), model)
    lib = run.mix["library"]
    sides = detect_cli.make_library(run)
    ext = detect_cli.EXT[lib["format"]] + (".gz" if lib.get("gz_level") else "")
    inputs = [run.path("in", f"in_{s}{ext}") for s in (1, 2)]
    traffic.write_sides(inputs, sides, lib["format"], lib.get("gz_level"), lib.get("wrap", 80))
    state = {"sides": sides, "inputs": inputs,
             "ensure": detect_cli.ensure_of(run.mix["argv"]), "argv": cli_argv(run),
             "main": cli.main if run.device == "cuda" else cli.main_cpu}
    detect_cli.call(run, state, "warm")
    shutil.rmtree(detect_cli.call_dir(run, "warm"))
    return state


class ScanRows:
    """The first layer's scan launches of the sampled call: up to
    ``SCAN_ROWS_PER_LAUNCH`` rows drawn from the seed in each, ``scan_rows``
    in all, each (in-projection output [T, 2E], length, gated output [T,
    E]) as the program computed them (the layer's is the one whose b_dt
    view starts its stacked tensor)."""

    def __init__(self, run, rec):
        self.rec, self.rows, self.pending, self.kept = rec, [], [], 0
        self.cap, self.pick = run.mix["scan_rows"], run.rng("scan")

    def wrap(self, fn, names):
        """fn (the kernel's wrapper or the plain version, whose arguments
        are `names`), keeping rows of its first layer's launches."""
        import torch

        def scan(*a):
            out = fn(*a)
            arg = dict(zip(names, a))
            if self.rec.on and arg["b_dt"].storage_offset() == 0 and self.kept < self.cap:
                n = out.shape[0]
                k = min(SCAN_ROWS_PER_LAUNCH, n, self.cap - self.kept)
                idx = torch.from_numpy(np.sort(self.pick.choice(n, k, replace=False)))
                idx = idx.to(out.device)
                self.pending.append(tuple(t.index_select(0, idx) for t in (
                    arg["xz"], arg["lengths"], out)))
                self.kept += k
            return out

        return scan

    def collect(self):
        """The pending rows to the host (after a classify call, whose scans
        are then done)."""
        for xz, lengths, out in self.pending:
            self.rows += zip(xz.cpu(), lengths.cpu().tolist(), out.cpu())
        self.pending = []


SCAN_ROWS_PER_LAUNCH = 4
SCAN_CUDA_ARGS = ("xz", "dbc", "lengths", "conv_w", "conv_b", "w_dt", "b_dt", "a2", "d")
SCAN_PLAIN_ARGS = ("xz", "dbc", "xc", "lengths", "w_dt", "b_dt", "a_log", "d")


@contextmanager
def caduceus_outputs(run, scans):
    """hooks.kernel_outputs, keeping each classify call's (tokens, lengths,
    logits) while switched on, and the first layer's scan rows (`scans`, a
    ScanRows whose recorder this is): from the kernel on the card, from
    its plain version on the CPU."""
    import ribodetector_tpu_torch.models.caduceus as plain
    import ribodetector_tpu_torch.ops as ops
    import ribodetector_tpu_torch.ops.caduceus_cuda as card

    rec = scans.rec

    def classify_logits(params, tokens, lengths=None, *a, **kw):
        out = orig(params, tokens, lengths, *a, **kw)
        if rec.on:
            rec.rows.append((tokens.cpu().numpy(), lengths.cpu().numpy(),
                             out.float().cpu().numpy()))
            scans.collect()
        return out

    with hooks.patched(ops, "classify_logits", classify_logits) as orig, \
            hooks.patched(card, "scan_cuda", scans.wrap(card.scan_cuda, SCAN_CUDA_ARGS)), \
            hooks.patched(plain, "scan_plain", scans.wrap(plain.scan_plain, SCAN_PLAIN_ARGS)):
        yield rec


class CaduceusPredictors(hooks.Predictors):
    def stages(self, first=0, last=None):
        out = super().stages(first, last)
        counters = {}
        for t in self.timers[first:last]:
            for k, v in t.counters.items():
                counters[k] = counters.get(k, 0) + v
        out["counters"] = counters
        return out


def window(run, state):
    scans = ScanRows(run, hooks.KernelOutputs())
    with hooks.patched(hooks, "kernel_outputs", lambda run: caduceus_outputs(run, scans)), \
            hooks.patched(hooks, "Predictors", CaduceusPredictors):
        rec = detect_cli.window(run, state)
    state["scan_rows"] = scans.rows
    return rec


def encoded(run, state):
    """[(tokens [n, L], lengths [n]) of each side] as the reference encodes
    the reads."""
    L = run.cfg["len"]
    fasta = run.mix["library"]["format"] == "fasta"
    return [(ref.encode(b, n, L, fasta), np.minimum(n, L)) for b, n in state["sides"]]


def row_keys(tokens, lengths, L):
    """(length, tokens padded to L) of each row with bases, as sorted bytes."""
    live = lengths > 0
    full = np.full((int(live.sum()), L + 2), ref.PAD, np.uint8)
    full[:, :2] = np.stack([lengths[live] >> 8, lengths[live] & 255], axis=1)
    full[:, 2: 2 + tokens.shape[1]] = tokens[live]
    return np.sort(np.ascontiguousarray(full).view(f"V{L + 2}").ravel())


def sampled_rows(run, state):
    """The sampled call's classify rows with bases: (tokens [m, L],
    lengths [m], logits [m, 2])."""
    L = run.cfg["len"]
    toks, lens, lgs = [], [], []
    for tokens, lengths, logits in state["kernel_rows"]:
        live = lengths > 0
        full = np.full((int(live.sum()), L), ref.PAD, np.uint8)
        full[:, : tokens.shape[1]] = tokens[live]
        toks.append(full)
        lens.append(lengths[live].astype(np.int64))
        lgs.append(logits[live])
    if not toks:
        return np.zeros((0, L), np.uint8), np.zeros(0, np.int64), np.zeros((0, 2), np.float32)
    return np.concatenate(toks), np.concatenate(lens), np.concatenate(lgs)


def scan_gap(state, w):
    """The program's first-layer gated scan output on the kept rows against
    the reference's (``gated`` at the configuration's precision, "bf16":
    bf16 products, fp32 state) from the same in-projection output, both
    rounded to bf16 as the kernel writes it: the relative root mean square
    over the rows' own positions. No rows kept reads infinite."""
    import torch

    rows = state["scan_rows"]
    if not rows:
        return float("inf")
    dev = w["w_head"].device
    T = max(xz.shape[0] for xz, _, _ in rows)

    def padded(i):
        out = torch.zeros((len(rows), T, rows[0][i].shape[1]))
        for k, r in enumerate(rows):
            out[k, : r[i].shape[0]] = r[i].float()
        return out.to(dev)

    xz, got = padded(0), padded(2)
    lengths = torch.tensor([n for _, n, _ in rows], device=dev)
    cref.strict_fp32()
    with torch.no_grad():
        want = cref.gated(w, 0, xz, lengths, "bf16").bfloat16().double()
    inside = torch.arange(T, device=dev)[None, :, None] < lengths[:, None, None]
    diff = torch.where(inside, got.bfloat16().double() - want, 0.0)
    return float(diff.norm() / torch.where(inside, want, 0.0).norm())


def check(run, state, rec):
    L = run.cfg["len"]
    dev = "cuda" if run.device == "cuda" else "cpu"
    w = cref.load(run.weights, dev)
    enc = encoded(run, state)
    tok, lens, got = sampled_rows(run, state)
    want_keys = row_keys(np.concatenate([t for t, _ in enc]),
                         np.concatenate([n for _, n in enc]), L)
    got_keys = row_keys(tok, lens, L)
    if len(got_keys) != len(want_keys):
        token_faults = abs(len(got_keys) - len(want_keys))
    else:
        token_faults = int(np.sum(got_keys != want_keys))
    gap = 0.0
    if len(lens):
        rows = np.sort(run.rng("gap").choice(len(lens), min(run.mix["gap_rows"], len(lens)),
                                             replace=False))
        gap = float(np.abs(cref.logits(w, tok[rows], lens[rows]) - got[rows]).max())
    n = len(enc[0][1])
    pick = np.sort(run.rng("pairs").choice(n, min(run.mix["label_pairs"], n), replace=False))
    l1, l2 = (cref.logits(w, t[pick], m[pick]) for t, m in enc)
    want = ref.pair_labels(l1, l2, state["ensure"])
    margin = ref.pair_margin(l1, l2, state["ensure"])
    faults, wrong = state["missing"], 0
    for k in state["kept"]:
        _, files = detect_cli.call_files(run, state, k)
        labels, f = outputs.partition(files, n)
        faults += sum(f.values())
        lab = labels[pick]
        bad = (lab != want) & (lab != -9) & (margin > 4 * gap)
        wrong = max(wrong, int(bad.sum()))
    return {"layout_faults": faults, "token_faults": token_faults,
            "kernel_logit_gap": gap, "scan_gap": scan_gap(state, w), "wrong_file": wrong}
