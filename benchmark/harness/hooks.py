"""Spans and counters the benchmark puts around calls into the program,
from its own files: nothing inside the program changes.

- ``predictors``: every ``Predictor.load_model`` of the window, timed (the
  start-up span), its StageTimer kept to be read after the window (in a
  traced run switched on, as the program's ``--profile`` does) and the
  kernel mode it runs noted (its precision after the parity probe, and its
  compute dtype where that is not float32: "high", "high.bfloat16").
- ``stage_spans``: in a traced run each StageTimer stage also opens a
  profiler range "stage.<name>", which names the device's idle gaps.
- ``kernel_outputs``: while switched on, each classify call's tokens and
  logits (the kernels' input and output) copied to the host, for the
  reference to judge the kernels by.
- ``train_steps``: the trainer's step and optimizer as fit builds them,
  wrapped to count steps, keep what the reference compares (the first
  steps' losses, the optimizer's first moment after one step, the
  parameters after three) and start and stop the trace's slice on whole
  steps.
"""

import time
from contextlib import contextmanager


@contextmanager
def patched(owner, name, new):
    old = getattr(owner, name)
    setattr(owner, name, new)
    try:
        yield old
    finally:
        setattr(owner, name, old)


class Predictors:
    def __init__(self):
        self.timers, self.modes, self.load_s = [], set(), 0.0

    def stages(self):
        """Main-thread stage seconds {"parse": s, ...} and worker ones
        {"rd-deflate:deflate": s, ...}, summed over the timers kept."""
        main, worker = {}, {}
        for t in self.timers:
            for k, v in t.totals.items():
                main[k] = main.get(k, 0.0) + v
            for (role, name), v in t.worker_totals.items():
                key = f"{role}:{name}"
                worker[key] = worker.get(key, 0.0) + v
        return {"main": main, "worker": worker}


@contextmanager
def predictors(run):
    from ribodetector_tpu_torch.runtime.pipeline import Predictor

    rec = Predictors()

    def load_model(self):
        if run.trace:
            self.timer.enabled = True
        t0 = time.perf_counter()
        with run.span("bench.load_model"):
            orig(self)
        rec.load_s += time.perf_counter() - t0
        rec.timers.append(self.timer)
        dtype = self.compute_dtype
        rec.modes.add(self.precision_mode + ("" if dtype == "float32" else f".{dtype}"))

    with patched(Predictor, "load_model", load_model) as orig:
        yield rec


@contextmanager
def stage_spans(run):
    if not run.trace:
        yield
        return
    from torch.profiler import record_function

    from ribodetector_tpu_torch.runtime.profiling import StageTimer

    @contextmanager
    def stage(self, name):
        with record_function(f"stage.{name}"), orig(self, name):
            yield

    with patched(StageTimer, "stage", stage) as orig:
        yield


class KernelOutputs:
    def __init__(self):
        self.on, self.rows = False, []


@contextmanager
def kernel_outputs(run):
    import ribodetector_tpu_torch.ops as ops

    rec = KernelOutputs()

    def classify_logits(params, tokens, *a, **kw):
        out = orig(params, tokens, *a, **kw)
        if rec.on:
            rec.rows.append((tokens.cpu().numpy(), out.float().cpu().numpy()))
        return out

    with patched(ops, "classify_logits", classify_logits) as orig:
        yield rec


class Steps:
    """What the window's train steps left for the reference and the trace."""

    def __init__(self, trace_from, trace_steps):
        self.trace_from, self.trace_steps = trace_from, trace_steps
        self.steps, self.optimizers, self.losses = 0, [], []
        self.mu1 = self.params3 = None
        self.slice, self.slice_steps = None, 0

    def wrap(self, step):
        rec = self

        class Step:
            def __call__(self, params, *batch):
                i = rec.steps
                if rec.slice is not None and i == rec.trace_from:
                    rec.slice.start()
                loss = step(params, *batch)
                rec.steps += 1
                if i < 3:
                    rec.losses.append(loss)
                if i == 0:
                    rec.mu1 = rec.optimizers[-1].mu.clone()
                if i == 2:
                    rec.params3 = [p.detach().clone() for p in params]
                if rec.slice is not None and i == rec.trace_from + rec.trace_steps - 1:
                    rec.slice.stop()
                    rec.slice_steps = rec.trace_steps
                return loss

            def release(self):
                step.release()

        return Step()


@contextmanager
def train_steps(run, trace_from=0, trace_steps=0):
    from ribodetector_tpu_torch.train import trainer

    rec = Steps(trace_from, trace_steps)

    def make_optimizer(cfg, params):
        opt = orig_opt(cfg, params)
        rec.optimizers.append(opt)
        return opt

    def make_train_step(*a, **kw):
        return rec.wrap(orig_step(*a, **kw))

    with patched(trainer, "make_optimizer", make_optimizer) as orig_opt, \
            patched(trainer, "make_train_step", make_train_step) as orig_step:
        yield rec
