"""Nothing the benchmark loads is JAX or the JAX package, compared by whole
top-level module names (ribodetector_tpu_torch begins with
ribodetector_tpu), and the reference loads nothing of the program."""

import glob
import json
import os
import subprocess
import sys

from harness import core

FORBIDDEN = ["jax", "jaxlib", "flax", "ribodetector_tpu"]


def loaded_after(code):
    """The top-level names of sys.modules in a child process after `code`."""
    prog = (
        "import sys, json\n"
        f"sys.path[:0] = [{core.BENCH_DIR!r}, {core.REPO!r}]\n"
        f"{code}\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    )
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                         timeout=300, cwd=core.REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def module_files(kind):
    return sorted(os.path.splitext(os.path.basename(p))[0]
                  for p in glob.glob(os.path.join(core.BENCH_DIR, kind, "*.py")))


def test_harness_loads_no_jax():
    lines = ["import runpy",
             "from harness import control, core, hooks, outputs, readers, trace, traffic, work",
             "from reference import model",
             f"runpy.run_path({os.path.join(core.BENCH_DIR, 'run.py')!r})"]
    for kind in ("entries", "metrics"):
        lines += [f"core.load_module({kind!r}, {name!r})" for name in module_files(kind)]
    # the program modules the entries call into
    lines += ["import ribodetector_tpu_torch.cli, ribodetector_tpu_torch.ops.dispatch",
              "import ribodetector_tpu_torch.train.trainer, ribodetector_tpu_torch.runtime.pipeline",
              "import ribodetector_tpu_torch.runtime.native_pipeline, torch.profiler"]
    found = loaded_after("\n".join(lines))
    assert "ribodetector_tpu_torch" in found
    assert not found & set(FORBIDDEN), sorted(found & set(FORBIDDEN))


def test_reference_loads_nothing_of_the_program():
    found = loaded_after("import reference, reference.model")
    assert not found & set(FORBIDDEN + ["ribodetector_tpu_torch"])


def test_forbidden_check_compares_whole_names(monkeypatch):
    import types

    base = set(core.forbidden_modules())
    monkeypatch.setitem(sys.modules, "ribodetector_tpu_torch_probe", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxlib_probe.sub", types.ModuleType("x"))
    assert set(core.forbidden_modules()) == base
    monkeypatch.setitem(sys.modules, "ribodetector_tpu.models", types.ModuleType("x"))
    assert "ribodetector_tpu" in core.forbidden_modules()
