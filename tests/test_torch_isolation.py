"""ribodetector_tpu_torch stands alone: it imports neither jax nor any module
of the JAX package ribodetector_tpu, and ships no prebuilt binary.

Careful with the names: "ribodetector_tpu_torch" starts with
"ribodetector_tpu", so a stray import is "ribodetector_tpu" followed by ".",
by whitespace or by the end of the name -- never by "_torch".
"""

import json
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import ribodetector_tpu_torch

REPO = Path(__file__).resolve().parent.parent
PKG = Path(ribodetector_tpu_torch.__file__).resolve().parent
STRAY = re.compile(r"^ribodetector_tpu(\.|$)")
STRAY_IMPORT = re.compile(
    r"^\s*(from\s+ribodetector_tpu(\.\S+)?\s+import|import\s+ribodetector_tpu(\.\S*)?(\s|,|$))",
    re.M,
)
JAX_IMPORT = re.compile(r"^\s*(import\s+jax(\.|\s|,|$)|from\s+jax(\.\S+)?\s+import)", re.M)


def _all_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages([str(PKG)], "ribodetector_tpu_torch.")
    )


def test_importing_every_module_loads_no_jax():
    mods = _all_modules()
    assert "ribodetector_tpu_torch.runtime.native_pipeline" in mods
    assert "ribodetector_tpu_torch.ops.lstm_cuda" in mods
    assert "ribodetector_tpu_torch.parallel.mesh" in mods
    assert "ribodetector_tpu_torch.train.__main__" in mods
    assert "ribodetector_tpu_torch.train.optim" in mods
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(REPO), timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert not [m for m in loaded if m == "jax" or m.startswith("jax.")]
    assert not [m for m in loaded if STRAY.match(m)]
    assert "ribodetector_tpu_torch.cli" in loaded


def test_stray_name_rules():
    assert STRAY.match("ribodetector_tpu")
    assert STRAY.match("ribodetector_tpu.io")
    assert not STRAY.match("ribodetector_tpu_torch")
    assert not STRAY.match("ribodetector_tpu_torch.io")
    assert STRAY_IMPORT.search("from ribodetector_tpu.io import x")
    assert STRAY_IMPORT.search("import ribodetector_tpu")
    assert STRAY_IMPORT.search("    from ribodetector_tpu import native")
    assert not STRAY_IMPORT.search("from ribodetector_tpu_torch.io import x")
    assert not STRAY_IMPORT.search("import ribodetector_tpu_torch.cli")
    assert JAX_IMPORT.search("    import jax.numpy as jnp")
    assert not JAX_IMPORT.search("import jaxlib_free_name_is_fine")


CARD_TESTS = sorted((REPO / "tests").glob("test_torch_card_*.py"))


def test_sources_hold_no_stray_import():
    sources = (list(PKG.rglob("*.py")) + [REPO / "chip_smoke.py", REPO / "ab_main.py"]
               + CARD_TESTS)
    assert len(sources) > 20
    for path in sources:
        text = path.read_text()
        assert not JAX_IMPORT.search(text), path
        assert not STRAY_IMPORT.search(text), path


def test_card_tests_load_no_jax():
    """The card tests run on the card's machine without tests/conftest.py
    (which imports jax): importing each loads neither jax nor the JAX
    package."""
    names = [p.stem for p in CARD_TESTS]
    assert {"test_torch_card_kernels", "test_torch_card_train",
            "test_torch_card_dispatch"} <= set(names)
    code = (
        "import importlib, json, sys\n"
        f"sys.path.insert(0, {str(REPO / 'tests')!r})\n"
        f"for m in {names!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(REPO), timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert not [m for m in loaded if m == "jax" or m.startswith("jax.")]
    assert not [m for m in loaded if STRAY.match(m)]
    assert set(names) <= set(loaded)


def test_no_prebuilt_binary_is_tracked():
    out = subprocess.run(["git", "ls-files", str(PKG)], capture_output=True,
                         text=True, cwd=str(REPO))
    if out.returncode != 0:  # not a git checkout: check the tree instead
        tracked = [str(p) for p in PKG.rglob("*") if "_build" not in p.parts]
    else:
        tracked = out.stdout.split()
    assert not [p for p in tracked if p.endswith((".so", ".o", ".cubin"))]
