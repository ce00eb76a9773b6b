"""The port's coordinated multi-host runtime: real processes in a gloo group.

Twins of tests/test_distributed.py. Each host is a subprocess calling
ribodetector_tpu_torch.cli.main_cpu with --coordinator 127.0.0.1:<port>
(a torch.distributed gloo group over loopback), against one shared tmp
directory; host 0's merged outputs are held byte for byte (gz: content)
against a one-host run of the JAX CLI (--kernel scan) on the same inputs.
Every distinct read's JAX-scan margin is >= 1e-4 (see test_torch_cli.py),
so cross-package byte identity is well-defined.
"""

import gzip
import json
import os
import socket
import subprocess
import sys
import time
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest

from ribodetector_tpu.cli import main as jax_main
from ribodetector_tpu.encode import encode_batch
from ribodetector_tpu.models import bilstm_logits, load_params
from ribodetector_tpu_torch.config import DEFAULT_CONFIG, ConfigParser
from ribodetector_tpu_torch.runtime import Predictor
from ribodetector_tpu_torch.runtime.native_pipeline import DistributedParts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEN = 100  # buckets [64, 100]: the parts-mode writes of the bucketed engine
BASE = "ACGTTGCA" * 14
ENTRY = "import sys; from ribodetector_tpu_torch.cli import main_cpu; main_cpu(sys.argv[1:])"
# host 1 crashes (os._exit) when it opens its second owned chunk
DYING = (
    "import os, sys\n"
    "from ribodetector_tpu_torch.runtime import native_pipeline as npp\n"
    "orig = npp.DistributedParts.open_chunk\n"
    "calls = [0]\n"
    "def dying(self, p, ci):\n"
    "    calls[0] += 1\n"
    "    if calls[0] >= 2:\n"
    "        os._exit(17)\n"
    "    return orig(self, p, ci)\n"
    "npp.DistributedParts.open_chunk = dying\n"
    "from ribodetector_tpu_torch.cli import main_cpu\n"
    "main_cpu(sys.argv[1:])\n"
)
SUFFIXES = ("o1.fq", "o2.fq.gz", "rr1.fq", "rr2.fq",
            "o1.fq.unclassified.gz", "o2.fq.gz.unclassified.gz")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _seqs(n):
    return ([BASE[: 20 + (i * 7) % 80] for i in range(n)],
            [BASE[3 : 23 + (i * 5) % 77] for i in range(n)])


@pytest.fixture(scope="module", autouse=True)
def margins(ref_params_path):
    """Every distinct read of the fixtures has a JAX-scan margin >= 1e-4."""
    seqs1, seqs2 = _seqs(5000)
    distinct = sorted(set(seqs1) | set(seqs2))
    tok, _ = encode_batch(distinct, LEN)
    logits = np.asarray(bilstm_logits(load_params(ref_params_path), jnp.asarray(tok)))
    assert np.abs(logits[:, 1] - logits[:, 0]).min() >= 1e-4


def _mk_inputs(d, n=3000):
    seqs1, seqs2 = _seqs(n)
    for path, seqs in ((d / "r1.fq", seqs1), (d / "r2.fq", seqs2)):
        with open(path, "w") as fh:
            for i, s in enumerate(seqs):
                fh.write(f"@d{i}\n{s}\n+\n{'I' * len(s)}\n")


def _argv(d, tag):
    return [
        "-l", str(LEN),
        "-i", str(d / "r1.fq"), str(d / "r2.fq"),
        "-o", str(d / f"{tag}_o1.fq"), str(d / f"{tag}_o2.fq.gz"),
        "-r", str(d / f"{tag}_rr1.fq"), str(d / f"{tag}_rr2.fq"),
        "-e", "both", "-m", "4", "--chunk_size", "1",
    ]


def _jax_single(d):
    jax_main([*_argv(d, "single"), "--kernel", "scan"])


def _launch(d, argv, num_hosts, dying=(), extra=()):
    """One port process per host of a fresh gloo group; hosts in `dying`
    run the crashing entry instead."""
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": REPO}
    return [
        subprocess.Popen(
            [sys.executable, "-c", DYING if hid in dying else ENTRY, *argv, *extra,
             "--coordinator", f"127.0.0.1:{port}",
             "--num-hosts", str(num_hosts), "--host-id", str(hid)],
            cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for hid in range(num_hosts)
    ]


def _content(path):
    op = gzip.open if str(path).endswith("gz") else open
    with op(path, "rb") as fh:
        return fh.read()


def _assert_merged(d, tag):
    for suffix in SUFFIXES:
        assert _content(d / f"{tag}_{suffix}") == _content(d / f"single_{suffix}"), suffix


def test_two_process_distributed_merge(tmp_path):
    _mk_inputs(tmp_path)
    _jax_single(tmp_path)
    procs = _launch(tmp_path, _argv(tmp_path, "dist"), 2)
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    _assert_merged(tmp_path, "dist")
    leftovers = [p.name for p in tmp_path.iterdir()
                 if ".parts" in p.name or ".host" in p.name]
    assert leftovers == []
    # host 0 logged the group-merged summary
    err0 = outs[0][1]
    assert "Merged outputs from 2 hosts" in err0
    assert "Processed" in err0


def test_three_process_distributed_merge_asymmetric(tmp_path):
    """3 hosts over 5 chunks (batch 1024 at -m 4 paired): round robin gives
    them 2/2/1 chunks, and the merge still restores input order."""
    _mk_inputs(tmp_path, n=5000)
    _jax_single(tmp_path)
    procs = _launch(tmp_path, _argv(tmp_path, "dist"), 3)
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    _assert_merged(tmp_path, "dist")
    assert [p.name for p in tmp_path.iterdir() if ".parts" in p.name] == []
    assert "Merged outputs from 3 hosts" in outs[0][1]


def test_dead_host_fails_barrier_with_clear_error(tmp_path):
    """A host dies mid-run: the survivor fails the end-of-run barrier with
    the clear error (a gloo transport error once the peer's sockets close,
    or the --barrier-timeout watchdog) instead of hanging, and its
    completed parts stay on disk."""
    _mk_inputs(tmp_path, n=5000)
    t0 = time.monotonic()
    procs = _launch(tmp_path, _argv(tmp_path, "dead"), 2, dying=(1,),
                    extra=["--barrier-timeout", "5"])
    outs = [p.communicate(timeout=240) for p in procs]
    assert procs[1].returncode == 17  # the simulated crash
    assert procs[0].returncode != 0  # survivor fails instead of hanging
    err0 = outs[0][1]
    assert "Coordinated run: end-of-run barrier" in err0, err0[-3000:]
    assert "a cooperating host likely died mid-run" in err0
    assert time.monotonic() - t0 < 200
    assert [p.name for p in tmp_path.iterdir() if p.name.endswith(".parts")]


def _predictor_args(d, **kw):
    args = dict(
        len=LEN, input=[str(d / "r1.fq"), str(d / "r2.fq")],
        output=[str(d / "o1.fq"), str(d / "o2.fq")],
        rrna=None, ensure="none", threads=1, memory=4, chunk_size=1,
        log=None, profile=False, trace_dir=None, resume=True,
        semantics=None, kernel=None, precision=None, buckets=None,
        hosts=2, host_id=0, coordinator=None, num_hosts=None,
        deviceid=None, config=None, barrier_timeout=None,
    )
    args.update(kw)
    return SimpleNamespace(**args)


def test_resume_rejected_with_uncoordinated_hosts(tmp_path):
    _mk_inputs(tmp_path)
    p = Predictor(ConfigParser.from_json(DEFAULT_CONFIG), _predictor_args(tmp_path),
                  device="cpu")
    p.load_model()
    with pytest.raises(RuntimeError, match="--resume with --hosts requires"):
        p.detect()


def test_group_relaunch_skips_completed_chunks(tmp_path):
    """Host 1 of 3 dies, the survivors fail their barrier; relaunching the
    WHOLE group with the same commands + --resume reprocesses only the
    unfinished chunks, and the merged outputs equal the JAX one-host run."""
    _mk_inputs(tmp_path, n=5000)  # 5 chunks over 3 hosts: own 2/2/1
    _jax_single(tmp_path)
    # the survivors of round 1 fail on the dead peer's closed sockets; the
    # timeout must outlast host 1's own chunks in round 2, under load
    argv = _argv(tmp_path, "relaunch") + ["--barrier-timeout", "120"]
    procs = _launch(tmp_path, argv, 3, dying=(1,))
    [p.communicate(timeout=240) for p in procs]
    assert procs[1].returncode == 17
    assert procs[0].returncode != 0 and procs[2].returncode != 0
    manifests = sorted(p.name for p in tmp_path.iterdir() if ".progress.json" in p.name)
    # hosts 0 and 2 finished every owned chunk before the barrier
    assert "relaunch_o1.fq.parts.host000.progress.json" in manifests
    assert "relaunch_o1.fq.parts.host002.progress.json" in manifests
    assert json.load(open(tmp_path / manifests[0]))["config"]["kernel"] == "plain"

    procs = _launch(tmp_path, argv, 3, extra=["--resume"])
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    assert "Coordinated resume: skipping 2 completed chunks" in outs[0][1]
    assert "Coordinated resume: skipping 1 completed chunks" in outs[2][1]
    _assert_merged(tmp_path, "relaunch")
    # the merged summary counts include the skipped chunks' contributions
    assert "Merged outputs from 3 hosts" in outs[0][1]
    assert "5000" in outs[0][1]  # Processed 5000 sequences in total
    leftovers = [p.name for p in tmp_path.iterdir()
                 if ".parts" in p.name or ".progress.json" in p.name]
    assert leftovers == []


def test_parts_merge_orders_numerically_past_six_digits(tmp_path):
    """Past chunk 999999 the %06d part name grows a digit: the merge orders
    parts by number, not by name."""
    out = tmp_path / "o.fq"
    parts = str(out) + ".parts"
    os.makedirs(parts)
    for ci, payload in ((99, b"A"), (999999, b"B"), (1000000, b"C"),
                        (1000001, b"D"), (100001, b"E")):
        with open(DistributedParts._part_path(str(out), ci), "wb") as fh:
            fh.write(payload)
    p = SimpleNamespace(output=[str(out)], rrna=None, is_paired=False,
                        args=SimpleNamespace(ensure="none"))
    DistributedParts(p).merge(p)
    assert out.read_bytes() == b"AEBCD"  # 99 < 100001 < 999999 < 1000000 < 1000001
    assert not os.path.exists(parts)


def test_parts_resume_refuses_truncated_part(tmp_path):
    """A parts manifest naming a chunk whose part file was truncated since
    is refused instead of silently merging partial output; skip_chunk's
    contract checks raise."""
    _mk_inputs(tmp_path, n=2000)
    args = _predictor_args(tmp_path, coordinator="127.0.0.1:1", num_hosts=2)
    p = Predictor(ConfigParser.from_json(DEFAULT_CONFIG), args, device="cpu")
    p.load_model()
    # the fields detect() would set, enough for the manifest key
    p.input, p.output, p.rrna = args.input, args.output, None
    p.distributed, p.hosts, p.host_id = True, 2, 0
    p.is_paired = True
    p.batch_size = 1024
    p.chunk_size = 1
    p._resume_buckets = [64, 100]

    parts = DistributedParts(p)
    fhs = parts.open_chunk(p, 0)
    for group in fhs.values():
        for fh in group:
            fh.write(b"@x\nACGT\n+\nIIII\n")
            fh.close()
    parts.complete_chunk(p, 0, 1024, {"norrna": 1024, "rrna": 0, "unclf": 0})

    # intact parts: restore succeeds and reports the completed chunk
    p2 = DistributedParts(p)
    records, counts = p2.restore(p)
    assert p2.chunks_done == 1 and records == 1024
    assert p2.skip_chunk(0) and not p2.skip_chunk(2)
    with pytest.raises(RuntimeError, match="not owned by host"):
        p2.skip_chunk(3)
    with pytest.raises(RuntimeError, match="out of order"):
        p2.skip_chunk(2)

    # truncate one part: restore must refuse loudly
    os.truncate(DistributedParts._part_path(p.output[0], 0), 3)
    with pytest.raises(RuntimeError, match="truncated or removed"):
        DistributedParts(p).restore(p)
