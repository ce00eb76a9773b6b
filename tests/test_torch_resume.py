"""Restartable streaming (--resume) in the port, against the JAX package.

Twins of tests/test_resume.py: the same inputs (the same numpy seeds), an
interruption made by monkeypatching the port's ResumeState.complete_chunk,
and the port's outputs after resume held byte for byte against the JAX
CLI's uninterrupted run (--kernel scan). Byte identity across the two
packages is well-defined because every read's JAX-scan logit margin is
first checked to be >= 1e-4 (see test_torch_cli.py). Two more cases: a
manifest written by the JAX package, and one naming another build of the
CUDA kernels, are refused.
"""

import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest

from ribodetector_tpu.cli import main as jax_main
from ribodetector_tpu.encode import encode_batch
from ribodetector_tpu.models import bilstm_logits, load_params
from ribodetector_tpu_torch.cli import main_cpu
from ribodetector_tpu_torch.config import DEFAULT_CONFIG
from ribodetector_tpu_torch.runtime.native_pipeline import ResumeState

MARGIN = 1e-4


def fastq_seqs(n, seed, length=60):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(list("ACGT"), size=length)) for _ in range(n)]


def write_fastq(path, n, seed=0):
    with open(path, "w") as fh:
        for i, s in enumerate(fastq_seqs(n, seed)):
            fh.write(f"@q{i}\n{s}\n+\n{'I' * 60}\n")


def assert_margins(ref_params_path, seqs, length):
    """Every read's JAX-scan logit margin is >= MARGIN."""
    params = load_params(ref_params_path)
    for i in range(0, len(seqs), 4096):
        tok, _ = encode_batch(seqs[i : i + 4096], length)
        logits = np.asarray(bilstm_logits(params, jnp.asarray(tok)))
        assert np.abs(logits[:, 1] - logits[:, 0]).min() >= MARGIN


def argv(inp, out, rr, extra=(), length=60):
    args = ["-l", str(length), "-i", str(inp), "-o", str(out)]
    if rr is not None:
        args += ["-r", str(rr)]
    return [*args, "-m", "3", "--chunk_size", "1", *extra]


def jax_run(inp, out, rr, extra=(), length=60):
    jax_main([*argv(inp, out, rr, extra, length), "--kernel", "scan"])


def run(inp, out, rr, extra=(), length=60):
    main_cpu(argv(inp, out, rr, extra, length))


def same(a, b):
    assert a.read_bytes() == b.read_bytes(), (a, b)


def crash_after(monkeypatch, chunk=None, nth=1):
    """ResumeState.complete_chunk that records the chunk, then raises
    KeyboardInterrupt at chunk `chunk` (or at the nth call)."""
    orig = ResumeState.complete_chunk
    calls = {"n": 0}

    def crashing(self, p, ci, fhs, num_read, counts):
        orig(self, p, ci, fhs, num_read, counts)
        calls["n"] += 1
        at = ci == chunk if chunk is not None else calls["n"] == nth
        if at:
            raise KeyboardInterrupt("simulated crash")

    monkeypatch.setattr(ResumeState, "complete_chunk", crashing)
    return orig


@pytest.fixture(scope="module")
def ref9000(tmp_path_factory, ref_params_path):
    """9000 reads of seed 7 (5 chunks of 2048) and the JAX CLI's
    uninterrupted outputs on them."""
    d = tmp_path_factory.mktemp("ref9000")
    assert_margins(ref_params_path, fastq_seqs(9000, 7), 60)
    write_fastq(d / "in.fq", 9000, seed=7)
    jax_run(d / "in.fq", d / "ref.fq", d / "refr.fq")
    return d


def test_resume_complete_run_matches_plain(tmp_path, ref_params_path):
    inp = tmp_path / "in.fq"
    assert_margins(ref_params_path, fastq_seqs(900, 0), 60)
    write_fastq(inp, 900)
    jax_run(inp, tmp_path / "a.fq", tmp_path / "ar.fq")
    run(inp, tmp_path / "b.fq", tmp_path / "br.fq", ["--resume"])
    same(tmp_path / "a.fq", tmp_path / "b.fq")
    same(tmp_path / "ar.fq", tmp_path / "br.fq")
    # manifest cleaned up after success, and no parts were written
    assert not os.path.exists(str(tmp_path / "b.fq") + ".progress.json")
    assert not os.path.exists(str(tmp_path / "b.fq") + ".parts")


def test_resume_after_interruption(tmp_path, monkeypatch, ref_params_path):
    inp = tmp_path / "in.fq"
    assert_margins(ref_params_path, fastq_seqs(1200, 0), 60)
    write_fastq(inp, 1200)
    jax_run(inp, tmp_path / "ref.fq", tmp_path / "refr.fq")
    orig = crash_after(monkeypatch, nth=1)
    with pytest.raises(KeyboardInterrupt):
        run(inp, tmp_path / "c.fq", tmp_path / "cr.fq", ["--resume"])
    monkeypatch.setattr(ResumeState, "complete_chunk", orig)

    manifest = str(tmp_path / "c.fq") + ".progress.json"
    assert json.load(open(manifest))["chunks_done"] == 1

    run(inp, tmp_path / "c.fq", tmp_path / "cr.fq", ["--resume"])
    same(tmp_path / "c.fq", tmp_path / "ref.fq")
    same(tmp_path / "cr.fq", tmp_path / "refr.fq")
    assert not os.path.exists(manifest)


def test_resume_rejects_mismatched_config(tmp_path):
    inp = tmp_path / "in.fq"
    write_fastq(inp, 300)
    manifest = str(tmp_path / "d.fq") + ".progress.json"
    json.dump(
        {"config": {"inputs": ["other.fq"], "len": 60, "ensure": "none",
                    "records_per_chunk": 99},
         "chunks_done": 1, "records_done": 99, "counts": {}},
        open(manifest, "w"),
    )
    with pytest.raises(RuntimeError, match="different run configuration"):
        run(inp, tmp_path / "d.fq", tmp_path / "dr.fq", ["--resume"])


def test_paired_resume_interruption_mixed_record_sizes(tmp_path, monkeypatch,
                                                        ref_params_path):
    """Paired --resume restarts with a record-exact skip on BOTH sides,
    with record sizes that make the two files' byte windows differ."""
    n = 1200
    base = "ACGTTGCA" * 30
    in1, in2 = tmp_path / "r1.fq", tmp_path / "r2.fq"
    s1 = [base[: (30 if i < n // 2 else 180)] for i in range(n)]
    s2 = [base[5:45]] * n
    assert_margins(ref_params_path, sorted(set(s1) | set(s2)), 60)
    with open(in1, "w") as f1, open(in2, "w") as f2:
        for i in range(n):
            f1.write(f"@p{i}\n{s1[i]}\n+\n{'I' * len(s1[i])}\n")
            f2.write(f"@p{i}\n{s2[i]}\n+\n{'I' * len(s2[i])}\n")

    def flags(o1, o2, r1, r2, extra=()):
        return ["-l", "60", "-i", str(in1), str(in2), "-o", str(o1), str(o2),
                "-r", str(r1), str(r2), "-e", "both", "-m", "4",
                "--chunk_size", "1", *extra]

    jax_main([*flags(tmp_path / "a1.fq", tmp_path / "a2.fq",
                     tmp_path / "ar1.fq", tmp_path / "ar2.fq"), "--kernel", "scan"])
    orig = crash_after(monkeypatch, nth=1)
    b = [tmp_path / f for f in ("b1.fq", "b2.fq", "br1.fq", "br2.fq")]
    with pytest.raises(KeyboardInterrupt):
        main_cpu(flags(*b, ["--resume"]))
    monkeypatch.setattr(ResumeState, "complete_chunk", orig)
    main_cpu(flags(*b, ["--resume"]))
    for a, bb in (("a1.fq", "b1.fq"), ("a2.fq", "b2.fq"),
                  ("ar1.fq", "br1.fq"), ("ar2.fq", "br2.fq")):
        same(tmp_path / a, tmp_path / bb)


def test_resume_bucketed_matches_buckets_off(tmp_path, ref_params_path):
    """--resume runs the bucketed engine: at -l 100 the default buckets are
    [64, 100], and the port's bucketed resume run equals the JAX
    buckets-off fresh run byte for byte."""
    inp = tmp_path / "in.fq"
    assert_margins(ref_params_path, fastq_seqs(900, 3), 100)
    write_fastq(inp, 900, seed=3)
    base = ["-l", "100", "-i", str(inp), "-m", "3", "--chunk_size", "1"]
    jax_main(base + ["-o", str(tmp_path / "a.fq"), "-r", str(tmp_path / "ar.fq"),
                     "--buckets", "off", "--kernel", "scan"])
    main_cpu(base + ["-o", str(tmp_path / "b.fq"), "-r", str(tmp_path / "br.fq"),
                     "--resume"])
    same(tmp_path / "a.fq", tmp_path / "b.fq")
    same(tmp_path / "ar.fq", tmp_path / "br.fq")


def test_resume_completion_is_writer_ordered_not_a_barrier(tmp_path, ref9000):
    """The manifest update for chunk N runs on the writer thread (ordered
    after chunk N's writes), not on the main thread, so a resumed run keeps
    DEPTH batches in flight across chunk boundaries."""
    import threading

    inp = tmp_path / "in.fq"
    write_fastq(inp, 5000, seed=7)  # 3 chunks at the 2048-record chunk size
    calls = []
    orig = ResumeState.complete_chunk

    def recording(self, p, ci, fhs, num_read, counts):
        calls.append((ci, threading.current_thread().name, num_read))
        return orig(self, p, ci, fhs, num_read, counts)

    ResumeState.complete_chunk = recording
    try:
        run(inp, tmp_path / "w.fq", tmp_path / "wr.fq", ["--resume"])
    finally:
        ResumeState.complete_chunk = orig
    assert len(calls) >= 2  # multiple chunks
    main = threading.main_thread().name
    assert all(t != main for _, t, _ in calls)
    # manifest completion order and record counts stay cumulative
    assert [c[0] for c in calls] == sorted(c[0] for c in calls)
    assert calls[-1][2] == 5000
    # the first 5000 reads of the 9000-read reference, as a prefix: the
    # outputs hold reads in input order
    ref = (ref9000 / "ref.fq").read_bytes()
    got = (tmp_path / "w.fq").read_bytes()
    assert got and ref.startswith(got)


def test_fasta_resume_after_interruption(tmp_path, monkeypatch, ref_params_path):
    """--resume on native FASTA inputs (records re-emitted as normalized
    text; the offset manifest behaves as for FASTQ)."""
    rng = np.random.default_rng(21)
    inp = tmp_path / "in.fa"
    seqs = ["".join(rng.choice(list("acgtACGT"), size=70)) for _ in range(5000)]
    assert_margins(ref_params_path, [s.upper() for s in seqs], 70)
    with open(inp, "w") as fh:
        for i, s in enumerate(seqs):
            fh.write(f">f{i} desc\n{s[:35]}\n{s[35:]}\n")  # multi-line

    def flags(tag, extra=()):
        return ["-l", "70", "-i", str(inp), "-o", str(tmp_path / f"{tag}.fa"),
                "-r", str(tmp_path / f"{tag}r.fa"), "-m", "3",
                "--chunk_size", "1", *extra]

    jax_main([*flags("ref"), "--kernel", "scan"])
    orig = crash_after(monkeypatch, nth=1)
    with pytest.raises(KeyboardInterrupt):
        main_cpu(flags("res", ["--resume"]))
    monkeypatch.setattr(ResumeState, "complete_chunk", orig)
    main_cpu(flags("res", ["--resume"]))
    same(tmp_path / "res.fa", tmp_path / "ref.fa")
    same(tmp_path / "resr.fa", tmp_path / "refr.fa")
    assert not os.path.exists(str(tmp_path / "res.fa") + ".progress.json")


def test_resume_survives_repeated_crashes(tmp_path, monkeypatch, ref9000):
    """Crash -> resume -> crash again -> resume: a resumed run's manifest is
    itself resumable."""
    inp = ref9000 / "in.fq"
    orig = ResumeState.complete_chunk
    for crash_ci in (0, 2):
        crash_after(monkeypatch, chunk=crash_ci)
        with pytest.raises(KeyboardInterrupt):
            run(inp, tmp_path / "c.fq", tmp_path / "cr.fq", ["--resume"])
        manifest = json.load(open(str(tmp_path / "c.fq") + ".progress.json"))
        assert manifest["chunks_done"] == crash_ci + 1
        monkeypatch.setattr(ResumeState, "complete_chunk", orig)
    run(inp, tmp_path / "c.fq", tmp_path / "cr.fq", ["--resume"])
    same(tmp_path / "c.fq", ref9000 / "ref.fq")
    same(tmp_path / "cr.fq", ref9000 / "refr.fq")
    assert not os.path.exists(str(tmp_path / "c.fq") + ".progress.json")


def test_resume_rejects_changed_label_settings(tmp_path, monkeypatch):
    """Resuming with a different --semantics, or with the rrna output
    dropped, is refused; unchanged settings resume."""
    inp = tmp_path / "in.fq"
    write_fastq(inp, 5000, seed=13)
    orig = crash_after(monkeypatch, nth=1)
    with pytest.raises(KeyboardInterrupt):
        run(inp, tmp_path / "e.fq", tmp_path / "er.fq",
            ["--resume", "--semantics", "dense"])
    monkeypatch.setattr(ResumeState, "complete_chunk", orig)
    with pytest.raises(RuntimeError, match="different run configuration"):
        run(inp, tmp_path / "e.fq", tmp_path / "er.fq",
            ["--resume", "--semantics", "packed"])
    with pytest.raises(RuntimeError, match="different run configuration"):
        run(inp, tmp_path / "e.fq", None, ["--resume", "--semantics", "dense"])
    run(inp, tmp_path / "e.fq", tmp_path / "er.fq",
        ["--resume", "--semantics", "dense"])


def test_resume_refuses_tampered_output(tmp_path, monkeypatch):
    """An output shorter than the manifest's recorded offset is refused
    (truncating would zero-extend it)."""
    inp = tmp_path / "in.fq"
    write_fastq(inp, 5000, seed=17)
    orig = crash_after(monkeypatch, nth=1)
    with pytest.raises(KeyboardInterrupt):
        run(inp, tmp_path / "t.fq", tmp_path / "tr.fq", ["--resume"])
    monkeypatch.setattr(ResumeState, "complete_chunk", orig)
    (tmp_path / "t.fq").write_bytes(b"tiny")  # shorter than the offset
    with pytest.raises(RuntimeError, match="shorter than the manifest"):
        run(inp, tmp_path / "t.fq", tmp_path / "tr.fq", ["--resume"])


def test_resume_refuses_changed_weights(tmp_path, monkeypatch):
    """The manifest records a digest of the port's weights: another
    checkpoint at the same path is refused."""
    inp = tmp_path / "in.fq"
    write_fastq(inp, 5000, seed=19)
    ck = tmp_path / "w.npz"
    shutil.copy(os.path.join(os.path.dirname(DEFAULT_CONFIG), "data",
                             "ribodetector_v1.npz"), ck)
    cfg = json.load(open(DEFAULT_CONFIG))
    cfg["state_file"] = {"mcc": str(ck), "recall": str(ck)}
    cfgp = tmp_path / "cfg.json"
    json.dump(cfg, open(cfgp, "w"))
    flags = ["-c", str(cfgp), *argv(inp, tmp_path / "o.fq", None, ["--resume"])]
    orig = crash_after(monkeypatch, nth=1)
    with pytest.raises(KeyboardInterrupt):
        main_cpu(flags)
    monkeypatch.setattr(ResumeState, "complete_chunk", orig)
    # another model at the same path
    with np.load(ck) as z:
        other = {k: z[k] + np.float32(0.01) for k in z.files}
    np.savez(ck, **other)
    with pytest.raises(RuntimeError, match="different run configuration"):
        main_cpu(flags)


def test_resume_refuses_foreign_manifests(tmp_path, monkeypatch, ref9000):
    """A manifest written by the JAX package (kernel "scan") is refused by
    the port, and so is one of the port that names another build of the
    CUDA kernels; the port's own manifest then resumes to the JAX
    reference."""
    from ribodetector_tpu.runtime import native_pipeline as jax_np

    inp = ref9000 / "in.fq"
    out, rr = tmp_path / "j.fq", tmp_path / "jr.fq"
    orig_jax = jax_np.ResumeState.complete_chunk

    def jax_crashing(self, p, ci, fhs, num_read, counts):
        orig_jax(self, p, ci, fhs, num_read, counts)
        raise KeyboardInterrupt("simulated crash")

    monkeypatch.setattr(jax_np.ResumeState, "complete_chunk", jax_crashing)
    with pytest.raises(KeyboardInterrupt):
        jax_run(inp, out, rr, ["--resume"])
    monkeypatch.setattr(jax_np.ResumeState, "complete_chunk", orig_jax)
    manifest = str(out) + ".progress.json"
    assert json.load(open(manifest))["config"]["kernel"] == "scan"
    with pytest.raises(RuntimeError, match="different run configuration.*kernel"):
        run(inp, out, rr, ["--resume"])

    # the port's own manifest, edited to name another kernel build
    os.remove(manifest)
    orig = crash_after(monkeypatch, nth=1)
    with pytest.raises(KeyboardInterrupt):
        run(inp, out, rr, ["--resume"])
    monkeypatch.setattr(ResumeState, "complete_chunk", orig)
    m = json.load(open(manifest))
    assert m["config"]["kernel"] == "plain"
    kept = json.dumps(m)
    m["config"].update(kernel="cuda", kernel_mode="high", kernel_build="0" * 16)
    json.dump(m, open(manifest, "w"))
    with pytest.raises(RuntimeError, match="kernel_build"):
        run(inp, out, rr, ["--resume"])
    with open(manifest, "w") as fh:
        fh.write(kept)
    run(inp, out, rr, ["--resume"])
    same(out, ref9000 / "ref.fq")
    same(rr, ref9000 / "refr.fq")


def test_resolved_kernel_names_the_build():
    """On the card the manifest key holds the CUDA kernel the precision
    runs and the kernel library's build key (no nvcc needed to read it)."""
    from types import SimpleNamespace

    from ribodetector_tpu_torch.ops.build import kernel_library_key
    from ribodetector_tpu_torch.runtime.native_pipeline import resolved_kernel

    card = SimpleNamespace(kernel="cuda", precision_mode="high",
                           compute_dtype="float32")
    assert resolved_kernel(card) == {"kernel": "cuda", "kernel_mode": "high",
                                     "kernel_build": kernel_library_key()}
    card.compute_dtype = "bfloat16"
    assert resolved_kernel(card)["kernel_mode"] == "fast_bf16"
    cpu = SimpleNamespace(kernel="plain", precision_mode="high",
                          compute_dtype="float32")
    assert resolved_kernel(cpu) == {"kernel": "plain", "kernel_mode": None,
                                    "kernel_build": None}



@pytest.fixture(scope="module")
def ref10000(tmp_path_factory, ref_params_path):
    """10000 reads of seed 23 at -m 4 (4096-record chunks: 4096, 4096 and
    a last chunk of 1808) and the JAX CLI's uninterrupted outputs on
    them."""
    d = tmp_path_factory.mktemp("ref10000")
    assert_margins(ref_params_path, fastq_seqs(10000, 23), 60)
    write_fastq(d / "in.fq", 10000, seed=23)
    jax_run(d / "in.fq", d / "ref.fq", d / "refr.fq", ["-m", "4"])
    return d


def records_in(path, end=None):
    with open(path, "rb") as fh:
        return fh.read(end).count(b"\n") // 4


@pytest.mark.parametrize("layout", ["resume", "coordinated"])
def test_chunk_of_several_write_parts_resumes(tmp_path, monkeypatch, ref10000,
                                              layout):
    """The input's last chunk written in parts (LADDER_MIN lowered so that
    -m 4's 4096-record chunks cut parts of 1024): a run cut after a
    completed chunk resumes to the JAX reference's outputs, and every
    manifest, when written, names only chunks whose every part is on disk.
    "resume" is cut after chunk 1, so that the resumed run writes the last
    chunk in two parts. "coordinated" is the --coordinator parts layout:
    its two hosts run one after the other in this process (the group's
    barriers left out, the merge called after both); host 0, which owns
    chunks 0 and 2, is cut after chunk 0 and relaunched with --resume."""
    from types import SimpleNamespace

    from ribodetector_tpu_torch.cli import _detect, build_arg_parser
    from ribodetector_tpu_torch.runtime.native_pipeline import (
        DistributedParts,
        NativeRunner,
    )
    from ribodetector_tpu_torch.runtime.pipeline import Predictor

    monkeypatch.setattr(NativeRunner, "LADDER_MIN", 64)
    inp, out, rr = ref10000 / "in.fq", tmp_path / "p.fq", tmp_path / "pr.fq"
    parts_written, checked = {}, []  # checked: (chunk, parts, records, on disk)
    write = NativeRunner._write_chunk_bucketed

    def counting_write(self, acc):
        parts_written[acc.ci] = parts_written.get(acc.ci, 0) + 1
        return write(self, acc)

    monkeypatch.setattr(NativeRunner, "_write_chunk_bucketed", counting_write)
    if layout == "resume":
        owner, complete = ResumeState, ResumeState.complete_chunk

        def checking(self, p, ci, fhs, num_read, counts):
            complete(self, p, ci, fhs, num_read, counts)
            offsets = json.load(open(self.manifest_path))["offsets"]
            checked.append((ci, parts_written[ci], num_read,
                            sum(records_in(f, end) for f, end in offsets.items())))

        def launch(extra=(), host=None):
            run(inp, out, rr, ["-m", "4", *extra])
    else:
        owner, complete = DistributedParts, DistributedParts.complete_chunk

        def checking(self, p, ci, num_read, counts):
            complete(self, p, ci, num_read, counts)
            checked.append((ci, parts_written[ci], min(4096, 10000 - 4096 * ci),
                            sum(records_in(self._part_path(str(f), ci))
                                for f in (out, rr))))

        def launch(extra=(), host=0):
            args = build_arg_parser().parse_args(
                [*argv(inp, out, rr, ["-m", "4", *extra]), "--coordinator",
                 "127.0.0.1:1", "--num-hosts", "2", "--host-id", str(host)])
            args.hosts = 2
            _detect(args, "cpu")

        monkeypatch.setattr(Predictor, "_finalize_distributed", lambda self: None)

    def crashing(self, p, ci, *a):
        checking(self, p, ci, *a)
        if ci == (1 if layout == "resume" else 0):
            raise KeyboardInterrupt("simulated crash")

    monkeypatch.setattr(owner, "complete_chunk", crashing)
    with pytest.raises(KeyboardInterrupt):
        launch(["--resume"])
    monkeypatch.setattr(owner, "complete_chunk", checking)
    parts_written.clear()  # the cut run may have begun a later chunk
    launch(["--resume"])
    if layout == "coordinated":
        launch(["--resume"], host=1)
        p = SimpleNamespace(output=[str(out)], rrna=[str(rr)], is_paired=False,
                            args=SimpleNamespace(ensure="none"))
        DistributedParts(p).merge(p)
    same(out, ref10000 / "ref.fq")
    same(rr, ref10000 / "refr.fq")
    # every chunk's manifest once, each naming only records on disk; the
    # last chunk written in two parts, the others whole
    assert sorted(c[0] for c in checked) == [0, 1, 2]
    assert {ci: parts for ci, parts, _, _ in checked} == {0: 1, 1: 1, 2: 2}
    assert all(want == got for _, _, want, got in checked), checked
