"""The port's multi-host coordination helpers and its several-card split.

- host_chunk_assignment partitions the chunk stream;
- merge_counts sums counters over a torch.distributed gloo group: unchanged
  without a group, through all_gather in a one-rank group, and exact past
  2**31 in a two-rank group (two processes);
- uncoordinated --hosts 2 shards concatenate to the JAX CLI's one-host
  outputs (--kernel scan), byte for byte;
- the several-card split (-d a,b on the card) runs here over two CPU
  replicas of the model (Predictor(..., replicas=2), a test-only argument)
  and gives the outputs of one replica, and of the JAX CLI, byte for byte,
  with both row slices classified: single-end, paired -e both, and the
  portable runner;
- twins of tests/test_sharding.py's mesh tests and of test_aux.py's
  oversized-mesh check: the port's meshes over explicit device lists (CPU
  replicas, or ranks) against the JAX package's over the 8 virtual CPU
  devices, the row split of P("dp") against JAX's shards, and the sharded
  classifier against one device.

Byte identity with the JAX package rests on every read's JAX-scan margin
being >= 1e-4 (test_torch_cli.py).
"""

import gzip
import json
import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ribodetector_tpu.cli import main as jax_main
from ribodetector_tpu.encode import encode_batch
from ribodetector_tpu.models import bilstm_logits, load_params
from ribodetector_tpu_torch.cli import build_arg_parser, main_cpu
from ribodetector_tpu_torch.config import DEFAULT_CONFIG, ConfigParser
from ribodetector_tpu_torch.parallel import host_chunk_assignment, merge_counts
from ribodetector_tpu_torch.runtime import Predictor
from ribodetector_tpu_torch.runtime.native_pipeline import NativeRunner, card_slices

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _seqs(n, seed, length=60):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(list("ACGT"), size=length)) for _ in range(n)]


def _write(path, seqs, tag="h"):
    with open(path, "w") as fh:
        for i, s in enumerate(seqs):
            fh.write(f"@{tag}{i}\n{s}\n+\n{'I' * len(s)}\n")


def _assert_margins(ref_params_path, seqs, length):
    params = load_params(ref_params_path)
    tok, _ = encode_batch(seqs, length)
    logits = np.asarray(bilstm_logits(params, jnp.asarray(tok)))
    assert np.abs(logits[:, 1] - logits[:, 0]).min() >= 1e-4


def _content(path):
    op = gzip.open if str(path).endswith("gz") else open
    with op(path, "rb") as fh:
        return fh.read()


def test_host_chunk_assignment_partitions():
    owners = [
        [c for c in range(12) if host_chunk_assignment(c, 3, h)] for h in range(3)
    ]
    assert sorted(sum(owners, [])) == list(range(12))
    assert owners[0] == [0, 3, 6, 9]


def test_merge_counts_without_a_group():
    assert merge_counts({"rrna": 3, "norrna": 5}) == {"rrna": 3, "norrna": 5}


def test_merge_counts_one_rank_group():
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            rank=0, world_size=1)
    try:
        got = merge_counts({"rrna": 2**40 + 3, "norrna": 0, "num_read": 7})
    finally:
        dist.destroy_process_group()
    assert got == {"rrna": 2**40 + 3, "norrna": 0, "num_read": 7}


MERGE_RANK = """
import json, sys
import torch.distributed as dist
from ribodetector_tpu_torch.parallel import merge_counts
rank, port = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=2)
per_host = [
    {"num_read": 2**31 + 12345, "rrna": 2**33 + 7, "norrna": 0},
    {"num_read": 2**31 - 1, "rrna": 99, "norrna": 2**31},
]
print(json.dumps(merge_counts(per_host[rank])))
dist.destroy_process_group()
"""


def test_merge_counts_exact_past_int32_two_ranks():
    """Counters ride the gloo all_gather as int64: a two-host sum past
    2**31 comes back exact on both hosts."""
    port = str(_free_port())
    env = {**os.environ, "PYTHONPATH": REPO}
    procs = [subprocess.Popen([sys.executable, "-c", MERGE_RANK, str(r), port],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in (0, 1)]
    outs = [p.communicate(timeout=120) for p in procs]
    want = {"num_read": 2**32 + 12344, "rrna": 2**33 + 106, "norrna": 2**31}
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
        assert json.loads(out.strip().splitlines()[-1]) == want


def test_uncoordinated_host_shards_concatenate_to_jax(tmp_path, ref_params_path):
    """--hosts 2 --host-id k over 4000 reads (2 chunks of 2048 at -m 3
    --chunk_size 1): host k owns chunk k, and the shards, concatenated in
    host order, equal the JAX one-host outputs (gz: a valid multi-member
    file with the same content)."""
    seqs = _seqs(4000, 5)
    _assert_margins(ref_params_path, seqs, 60)
    inp = tmp_path / "in.fq"
    _write(inp, seqs)
    common = ["-l", "60", "-i", str(inp), "-m", "3", "--chunk_size", "1"]
    jax_main([*common, "-o", str(tmp_path / "single.fq"),
              "-r", str(tmp_path / "single.rr.fq.gz"), "--kernel", "scan"])
    for k in range(2):
        main_cpu([*common, "-o", str(tmp_path / "multi.fq"),
                  "-r", str(tmp_path / "multi.rr.fq.gz"),
                  "--hosts", "2", "--host-id", str(k)])
    plain = [tmp_path / f"multi.fq.host{k:03d}" for k in range(2)]
    gz = [tmp_path / f"multi.rr.fq.host{k:03d}.gz" for k in range(2)]
    assert all(f.stat().st_size for f in plain)  # both hosts did work
    assert b"".join(f.read_bytes() for f in plain) == (tmp_path / "single.fq").read_bytes()
    merged = tmp_path / "merged.rr.fq.gz"
    merged.write_bytes(b"".join(f.read_bytes() for f in gz))
    assert _content(merged) == _content(tmp_path / "single.rr.fq.gz")
    assert not (tmp_path / "multi.fq").exists()


def test_card_slices_keep_pairs_together():
    st = np.arange(16, dtype=np.uint8).reshape(8, 2)  # 4 pairs: R1 0-3, R2 4-7
    sl = np.arange(8, dtype=np.int32)
    (t0, l0), (t1, l1) = card_slices(st, sl, 2, paired=True)
    assert [b.tolist() for b in l0] == [[0, 1], [4, 5]]
    assert [b.tolist() for b in l1] == [[2, 3], [6, 7]]
    assert np.array_equal(np.concatenate(t0), st[[0, 1, 4, 5]])
    slices = card_slices(st, sl, 4, paired=False)
    assert [b.tolist() for _, ls in slices for b in ls] == [[0, 1], [2, 3], [4, 5], [6, 7]]


def _run_replicas(argv, replicas, calls=None):
    """The detect CLI's engine on the CPU over `replicas` model replicas;
    with calls, record (card, rows) of every classify launch."""
    args = build_arg_parser().parse_args(argv)
    config = ConfigParser.from_json(args.config or DEFAULT_CONFIG)
    p = Predictor(config, args, device="cpu", replicas=replicas)
    p.load_model()
    assert len(p.devices) == replicas
    assert len({id(x.w_hh_f) for x in p._card_params}) == replicas
    if calls is not None:
        def spy(infers):
            return tuple(
                (lambda *a, _f=f, _k=k: calls.append((_k, a[0].shape[0])) or _f(*a))
                for k, f in enumerate(infers)
            )
        build = p._build_infers
        p._build_infers = lambda *a, **kw: spy(build(*a, **kw))
        p._infer = spy(p._infer)
    p.detect()


@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired_both"])
def test_card_split_matches_one_replica_and_jax(tmp_path, ref_params_path, paired):
    n = 3000
    seqs = [_seqs(n, 31)] + ([_seqs(n, 35, length=50)] if paired else [])
    inputs = []
    for side, s in enumerate(seqs):
        _assert_margins(ref_params_path, s, 60)
        inputs.append(str(tmp_path / f"in{side}.fq"))
        _write(inputs[-1], s, tag="p")

    def flags(tag):
        outs = [str(tmp_path / f"{tag}_o{s}.fq") for s in range(len(inputs))]
        rr = [str(tmp_path / f"{tag}_r{s}.fq.gz") for s in range(len(inputs))]
        return (["-l", "60", "-i", *inputs, "-o", *outs, "-r", *rr, "-m", "3",
                 "--chunk_size", "1"] + (["-e", "both"] if paired else []),
                outs + rr + ([o + ".unclassified.gz" for o in outs] if paired else []))

    jflags, jfiles = flags("jax")
    jax_main([*jflags, "--kernel", "scan"])
    oflags, ofiles = flags("one")
    _run_replicas(oflags, 1)
    calls = []
    tflags, tfiles = flags("two")
    _run_replicas(tflags, 2, calls)
    for j, o, t in zip(jfiles, ofiles, tfiles):
        assert _content(t) == _content(o) == _content(j), t
    assert sum(len(_content(f)) > 0 for f in tfiles) >= 2
    # every batch went to both replicas, each with half its rows (the
    # dispatcher threads may launch in any order)
    rows = {0: [], 1: []}
    for card, r in calls:
        rows[card].append(r)
    assert rows[0] and sorted(rows[0]) == sorted(rows[1])


def test_card_split_portable_runner(tmp_path, ref_params_path):
    """runtime.native=false: each [rows, len] batch splits over the
    replicas and the logits join in row order."""
    seqs = _seqs(700, 33)
    _assert_margins(ref_params_path, seqs, 60)
    inp = tmp_path / "in.fq"
    _write(inp, seqs)
    cfg = json.load(open(DEFAULT_CONFIG))
    cfg["runtime"]["native"] = False
    cfgp = tmp_path / "portable.json"
    cfgp.write_text(json.dumps(cfg))
    base = ["-c", str(cfgp), "-l", "60", "-i", str(inp), "-m", "2"]
    _run_replicas([*base, "-o", str(tmp_path / "one.fq")], 1)
    calls = []
    _run_replicas([*base, "-o", str(tmp_path / "two.fq")], 2, calls)
    assert (tmp_path / "two.fq").read_bytes() == (tmp_path / "one.fq").read_bytes()
    assert {c for c, _ in calls} == {0, 1}


def test_replicas_are_a_cpu_setting():
    args = build_arg_parser().parse_args(["-l", "60", "-i", "x.fq", "-o", "y.fq"])
    with pytest.raises(ValueError, match="CPU-only"):
        Predictor(ConfigParser.from_json(DEFAULT_CONFIG), args, device="cuda",
                  replicas=2)


@pytest.mark.parametrize("ids,match", [("0,1,2", "power of two"),
                                       ("1,1", "names a card twice"),
                                       ("0,x", "not a list of CUDA device")])
def test_card_list_is_checked(monkeypatch, ids, match):
    """-d a,b is checked before any card is touched (a CPU-only host stands
    in for a four-card one)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    args = build_arg_parser().parse_args(["-l", "60", "-i", "x.fq", "-o", "y.fq",
                                          "-d", ids])
    p = Predictor(ConfigParser.from_json(DEFAULT_CONFIG), args, device="cuda")
    with pytest.raises(RuntimeError, match=match):
        p._select_devices()


def test_native_runner_splits_each_device_call(ref_params_path):
    """_device_call_with over two replicas equals one call of one replica on
    a staged pair batch (R1 rows, then R2 rows)."""
    args = build_arg_parser().parse_args(["-l", "60", "-i", "a.fq", "b.fq",
                                          "-o", "x.fq", "y.fq", "-e", "none"])
    preds = []
    for replicas in (1, 2):
        p = Predictor(ConfigParser.from_json(DEFAULT_CONFIG), args, device="cpu",
                      replicas=replicas)
        p.load_model()
        p.is_paired = True
        p.batch_size, p.chunk_size = 256, 1
        preds.append(p)
    from ribodetector_tpu_torch import native

    rng = np.random.default_rng(4)
    tok = rng.integers(0, 5, (2 * 1024, 60)).astype(np.uint8)
    st = native.pack_b5(tok)
    sl = np.full(2 * 1024, 60, np.int32)
    got = []
    for p in preds:
        runner = NativeRunner(p)
        infers = p._build_infers(packed_max_len=60, emit=("pair_labels", "none"))
        got.append(runner._device_call_with(infers, st, sl))
    assert got[0].shape == (1024,)
    assert np.array_equal(got[0], got[1])


# ------------------------------------------------ meshes (parallel/mesh.py)

CPUS = [torch.device("cpu")] * 8


def test_dp_tp_mesh_shapes():
    from ribodetector_tpu.parallel import make_dp_tp_mesh as jax_mesh
    from ribodetector_tpu_torch.parallel import make_dp_tp_mesh

    for n, tp, shape in ((8, 2, (4, 2)), (5, 2, (5, 1)), (8, 4, (2, 4)), (6, 4, (6, 1))):
        mesh = make_dp_tp_mesh(n, tp=tp, devices=CPUS)
        assert mesh.devices.shape == shape == jax_mesh(n, tp=tp).devices.shape
        assert mesh.axis_names == ("dp", "tp") == jax_mesh(n, tp=tp).axis_names
        assert mesh.shape == {"dp": shape[0], "tp": shape[1]}


def test_rank_grid_places_rank_r_as_jax_places_device_r():
    """make_dp_tp_mesh over ranks puts rank r at (r // tp, r % tp), where
    JAX's reshape puts local device r."""
    import jax

    from ribodetector_tpu.parallel import make_dp_tp_mesh as jax_mesh
    from ribodetector_tpu_torch.parallel import make_dp_tp_mesh

    ids = {d: i for i, d in enumerate(jax.local_devices())}
    for tp in (1, 2, 4):
        got = make_dp_tp_mesh(8, tp=tp, devices=range(8)).devices
        want = np.vectorize(ids.get)(jax_mesh(8, tp=tp).devices)
        assert np.array_equal(got.astype(int), want)
        assert all(got[r // tp, r % tp] == r for r in range(8))


def test_oversized_mesh_is_refused():
    """Twin of test_aux.py's make_data_mesh(999) check, with JAX's text."""
    from ribodetector_tpu.parallel.mesh import make_data_mesh as jax_data_mesh
    from ribodetector_tpu_torch.parallel import make_data_mesh, make_dp_tp_mesh

    with pytest.raises(ValueError, match="device") as jax_err:
        jax_data_mesh(999)
    for make in (make_data_mesh, make_dp_tp_mesh):
        with pytest.raises(ValueError) as err:
            make(999, devices=CPUS)
        assert str(err.value) == str(jax_err.value)
    # the visible cards by default: none here
    with pytest.raises(ValueError, match="only 0 local device"):
        make_data_mesh(1)


def test_batch_sharded_rows_are_jax_shards():
    """batch_sharded(mesh, "dp") gives each dp index the rows that
    P("dp") gives its devices; replicated gives every index the whole."""
    import jax

    from ribodetector_tpu.parallel import make_dp_tp_mesh as jax_mesh
    from ribodetector_tpu.parallel.mesh import batch_sharded as jax_batch_sharded
    from ribodetector_tpu_torch.parallel import batch_sharded, make_dp_tp_mesh, replicated

    jmesh = jax_mesh(8, tp=2)
    mesh = make_dp_tp_mesh(8, tp=2, devices=range(8))
    x = np.arange(32) * 3
    arr = jax.device_put(x, jax_batch_sharded(jmesh, "dp"))
    row = {d: i for i, line in enumerate(jmesh.devices) for d in line}
    split = batch_sharded(mesh, "dp")
    for shard in arr.addressable_shards:
        assert np.array_equal(split(x, row[shard.device]), np.asarray(shard.data))
    assert np.array_equal(replicated(mesh)(x, 3), x)
    with pytest.raises(ValueError, match="equal shards"):
        split(x[:30], 0)


def test_sharded_classifier_matches_single_device(ref_params_path):
    from ribodetector_tpu.models import load_params as jax_load
    from ribodetector_tpu.parallel import make_data_mesh as jax_data_mesh
    from ribodetector_tpu.parallel.sharded import make_sharded_classifier as jax_sharded
    from ribodetector_tpu_torch.models import bilstm_logits as plain, load_params as port_load
    from ribodetector_tpu_torch.parallel import make_data_mesh, make_sharded_classifier
    from tests.conftest import random_reads

    seqs = random_reads(np.random.default_rng(368), 64, lmin=20, lmax=50)
    tokens, lengths = encode_batch(seqs, 50)
    params = port_load(ref_params_path)
    tok, ln = torch.from_numpy(tokens), torch.from_numpy(lengths)
    for devices in (make_data_mesh(8, devices=CPUS), CPUS[:2]):
        got = make_sharded_classifier(params, devices)(tok, ln).numpy()
        np.testing.assert_array_equal(got, plain(params, tok).numpy())
    want = np.asarray(jax_sharded(jax_load(ref_params_path), jax_data_mesh(8))(
        jnp.asarray(tokens), jnp.asarray(lengths)))
    np.testing.assert_allclose(got, want, atol=2e-5)
    with pytest.raises(ValueError, match="does not split"):
        make_sharded_classifier(params, CPUS[:3])(tok, ln)
