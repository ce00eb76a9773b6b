"""The port's converter (models/convert.py) against the JAX package's.

.pth -> npz gives the JAX converter's npz (arrays and metadata); npz ->
.pth -> npz round-trips; the port's .onnx has the JAX export's op types,
opset and float initializers, bit for bit; the CLI derives the same
destination names. Neither `onnx` nor onnxruntime is installed, so the
ModelProto is read with the protobuf walker of tests/test_onnx_export.py,
copied here.
"""

import struct

import numpy as np
import pytest
import torch

from ribodetector_tpu.models import bilstm as jb
from ribodetector_tpu.models import convert as jconvert
from ribodetector_tpu_torch.models import bilstm as tb
from ribodetector_tpu_torch.models import convert as tconvert


def _walk_pb(buf):
    """Yield (field_number, wire_type, value) for one protobuf message."""
    i, n = 0, len(buf)
    while i < n:
        tag = 0
        shift = 0
        while True:
            b = buf[i]
            i += 1
            tag |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        field, wt = tag >> 3, tag & 7
        if wt == 0:  # varint
            v = 0
            shift = 0
            while True:
                b = buf[i]
                i += 1
                v |= (b & 0x7F) << shift
                if not b & 0x80:
                    break
                shift += 7
            yield field, wt, v
        elif wt == 2:  # length-delimited
            ln = 0
            shift = 0
            while True:
                b = buf[i]
                i += 1
                ln |= (b & 0x7F) << shift
                if not b & 0x80:
                    break
                shift += 7
            yield field, wt, buf[i : i + ln]
            i += ln
        elif wt == 5:  # 32-bit
            yield field, wt, buf[i : i + 4]
            i += 4
        elif wt == 1:  # 64-bit
            yield field, wt, buf[i : i + 8]
            i += 8
        else:  # pragma: no cover
            raise ValueError(f"wire type {wt}")


def _onnx_summary(path):
    """(ir_version, opset, n_nodes, op_types, float_initializers) from a
    serialized ModelProto, no onnx package needed."""
    with open(path, "rb") as fh:
        model = fh.read()
    ir_version = None
    opset = None
    graph = None
    for f, wt, v in _walk_pb(model):
        if f == 1 and wt == 0:
            ir_version = v
        elif f == 8 and wt == 2:  # opset_import: OperatorSetIdProto
            for f2, _, v2 in _walk_pb(v):
                if f2 == 2:
                    opset = v2
        elif f == 7 and wt == 2:  # graph
            graph = v
    assert graph is not None
    op_types = []
    inits = []
    for f, wt, v in _walk_pb(graph):
        if f == 1 and wt == 2:  # node
            for f2, _, v2 in _walk_pb(v):
                if f2 == 4:  # op_type
                    op_types.append(v2.decode())
        elif f == 5 and wt == 2:  # initializer: TensorProto
            dtype, raw, floats = None, None, []
            for f2, wt2, v2 in _walk_pb(v):
                if f2 == 2 and wt2 == 0:
                    dtype = v2
                elif f2 == 9 and wt2 == 2:
                    raw = v2
                elif f2 == 4 and wt2 == 2:  # packed float_data
                    floats = np.frombuffer(v2, np.float32)
                elif f2 == 4 and wt2 == 5:
                    floats.append(struct.unpack("<f", v2)[0])
            if dtype == 1:  # FLOAT
                arr = (
                    np.frombuffer(raw, np.float32)
                    if raw is not None
                    else np.asarray(floats, np.float32)
                )
                if arr.size:
                    inits.append(arr)
    return ir_version, opset, op_types, inits


def reference_checkpoint(path, hidden=128, metrics=None):
    """A reference-style .pth: nn.LSTM + Linear state dict (random, seeded)
    beside arch/epoch/batch_size/metrics."""
    torch.manual_seed(hidden)
    rnn = torch.nn.LSTM(4, hidden, 1, batch_first=True, bidirectional=True)
    out = torch.nn.Linear(2 * hidden, 2)
    state = {f"rnn.{k}": v for k, v in rnn.state_dict().items()}
    state.update({f"out.{k}": v for k, v in out.state_dict().items()})
    torch.save({"arch": "SeqModel", "epoch": 7, "batch_size": 200,
                "metrics": metrics or {"val_acc": 0.5, "val_mcc": 0.25},
                "state_dict": state}, path)


def assert_same_npz(a, b):
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            assert za[k].dtype == zb[k].dtype
            np.testing.assert_array_equal(za[k], zb[k])


@pytest.mark.parametrize("hidden", [128, 24])
def test_pth_to_npz_equals_the_jax_converter(tmp_path, hidden):
    pth = str(tmp_path / "ck.pth")
    reference_checkpoint(pth, hidden)
    got = tconvert.convert_checkpoint(pth, str(tmp_path / "port.npz"))
    want = jconvert.convert_checkpoint(pth, str(tmp_path / "jax.npz"))
    assert got == want
    assert got["metrics"] == {"val_acc": 0.5, "val_mcc": 0.25}
    assert_same_npz(tmp_path / "port.npz", tmp_path / "jax.npz")
    assert tb.load_params_meta(str(tmp_path / "port.npz")) == \
        jb.load_params_meta(str(tmp_path / "jax.npz"))
    # a raw state dict converts too
    raw = str(tmp_path / "raw.pth")
    torch.save(torch.load(pth, weights_only=True)["state_dict"], raw)
    tconvert.convert_checkpoint(raw, str(tmp_path / "raw_port.npz"))
    jconvert.convert_checkpoint(raw, str(tmp_path / "raw_jax.npz"))
    assert_same_npz(tmp_path / "raw_port.npz", tmp_path / "raw_jax.npz")
    with pytest.raises(ValueError, match="must end with .npz"):
        tconvert.convert_checkpoint(pth, str(tmp_path / "x.bin"))


def test_numpy_scalars_in_a_pth_are_refused_as_in_jax(tmp_path):
    """torch.load(weights_only=True) refuses a .pth whose metrics hold numpy
    scalars; the port keeps the JAX converter's behaviour."""
    pth = str(tmp_path / "np.pth")
    reference_checkpoint(pth, 16, metrics={"val_acc": np.float64(0.5)})
    errors = []
    for conv in (tconvert, jconvert):
        with pytest.raises(Exception) as e:
            conv.convert_checkpoint(pth, str(tmp_path / "x.npz"))
        errors.append(type(e.value))
    assert errors[0] is errors[1]


def test_npz_to_pth_to_npz_round_trips(tmp_path, ref_params_path):
    port_pth, jax_pth = str(tmp_path / "port.pth"), str(tmp_path / "jax.pth")
    meta = tconvert.export_checkpoint(ref_params_path, port_pth)
    assert meta == jconvert.export_checkpoint(ref_params_path, jax_pth)
    got = torch.load(port_pth, map_location="cpu", weights_only=True)
    want = torch.load(jax_pth, map_location="cpu", weights_only=True)
    assert got.keys() == want.keys() and got["epoch"] == 47
    for k, v in want["state_dict"].items():
        assert torch.equal(got["state_dict"][k], v), k
    back = str(tmp_path / "back.npz")
    tconvert.convert_checkpoint(port_pth, back)
    for name, p in tb.load_params(back)._asdict().items():
        assert torch.equal(p, getattr(tb.load_params(ref_params_path), name))
    meta_back = tb.load_params_meta(back)
    assert meta_back["epoch"] == 47 and meta_back["metrics"] == meta["metrics"]


@pytest.fixture(scope="module")
def onnx_pair(tmp_path_factory, ref_params_path):
    d = tmp_path_factory.mktemp("onnx")
    tconvert.export_onnx(ref_params_path, str(d / "port.onnx"), 100)
    jconvert.export_onnx(ref_params_path, str(d / "jax.onnx"), 100)
    return _onnx_summary(str(d / "port.onnx")), _onnx_summary(str(d / "jax.onnx"))


def test_onnx_export_equals_the_jax_export(onnx_pair):
    (ir, opset, ops, inits), (jir, jopset, jops, jinits) = onnx_pair
    assert opset == jopset == 10 and ir == jir
    assert ops == jops and "LSTM" in ops
    assert len(inits) == len(jinits)
    for a, b in zip(inits, jinits):
        assert a.tobytes() == b.tobytes()  # bit for bit
    assert sum(a.size for a in inits) >= 137730


def test_onnx_export_refuses_a_zero_length(tmp_path, ref_params_path):
    with pytest.raises(ValueError, match="read length must be >= 1"):
        tconvert.export_onnx(ref_params_path, str(tmp_path / "x.onnx"), 0)


def test_converter_cli_derived_names(tmp_path, ref_params_path, capsys):
    import shutil

    pth = tmp_path / "ck.2024" / "model.pth"
    pth.parent.mkdir()
    reference_checkpoint(str(pth), 16)
    tconvert.main([str(pth)])  # .pth -> .npz beside it
    derived = tmp_path / "ck.2024" / "model.npz"
    assert derived.exists()
    assert "wrote " + str(derived) in capsys.readouterr().out
    src = tmp_path / "weights.npz"
    shutil.copy(ref_params_path, src)
    tconvert.main([str(src), "-l", "60"])  # .npz -> .onnx
    _, opset, ops, _ = _onnx_summary(str(tmp_path / "weights.onnx"))
    assert opset == 10 and "LSTM" in ops
    tconvert.main([str(src), str(tmp_path / "w.pth")])
    assert (tmp_path / "w.pth").exists()
    for argv, match in ((["ckpt.pth", "out.onnx"], "npz source"),
                        (["a.npz", "b.npz"], "both .npz"),
                        (["a.pth", "b.pth"], "torch export needs"),
                        (["a.npz", "b.bin"], "unsupported destination")):
        with pytest.raises(SystemExit, match=match):
            tconvert.main(argv)
    with pytest.raises(SystemExit):
        tconvert.main([])
