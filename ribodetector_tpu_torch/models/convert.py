"""Convert the reference torch checkpoint to the native .npz parameter artifact.

Counterpart of ``ribodetector_tpu/models/convert.py`` (itself the
counterpart of the reference's ONNX export tool, reference:
ribodetector/convert_onnx.py:20-54): it degates the torch state dict once
into the layout of models/bilstm.py, exports an npz back to the
reference's .pth layout, or exports it to ONNX. The npz is the JAX
package's format, so either package reads what this one writes.

torch nn.LSTM state dict layout (reference checkpoint
ribodetector_600k_variable_len70_101_epoch47.pth, fp32, gate order i,f,g,o):

  rnn.weight_ih_l0 [512, 4], rnn.weight_hh_l0 [512, 128],
  rnn.bias_ih_l0 / rnn.bias_hh_l0 [512,], the same *_reverse set,
  out.weight [2, 256], out.bias [2,]

Usage:
  python -m ribodetector_tpu_torch.models.convert <checkpoint.pth> <out.npz>
  python -m ribodetector_tpu_torch.models.convert <in.npz> <out.pth>
  python -m ribodetector_tpu_torch.models.convert <in.npz> <out.onnx> [read_len]

export_onnx traces an ``nn.LSTM`` module: that module is the exported graph,
not a compute path of this package.
"""

import sys

import numpy as np


def state_dict_to_arrays(state_dict) -> dict:
    """Map torch tensors/ndarrays (state-dict layout) to the native layout."""

    def a(key):
        v = state_dict[key]
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        return np.asarray(v, dtype=np.float32)

    return dict(
        w_ih_f=a("rnn.weight_ih_l0").T.copy(),
        w_hh_f=a("rnn.weight_hh_l0").T.copy(),
        b_f=a("rnn.bias_ih_l0") + a("rnn.bias_hh_l0"),
        w_ih_b=a("rnn.weight_ih_l0_reverse").T.copy(),
        w_hh_b=a("rnn.weight_hh_l0_reverse").T.copy(),
        b_b=a("rnn.bias_ih_l0_reverse") + a("rnn.bias_hh_l0_reverse"),
        w_out=a("out.weight").T.copy(),
        b_out=a("out.bias"),
    )


def convert_checkpoint(pth_path: str, npz_path: str) -> dict:
    """Load a torch .pth checkpoint and write the .npz artifact.

    Accepts both a raw state dict and the reference's full checkpoint dict
    (keys arch/epoch/state_dict/metrics/..., detect.py:101,115-116).
    Returns the metadata dict stored alongside the weights.
    """
    import torch

    from ribodetector_tpu_torch.models.bilstm import params_from_numpy, save_params

    if not npz_path.endswith(".npz"):
        # np.savez silently appends ".npz"; fail instead of reporting a
        # path that will not exist
        raise ValueError(f"destination must end with .npz, got {npz_path!r}")
    state = torch.load(pth_path, map_location="cpu", weights_only=True)
    meta = {"source_checkpoint": str(pth_path)}
    if isinstance(state, dict) and "state_dict" in state:
        for k in ("arch", "epoch", "batch_size", "metrics"):
            if k in state:
                meta[k] = state[k]
        state_dict = state["state_dict"]
    else:
        state_dict = state

    # ONE writer of the artifact format: bilstm.save_params owns the
    # _meta_json embedding
    save_params(npz_path, params_from_numpy(state_dict_to_arrays(state_dict)), meta)
    return meta


def arrays_to_state_dict(params) -> dict:
    """Inverse of state_dict_to_arrays: native layout -> torch nn.LSTM
    state-dict layout (gate order i,f,g,o). The native artifact stores the
    SUM of torch's redundant bias pair, so the export puts the whole bias
    in bias_ih_l0* and zeros in bias_hh_l0* -- functionally identical
    (the LSTM cell only ever uses their sum)."""

    def t(x):
        # every exported tensor owns writable storage (the .T.copy()s
        # already did; biases need it too), whatever the input shares
        return np.array(x, dtype=np.float32)

    out = {
        "rnn.weight_ih_l0": t(params.w_ih_f).T.copy(),
        "rnn.weight_hh_l0": t(params.w_hh_f).T.copy(),
        "rnn.bias_ih_l0": t(params.b_f),
        "rnn.bias_hh_l0": np.zeros_like(t(params.b_f)),
        "rnn.weight_ih_l0_reverse": t(params.w_ih_b).T.copy(),
        "rnn.weight_hh_l0_reverse": t(params.w_hh_b).T.copy(),
        "rnn.bias_ih_l0_reverse": t(params.b_b),
        "rnn.bias_hh_l0_reverse": np.zeros_like(t(params.b_b)),
        "out.weight": t(params.w_out).T.copy(),
        "out.bias": t(params.b_out),
    }
    return out


def export_checkpoint(npz_path: str, pth_path: str) -> dict:
    """Export a native .npz artifact back to a torch .pth state dict, the
    layout the reference's tooling consumes (detect.py:101,115-116,
    convert_onnx.py:29-31) -- so weights trained here can round-trip into
    the reference or its ONNX exporter."""
    import torch

    from ribodetector_tpu_torch.models.bilstm import load_params, load_params_meta

    params = load_params(npz_path)
    state = {k: torch.from_numpy(v) for k, v in arrays_to_state_dict(params).items()}
    meta = load_params_meta(npz_path)
    # metadata goes TOP-LEVEL like the reference checkpoint layout
    # (arch/epoch/metrics next to state_dict, detect.py:101) -- that is
    # also what convert_checkpoint reads back, so npz -> pth -> npz
    # round-trips keep it (a nested 'meta' key used to drop it silently)
    payload = {
        k: v for k, v in (meta or {}).items() if k != "state_dict"
    }
    payload["state_dict"] = state
    torch.save(payload, pth_path)
    return meta


def export_onnx(npz_path: str, onnx_path: str, read_len: int = 100) -> None:
    """Export a native .npz artifact to a portable .onnx file -- the
    reference converter's actual output format (reference:
    ribodetector/convert_onnx.py:20-54: model_cpu.SeqModel traced at
    [1, read_len, 4], opset 10, dynamic batch + sequence axes, tensor
    names input/output).

    The graph is the dense/ONNX forward (model_cpu.py:29-37,57-62): full
    bidirectional LSTM over the padded input, output gathered at the last
    nonzero input row. torch's TorchScript exporter produces the complete
    serialized ModelProto in C++; the `onnx` python package is only
    consulted for onnxscript custom functions (none here), so when it is
    absent we skip that no-op pass instead of failing.
    """
    import contextlib

    import torch
    import torch.nn as nn

    from ribodetector_tpu_torch.models.bilstm import load_params

    if read_len < 1:
        raise ValueError(
            f"read length must be >= 1 to trace the ONNX graph, got {read_len}"
        )
    params = load_params(npz_path)
    hidden = int(np.asarray(params.w_hh_f).shape[0])  # width-generic:
    # custom --hidden checkpoints export too, not just the reference 128

    class SeqModel(nn.Module):
        def __init__(self):
            super().__init__()
            self.rnn = nn.LSTM(4, hidden, 1, batch_first=True, bidirectional=True)
            self.out = nn.Linear(2 * hidden, 2)

        def forward(self, x):
            r_out, _ = self.rnn(x)
            # last nonzero input row (model_cpu.py:57-62)
            g = x.size(1) - 1 - x.sum(2).flip(1).argmax(1)
            return self.out(r_out[torch.arange(x.size(0)), g, :])

    model = SeqModel()
    state = arrays_to_state_dict(params)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    model.eval()

    @contextlib.contextmanager
    def _onnxscript_pass_optional():
        # only the import probe may be caught: an ImportError raised inside
        # the export itself must propagate (wrapping the yield would make
        # the generator yield twice and mask it with a RuntimeError)
        try:
            import onnx  # noqa: F401

            have_onnx = True
        except ImportError:
            have_onnx = False
        if have_onnx:
            yield  # real pass available
            return
        try:
            from torch.onnx._internal.torchscript_exporter import onnx_proto_utils

            orig = onnx_proto_utils._add_onnxscript_fn
        except (ImportError, AttributeError) as e:
            # the private-module layout (module OR helper name) moves across
            # torch releases; fall through to the actionable fix instead of
            # leaking the internal failure
            raise RuntimeError(
                "ONNX export without the 'onnx' package relies on a private "
                "torch module that this torch version does not expose; "
                "install the 'onnx' package (pip install onnx) and retry"
            ) from e

        onnx_proto_utils._add_onnxscript_fn = lambda proto, custom_opsets: proto
        try:
            yield
        finally:
            onnx_proto_utils._add_onnxscript_fn = orig

    dummy = torch.zeros(1, read_len, 4, dtype=torch.float32)
    with _onnxscript_pass_optional():
        torch.onnx.export(
            model,
            (dummy,),
            onnx_path,
            dynamo=False,
            opset_version=10,
            input_names=["input"],
            output_names=["output"],
            dynamic_axes={
                "input": {0: "batch_size", 1: "sequence_len"},
                "output": {0: "batch_size"},
            },
        )


def main(argv=None):
    """CLI matching the reference converter's shape (a positional source
    plus -l/--length, reference: ribodetector/convert_onnx.py:20-23) with
    the destination inferred from the source when omitted:

      convert <x.pth>                  -> x.npz        (degate to native)
      convert <x.npz> -l 100           -> x.onnx       (reference's output)
      convert <src> <dst> [read_len]   -> explicit destination by extension
    """
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m ribodetector_tpu_torch.models.convert",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("src", help="source artifact (.pth or .npz)")
    p.add_argument(
        "dst",
        nargs="?",
        default=None,
        help="destination (.npz/.pth/.onnx); default: src with .pth->.npz, "
        ".npz->.onnx (the reference converter's derived-name behavior)",
    )
    p.add_argument(
        "read_len_pos",
        nargs="?",
        type=int,
        default=None,
        metavar="read_len",
        help="positional alias for --length (onnx export trace length)",
    )
    p.add_argument(
        "-l",
        "--length",
        type=int,
        default=None,
        help="input read length used to trace the ONNX graph (default 100; "
        "reference: convert_onnx.py:22)",
    )
    args = p.parse_args(argv if argv is not None else sys.argv[1:])

    src, dst = args.src, args.dst
    if dst is None:
        import os

        # splitext, NOT rsplit('.', 1): a dot in a DIRECTORY name must not
        # truncate the path ('ckpts.2024/model' -> 'ckpts.2024/model.npz',
        # not 'ckpts.npz' in the CWD)
        stem = os.path.splitext(src)[0]
        dst = stem + (".onnx" if src.endswith(".npz") else ".npz")
    length = args.length if args.length is not None else args.read_len_pos
    # validate the (source, destination) pair before dispatching: feeding a
    # torch pickle to np.load (or writing one under a .npz name) produces
    # cryptic downstream failures
    if dst.endswith(".onnx"):
        if not src.endswith(".npz"):
            raise SystemExit(
                f"ONNX export needs a native .npz source (got {src!r}); "
                "convert the checkpoint first: convert <ckpt.pth> <out.npz>"
            )
        export_onnx(src, dst, length if length is not None else 100)
        meta = {"opset": 10, "dynamic_axes": ["batch_size", "sequence_len"]}
    elif dst.endswith(".pth"):
        if not src.endswith(".npz"):
            raise SystemExit(
                f"torch export needs a native .npz source, got {src!r}"
            )
        meta = export_checkpoint(src, dst)
    elif dst.endswith(".npz"):
        if src.endswith(".npz"):
            raise SystemExit("source and destination are both .npz")
        meta = convert_checkpoint(src, dst)
    else:
        raise SystemExit(
            f"unsupported destination {dst!r}: expected .npz, .pth or .onnx"
        )
    print("wrote", dst, "meta:", meta)


if __name__ == "__main__":
    main()
