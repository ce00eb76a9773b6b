"""The port's two read classifiers: the BiLSTM (models/bilstm.py, the
published RiboDetector model) and Caduceus-Ph (models/caduceus.py, imported
only where a Caduceus is loaded). A config's ``arch.type`` names one of
ARCHS; the npz's ``_meta_json`` names a Caduceus ("arch": "CaduceusParams"),
and any other npz holds a BiLSTM."""

import sys

from ribodetector_tpu_torch.models import bilstm as _bilstm
from ribodetector_tpu_torch.models.bilstm import (
    BiLSTM,
    BiLSTMParams,
    describe,
    init_params,
    load_params_meta,
    param_count,
    params_from_numpy,
    reference_param_count,
    save_params,
    bilstm_logits,
    dense_gather_index,
    zero_prefix_state,
)

ARCHS = ("BiLSTMParams", "CaduceusParams")


def arch_of(path) -> str:
    """The arch an npz file holds, by its ``_meta_json``: a Caduceus where it
    says so, else the BiLSTM (whose files carry free-form metadata, or
    none, or bytes that are not JSON)."""
    try:
        meta = load_params_meta(path)
    except ValueError:  # undecodable metadata names no Caduceus
        return "BiLSTMParams"
    return "CaduceusParams" if meta.get("arch") == "CaduceusParams" else "BiLSTMParams"


def check_arch(arch):
    if arch not in ARCHS:
        raise ValueError(f"unknown arch.type {arch!r} (choose from {ARCHS})")
    return arch


def load_params(path, device="cpu", arch=None):
    """The parameters an npz holds, on `device`. With `arch` (a config's
    arch.type) the file must hold that arch: a mismatch or an unknown type
    raises, and nothing falls back to the BiLSTM."""
    found = arch_of(path)
    if arch is not None and check_arch(arch) != found:
        raise ValueError(f"the config's arch.type is {arch} but {path} holds "
                         f"{found} weights (its _meta_json)")
    if found == "CaduceusParams":
        from ribodetector_tpu_torch.models import caduceus

        return caduceus.load_params(path, device)
    return _bilstm.load_params(path, device)


def is_caduceus(params) -> bool:
    """True for CaduceusParams; a check that imports nothing (no Caduceus
    exists before its module is loaded)."""
    mod = sys.modules.get("ribodetector_tpu_torch.models.caduceus")
    return mod is not None and isinstance(params, mod.CaduceusParams)


__all__ = [
    "ARCHS",
    "BiLSTM",
    "BiLSTMParams",
    "arch_of",
    "check_arch",
    "describe",
    "init_params",
    "is_caduceus",
    "load_params",
    "load_params_meta",
    "param_count",
    "params_from_numpy",
    "reference_param_count",
    "save_params",
    "bilstm_logits",
    "dense_gather_index",
    "zero_prefix_state",
]
