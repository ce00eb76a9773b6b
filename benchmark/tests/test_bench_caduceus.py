"""The cell this benchmark gained with Caduceus-Ph: its readers on
synthetic records, a CPU rehearsal through run_cell (d_model 16, 2 layers:
the mix's "model_widths"), faults planted in the program under the timed
path, and the control. Each fault, and the control (the reference's scan
with its state and exp in bf16, in the program's place: on the CPU in its
plain scan's, on the card in the kernel's), must turn `correct` false
under the cell's limits; on the card the control runs at its cell's
library shapes (python3 -m pytest benchmark/tests -m cuda -s prints its
compared numbers)."""

import json

import pytest
import torch

from harness import core, work, work_caduceus

TINY_CAD = {"model_widths": {"d_model": 16, "n_layer": 2, "d_state": 4, "dt_rank": 2}}
SEED = 2**31 + 11
CONTROL_SEEDS = (3_300_000_777, 3_300_000_778, 3_300_000_779)

COUNTERS = {"cad.tokens": 800_000, "cad.padded_tokens": 1_000_000, "cad.micro_batches": 9}
UNPROFILED = {"wall_s": 10.0, "calls": 5, "reads": 300_000, "bases": 56_000_000,
              "stages": {"main": {"route": 1.0}, "worker": {}, "counters": COUNTERS}}
PROFILED = {"wall_s": 12.0, "calls": 4, "reads": 240_000, "bases": 45_000_000,
            "stages": {"main": {"route": 1.5}, "worker": {},
                       "counters": {k: v // 2 for k, v in COUNTERS.items()} | {
                           "cad.tokens": 300_000}},
            "trace": {"window_s": 12.0, "busy_s": 10.8, "device_span_s": 11.9,
                      "kernel_s": {"void cad_scan_kernel<16, 16>(...)": 10.0,
                                   "cad_conv_kernel(...)": 2.0, "ampere_bf16_gemm": 2.0,
                                   "void cad_add_norm_kernel<__nv_bfloat16>(...)": 2.0}}}
WANT = {
    "mfu.caduceus": 100 * work_caduceus.flops(56_000_000, 300_000) / (10.0 * 989e12),
    "pad_share.caduceus": 20.0,
    "scan_roofline.caduceus": 100 * work_caduceus.scan_bound_seconds(45_000_000) / 12.0,
    "device_idle.detect": 10.0,
    "norm_roofline.caduceus": 100 * work_caduceus.norm_bound_seconds(45_000_000) / 2.0,
}


def read(name, rec):
    return core.load_module("metrics", name).read(rec)


def split(unprofiled, profiled):
    return {"attempted": 9, "failed": 0,
            "stretches": {"unprofiled": unprofiled, "profiled": profiled},
            **{k: unprofiled[k] + profiled[k] for k in ("wall_s", "reads", "bases")}}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_reads_its_stretch(name):
    assert read(name, split(UNPROFILED, PROFILED)) == pytest.approx(WANT[name])
    assert 0 <= WANT[name] <= 100
    moved = read(name, split(PROFILED, {**UNPROFILED, "trace": {
        **PROFILED["trace"], "busy_s": 6.0, "kernel_s": {"cad_scan_kernel": 19.0, "cad_add_norm_kernel": 3.0}}}))
    assert moved != pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_finds_nothing_where_the_program_has_nothing(name):
    """An untraced record, and a parent's traced record (no cad.* counters,
    no cad_* kernels in its trace: it runs no Caduceus), read nothing."""
    assert read(name, {"wall_s": 1.0, "reads": 10, "bases": 100}) is None or name == "mfu.caduceus"
    bare = {**UNPROFILED, "stages": {"main": {}, "worker": {}}}
    parent = split(bare, {**PROFILED, "trace": {**PROFILED["trace"], "kernel_s": {
        "bilstm_high_kernel": 1.0}}})
    if name in ("mfu.caduceus", "device_idle.detect"):
        assert read(name, parent) is not None
    else:
        assert read(name, parent) is None


def test_scan_bound_is_the_sfu():
    per = work_caduceus.scan_bound_seconds(1) / 32
    assert per == pytest.approx(17_408 / (16 * 132 * 1.98e9))
    assert work_caduceus.FLOPS_PER_BASE / work.FLOPS_PER_BASE == pytest.approx(121.2, abs=0.1)


def run(workload, overrides, trace=0, seed=SEED):
    torch.set_num_threads(2)
    return core.run_cell(["--workload", workload, "--seed", str(seed), "--seconds", "0.1",
                          "--trace", str(trace)], device="cpu", overrides=overrides)


def cad_overrides(pairs=40, **extra):
    lib = core.load_json("traffic", "lib_fa_long_cad.json")["library"]
    lib["pairs"] = pairs
    return {**TINY_CAD, "library": lib, **extra}


def test_caduceus_rehearsal_is_correct_and_traced():
    result = run("detect_cad_l300_fa", cad_overrides(), trace=1)
    assert result["correct"], result["compared"]
    listed = {m["name"] for m in core.load_json("..", "BENCHMARK.json")["per_layer"]
              if "detect_cad_l300_fa" in m.get("workloads", ())}
    # the device's and the deflate pool's (not started at this size) read nothing here
    host = {n for n in listed if "roofline" not in n and n not in (
        "device_idle.detect", "deflate_s_per_mread.detect")}
    assert host <= set(result["metrics"]), host - set(result["metrics"])
    assert set(result["compared"]) == {"layout_faults", "token_faults", "kernel_logit_gap",
                                       "scan_gap", "wrong_file"}
    assert 0 <= result["compared"]["scan_gap"]["value"] < result["compared"]["scan_gap"]["limit"]


def flip_labels(monkeypatch):
    """Every pair in the other file: the program's pair labels inverted."""
    from ribodetector_tpu_torch.runtime import ensure

    orig = ensure.paired_final_labels_torch
    monkeypatch.setattr(ensure, "paired_final_labels_torch",
                        lambda *a, **kw: (1 - orig(*a, **kw)).to(torch.int8))


def change_a_token(monkeypatch):
    """A token row changed on its way to the kernels: each call's first
    read's first base."""
    from ribodetector_tpu_torch.ops import dispatch

    orig = dispatch.unpack_b5_tokens

    def unpack(packed, max_len):
        out = orig(packed, max_len).clone()
        out[0, 0] = (out[0, 0] + 1) % 4
        return out

    monkeypatch.setattr(dispatch, "unpack_b5_tokens", unpack)


def perturb_logits(monkeypatch):
    """The kernels' logits moved by 0.05."""
    import ribodetector_tpu_torch.ops as ops

    orig = ops.classify_logits
    monkeypatch.setattr(ops, "classify_logits", lambda *a, **kw: orig(*a, **kw) + 0.05)


def bf16_scan_state(monkeypatch):
    """The control in the plain scan's place: state and exp in bf16."""
    from harness import control_caduceus
    from ribodetector_tpu_torch.models import caduceus

    monkeypatch.setattr(caduceus, "scan_plain", control_caduceus.scan_plain)


@pytest.mark.parametrize("fault,number", [(flip_labels, "wrong_file"),
                                          (change_a_token, "token_faults"),
                                          (perturb_logits, "kernel_logit_gap"),
                                          (bf16_scan_state, "scan_gap")])
def test_caduceus_fault_makes_run_incorrect(monkeypatch, fault, number):
    fault(monkeypatch)
    result = run("detect_cad_l300_fa", cad_overrides())
    c = result["compared"][number]
    assert result["correct"] is False and c["value"] > c["limit"], result["compared"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", CONTROL_SEEDS)
def test_caduceus_control_on_the_card(seed):
    """The bf16_state control in the scan kernel's place at 2 x 4,096 pairs
    (its scan is a loop of torch ops: the cell's 2 x 32,768 would take
    minutes a call), the check's rows as in the measured runs: it prints
    the control's readings, the upper ones of the limits, and must turn
    `correct` false on scan_gap."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from harness import control_caduceus
    from ribodetector_tpu_torch.ops import caduceus_cuda

    lib = core.load_json("traffic", "lib_fa_long_cad.json")["library"]
    lib["pairs"] = 4096
    caduceus_cuda.reset_launches()
    with control_caduceus.reference_in_place():
        result = core.run_cell(["--workload", "detect_cad_l300_fa", "--seed", str(seed),
                                "--seconds", "0.1", "--trace", "0"], device="cuda",
                               overrides={"library": lib})
    print(json.dumps({"control": "detect_cad_l300_fa", "seed": seed,
                      "compared": {k: c["value"] for k, c in result["compared"].items()}}))
    assert caduceus_cuda.launches("scan") == 0 and caduceus_cuda.launches("conv") > 0
    c = result["compared"]["scan_gap"]
    assert result["correct"] is False and c["value"] > c["limit"], result["compared"]
