"""Command-line interface.

Flag and behavior parity with ``ribodetector_tpu.cli`` (and through it with
the reference entry points, ribodetector/detect.py:763-809 and
detect_cpu.py:776-825): the same flags, config keys, log lines and output
conventions. ``main`` runs the classify step on the card and fails when no
CUDA device is visible; ``main_cpu`` pins the CPU (the plain
recurrence). --coordinator joins the cooperating hosts into one
``torch.distributed`` gloo group before the Predictor is built (host
counters and barriers only; the outputs go through a shared filesystem).
"""

import argparse
from argparse import RawTextHelpFormatter

from ribodetector_tpu_torch import __version__
from ribodetector_tpu_torch.config import DEFAULT_CONFIG, ConfigParser


def build_arg_parser():
    args = argparse.ArgumentParser(
        description="rRNA sequence detector (PyTorch/CUDA)",
        formatter_class=RawTextHelpFormatter,
    )
    args.add_argument("-c", "--config", default=None, type=str,
                      help="Path of config file")
    args.add_argument("-d", "--deviceid", default=None, type=str,
                      help="Index of the CUDA device to use, or a comma list of indices (a power-of-two\ncount) to split each device batch over several cards. (default: the current device)")
    args.add_argument("-l", "--len", type=int, required=True,
                      help="Sequencing read length. Note: the accuracy reduces for reads shorter than 40.")
    args.add_argument("-i", "--input", default=None, type=str, nargs="*", required=True,
                      help="Path of input sequence files (fasta and fastq), the second file will be considered as second end if two files given.")
    args.add_argument("-o", "--output", default=None, type=str, nargs="*", required=True,
                      help="Path of the output sequence files after rRNAs removal (same number of files as input). \n(Note: 2 times slower to write gz files)")
    args.add_argument("-r", "--rrna", default=None, type=str, nargs="*",
                      help="Path of the output sequence file of detected rRNAs (same number of files as input)")
    args.add_argument("-e", "--ensure", default="none", type=str,
                      choices=["rrna", "norrna", "both", "none"],
                      help="""Ensure which classification has high confidence for paired end reads.
norrna: output only high confident non-rRNAs, the rest are classified as rRNAs;
rrna: vice versa, only high confident rRNAs are classified as rRNA and the rest output as non-rRNAs;
both: both non-rRNA and rRNA prediction with high confidence;
none: give label based on the mean probability of read pair.
      (Only applicable for paired end reads, discard the read pair when their predictions are discordant)""")
    args.add_argument("-t", "--threads", default=10, type=int,
                      help="Number of host threads to use. (default: 10)")
    args.add_argument("-m", "--memory", default=32, type=int,
                      help="Amount (GB) of device RAM for batch sizing. (default: 32)\nHost-side note: the native streaming path additionally keeps a pool of\n~12 parse windows (sized from chunk records; doubled for paired input)\nplus up to -t+4 compression scratch buffers in flight -- typically a few\nhundred MB of host RAM on top of the chunk itself.")
    args.add_argument("--chunk_size", default=None, type=int,
                      help="Use this parameter when having low memory. Parsing the file in chunks.\n{}.\n{}.".format(
                          "Not needed when free RAM >=5 * your_file_size (uncompressed, sum of paired ends)",
                          "When chunk_size=256, memory=16 it will load 256 * 16 * 1024 reads each chunk",
                      ))
    args.add_argument("--log", default=None, type=str, help="Log file name")
    args.add_argument("--profile", action="store_true",
                      help="Log per-stage wall-time breakdown (parse/encode/infer/write) at the end of the run")
    args.add_argument("--trace-dir", default=None, type=str,
                      help="Capture a torch.profiler trace of the run (host ops, and the card's kernels and\ncopies when on the card) into this directory as a Chrome trace JSON")
    args.add_argument("--resume", action="store_true",
                      help="Restartable streaming: after each completed chunk, record every output's\nbyte offset in <output>.progress.json; an interrupted run truncates the\noutputs to the last completed offset and continues from there.")
    args.add_argument("--semantics", default=None, type=str,
                      choices=["dense", "packed"],
                      help="Recurrence/gather semantics to reproduce: dense = reference CPU/ONNX path,\npacked = reference GPU/cuDNN PackedSequence path. (default: config value, dense)")
    args.add_argument("--kernel", default=None, type=str,
                      choices=["auto", "cuda", "plain"],
                      help="Compute kernel: the hand-written CUDA kernel (on the card), the plain\nrecurrence (on the CPU), or auto = whichever the device runs. (default: auto)")
    args.add_argument("--precision", default=None, type=str,
                      choices=["exact", "high", "fast"],
                      help="""Precision of the CUDA kernel:
exact: fp32 recurrence (fp32 FMA, IEEE sigmoid/tanh);
high:  2-limb bf16 split of the recurrent product accumulated in fp32 +
       tanh-form sigmoid, gated at startup by an argmax-parity probe against
       exact (default);
fast:  one bf16 pass (bf16 operands, fp32 accumulate, fp32 state) -- throughput
       over parity.
Under runtime.compute_dtype=bfloat16 in the config, high and fast run the
one-pass kernel with bf16 state. On the CPU the plain recurrence runs in the
compute dtype whatever the precision.""")
    args.add_argument("--buckets", default=None, type=str,
                      help="Length-bucketed batching for variable-length reads: auto (64-step\npadded-T grid up to -l; each read runs the smallest fitting bucket with\nexact full-length semantics via a precomputed backward-carry init), off,\nor a comma list of bucket lengths. (default: auto)")
    args.add_argument("--gz-level", default=None, type=int, choices=range(1, 13),
                      metavar="{1..12}",
                      help="libdeflate compression level for gz outputs on the native path\n(default 3 = the reference's zlib-level-5 ratio at ~3.5x the speed;\n1 = ~2x faster deflate at ~4%% worse ratio -- use when the write stage\nbottlenecks, e.g. many gz outputs on few cores).")
    args.add_argument("--hosts", default=1, type=int,
                      help="Shard the input stream over N cooperating hosts: each host classifies\nits round-robin share of the chunks and writes per-host output shards\n(<name>.hostNNN; gz shards concatenate into a valid gz file).\nRun once per host with a distinct --host-id. (default: 1)")
    args.add_argument("--host-id", default=0, type=int,
                      help="This process's shard index in [0, --hosts). (default: 0)")
    args.add_argument("--coordinator", default=None, type=str,
                      help="host:port of host 0 -- turns the --hosts mode into a coordinated\nmulti-process run (a torch.distributed gloo group over TCP): global summary\ncounts are summed over the group and host 0 concatenates all per-host parts\ninto the final outputs (shared filesystem assumed). Requires --num-hosts\nand --host-id.")
    args.add_argument("--num-hosts", default=None, type=int,
                      help="Total number of cooperating processes for --coordinator mode.")
    args.add_argument("--barrier-timeout", default=3600, type=int,
                      help="Seconds to wait at the end-of-run coordination barrier in\n--coordinator mode before failing with a clear error (a cooperating\nhost likely died; per-chunk parts stay on disk). (default: 3600)")
    args.add_argument("-v", "--version", action="version",
                      version="%(prog)s {version}".format(version=__version__))
    return args



def _run(argv, device):
    args = build_arg_parser().parse_args(argv)
    if args.coordinator is None:
        _detect(args, device)
        return
    # multi-host runtime: one gloo process group, formed before the
    # Predictor is built; rank and world size are the host id and count
    if not args.num_hosts or args.num_hosts < 2:
        raise SystemExit("--coordinator requires --num-hosts >= 2")
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method=f"tcp://{args.coordinator}",
        rank=args.host_id, world_size=args.num_hosts,
    )
    args.hosts = dist.get_world_size()
    args.host_id = dist.get_rank()
    from ribodetector_tpu_torch.parallel.sharded import BarrierTimeout

    try:
        _detect(args, device)
    except BarrierTimeout:
        # a watchdog thread still sits in a collective: tearing the group
        # down under it could hang the exit, so the process leaves it
        raise
    except BaseException:
        dist.destroy_process_group()
        raise
    dist.destroy_process_group()


def _detect(args, device):
    config_file = args.config if args.config is not None else DEFAULT_CONFIG
    config = ConfigParser.from_json(config_file)
    if args.kernel is not None:
        config.config.setdefault("runtime", {})["kernel"] = args.kernel

    from ribodetector_tpu_torch.runtime import Predictor

    seq_pred = Predictor(config, args, device=device)
    seq_pred.load_model()
    seq_pred.detect()


def main(argv=None):
    """Detect on the card (cuda:N with -d N); raises when no CUDA device is
    visible rather than running on the CPU."""
    _run(argv, "cuda")


def main_cpu(argv=None):
    """`ribodetector_cpu` parity entry point: the same engine PINNED to the
    host CPU, running the plain recurrence."""
    _run(argv, "cpu")


if __name__ == "__main__":
    main()
