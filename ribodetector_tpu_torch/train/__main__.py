"""Training CLI: (re)train the BiLSTM read classifier from labeled files.

Counterpart of ``python -m ribodetector_tpu.train`` with the same flags and
messages: rRNA reads (label 1) and non-rRNA reads (label 0) come from
separate FASTA/FASTQ files (plain or gz), and checkpoints are npz artifacts
that load straight into either package's detect engine (--config
state_file) or export to the reference's torch layout via models.convert.

``main`` trains on the card and raises when no CUDA device is visible.
With one card it trains on the current CUDA device, and --tp has no
effect, as the JAX CLI builds no mesh on one device. With n > 1 cards it
trains on every card, as the JAX CLI meshes over every local device: one
process per card (the spawn start method), joined in an NCCL group on
127.0.0.1, on a (dp, tp) grid of n // tp x tp ranks (tp falls back to 1
when it does not divide n); batches split over dp and the gate columns
over tp (train/trainer.py). A worker that fails stops the others, and
main raises. ``main_cpu`` pins the CPU, in one process.

  python -m ribodetector_tpu_torch.train --rrna rrna.fa --norrna mrna.fa \\
      -l 100 --epochs 5 --batch 200 --out ckpts/
"""

import argparse
import socket
from datetime import timedelta

import numpy as np

# how long a rank waits in a collective (or for its peers to join) before
# it raises: a dead peer fails the run instead of hanging it
COLLECTIVE_TIMEOUT = timedelta(minutes=10)


def build_arg_parser():
    ap = argparse.ArgumentParser(
        prog="ribodetector_tpu_torch.train",
        description="Train the rRNA/non-rRNA BiLSTM classifier",
    )
    ap.add_argument("--rrna", required=True,
                    help="FASTA/FASTQ(.gz) of rRNA reads (label 1)")
    ap.add_argument("--norrna", required=True,
                    help="FASTA/FASTQ(.gz) of non-rRNA reads (label 0)")
    ap.add_argument("--val-rrna", default=None)
    ap.add_argument("--val-norrna", default=None)
    ap.add_argument("-l", "--len", type=int, default=100,
                    help="max read length (truncate/pad policy of the engine)")
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--batch", type=int, default=200,
                    help="train batch size (reference checkpoint used 200)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--weight-decay", type=float, default=0.0)
    ap.add_argument("--semantics", choices=["dense", "packed"], default="dense")
    ap.add_argument("--hidden", type=int, default=None,
                    help="LSTM hidden width (default 128, the reference arch; "
                    "custom widths run the engine's plain recurrence). "
                    "Incompatible with --init, whose checkpoint fixes the width.")
    ap.add_argument("--init", default=None,
                    help=".npz to fine-tune from (default: random init)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", required=True,
                    help="checkpoint directory (per-epoch .npz + best.npz)")
    ap.add_argument("--monitor", default="mcc",
                    help="eval metric tracked by best.npz (default: mcc)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel width over the gate dimension")
    return ap


def _load_labeled(rrna_path, norrna_path, max_len, seed):
    from ribodetector_tpu_torch.encode import encode_batch
    from ribodetector_tpu_torch.io import load_reads

    seqs, labels = [], []
    for path, label in ((norrna_path, 0), (rrna_path, 1)):
        reads = load_reads(path)
        seqs.extend(r[1] for r in reads)
        labels.extend([label] * len(reads))
    tokens, lengths = encode_batch(seqs, max_len)
    labels = np.asarray(labels, np.int32)
    perm = np.random.default_rng(seed).permutation(len(labels))
    return tokens[perm], lengths[perm], labels[perm]


VALID_MONITORS = {"loss": "loss", "acc": "acc", "recall": "recall",
                  "precision": "precision", "f1": "F1", "mcc": "mcc"}


def _parse(argv):
    """The parsed flags and the monitor's metric name; flag misuse exits
    through argparse."""
    ap = build_arg_parser()
    args = ap.parse_args(argv)
    if bool(args.val_rrna) != bool(args.val_norrna):
        ap.error("--val-rrna and --val-norrna must be given together")
    monitor = VALID_MONITORS.get(args.monitor.lower())
    if monitor is None:
        ap.error(f"--monitor must be one of {sorted(VALID_MONITORS)}")
    if args.init and args.hidden is not None:
        ap.error("--hidden cannot be combined with --init: the "
                 "checkpoint fixes the width")
    return args, monitor


def _train(argv, device, grid=None):
    """The CLI on `device` ("cuda": the current CUDA device), alone or, with
    a grid, as one rank of a multi-device run (rank 0 prints)."""
    args, monitor = _parse(argv)
    say = print if grid is None or grid.rank == 0 else (lambda *a, **k: None)

    import torch

    if str(device).startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible: ribodetector_tpu_torch.train runs "
            "on the card (train.__main__.main_cpu pins the CPU)"
        )
    if device == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device(device)

    from ribodetector_tpu_torch.models.bilstm import init_params, load_params
    from ribodetector_tpu_torch.train import TrainConfig, fit

    data = _load_labeled(args.rrna, args.norrna, args.len, args.seed)
    say(f"loaded {len(data[2])} training reads "
        f"({int(data[2].sum())} rRNA / {int((data[2] == 0).sum())} non-rRNA)")
    eval_data = None
    if args.val_rrna and args.val_norrna:
        eval_data = _load_labeled(args.val_rrna, args.val_norrna, args.len, args.seed)
        say(f"loaded {len(eval_data[2])} validation reads")

    if args.init:
        params = load_params(args.init, device)
        say(f"fine-tuning from {args.init}")
    else:
        params = init_params(
            torch.Generator().manual_seed(args.seed),
            hidden=args.hidden if args.hidden is not None else 128,
            device=device,
        )

    batch = args.batch
    if grid is not None:
        dp = grid.dp
        if batch % dp:
            # batch rows split over the dp ranks; round down rather than
            # fail on the first step
            batch = max(dp, batch - batch % dp)
            say(f"--batch rounded to {batch} (divisible by dp={dp})")
        say(f"training on {grid.mesh.devices.size} devices, mesh {grid.mesh.shape}")

    cfg = TrainConfig(
        learning_rate=args.lr,
        weight_decay=args.weight_decay,
        semantics=args.semantics,
    )
    fit(
        params,
        data,
        cfg,
        epochs=args.epochs,
        batch_size=batch,
        device=device,
        grid=grid,
        eval_data=eval_data,
        log_fn=say,
        checkpoint_dir=args.out,
        monitor=monitor,
    )
    tracked = f"eval {monitor}" if eval_data is not None else "train loss (no val set)"
    say(f"checkpoints in {args.out} (best.npz tracks {tracked}); "
        "use with the engine via --config state_file, or export to torch: "
        "python -m ribodetector_tpu_torch.models.convert best.npz best.pth")


def worker(rank, world, tp, backend, device, argv, init_method):
    """One rank of a multi-device training run: join the `backend` group of
    `world` ranks at `init_method`, place this rank on the (dp, tp) grid
    (parallel.mesh.make_grid) and run the CLI over `argv` on `device`
    ("cuda": card `rank`). main spawns it with NCCL, one rank per card;
    gloo runs it on the CPU, or several ranks on one card."""
    import torch
    import torch.distributed as dist

    from ribodetector_tpu_torch.parallel.mesh import make_grid

    if device == "cuda":
        device = f"cuda:{rank}"
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group(backend, init_method=init_method, world_size=world,
                            rank=rank, timeout=COLLECTIVE_TIMEOUT)
    try:
        _train(argv, device, make_grid(tp))
    finally:
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None):
    """Train on the card: with n > 1 visible cards one worker per card in an
    NCCL group, else the current CUDA device; raises when no CUDA device is
    visible rather than training on the CPU."""
    import torch

    n = torch.cuda.device_count()  # creates no CUDA context
    if n <= 1:
        _train(argv, "cuda")
        return
    import sys

    import torch.multiprocessing as mp

    # the worker by its module's import name: under `python -m` this module
    # runs as __main__, which a spawned process does not import
    from ribodetector_tpu_torch.train.__main__ import worker as rank_worker

    argv = sys.argv[1:] if argv is None else list(argv)
    args, _ = _parse(argv)  # flag misuse exits here, before any worker
    mp.start_processes(
        rank_worker,
        args=(n, args.tp, "nccl", "cuda", argv, f"tcp://127.0.0.1:{_free_port()}"),
        nprocs=n, join=True, start_method="spawn",
    )


def main_cpu(argv=None):
    """The same CLI pinned to the host CPU."""
    _train(argv, "cpu")


if __name__ == "__main__":
    main()
