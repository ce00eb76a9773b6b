"""Training CLI: (re)train the BiLSTM read classifier from labeled files.

Counterpart of ``python -m ribodetector_tpu.train`` with the same flags and
messages: rRNA reads (label 1) and non-rRNA reads (label 0) come from
separate FASTA/FASTQ files (plain or gz), and checkpoints are npz artifacts
that load straight into either package's detect engine (--config
state_file) or export to the reference's torch layout via models.convert.

``main`` trains on one card (the current CUDA device) and raises when no
CUDA device is visible; ``main_cpu`` pins the CPU. The JAX CLI meshes over
every local device; this one uses one card, and --tp > 1 (tensor
parallelism over the gate dimension) is not ported.

  python -m ribodetector_tpu_torch.train --rrna rrna.fa --norrna mrna.fa \\
      -l 100 --epochs 5 --batch 200 --out ckpts/
"""

import argparse

import numpy as np


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
                    help="tensor-parallel width over the gate dimension "
                    "(only 1: tensor parallelism is not ported)")
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


def _train(argv, device):
    ap = build_arg_parser()
    args = ap.parse_args(argv)
    if bool(args.val_rrna) != bool(args.val_norrna):
        ap.error("--val-rrna and --val-norrna must be given together")
    monitor = VALID_MONITORS.get(args.monitor.lower())
    if monitor is None:
        ap.error(f"--monitor must be one of {sorted(VALID_MONITORS)}")
    if args.tp != 1:
        from ribodetector_tpu_torch.runtime.pipeline import NOT_PORTED

        raise NotImplementedError(
            f"--tp {args.tp} (tensor parallelism over the gate dimension) is "
            f"{NOT_PORTED}: training runs on one device"
        )

    import torch

    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible: ribodetector_tpu_torch.train runs "
                "on the card (train.__main__.main_cpu pins the CPU)"
            )
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device(device)

    from ribodetector_tpu_torch.models.bilstm import init_params, load_params
    from ribodetector_tpu_torch.train import TrainConfig, fit

    data = _load_labeled(args.rrna, args.norrna, args.len, args.seed)
    print(f"loaded {len(data[2])} training reads "
          f"({int(data[2].sum())} rRNA / {int((data[2] == 0).sum())} non-rRNA)")
    eval_data = None
    if args.val_rrna and args.val_norrna:
        eval_data = _load_labeled(args.val_rrna, args.val_norrna, args.len, args.seed)
        print(f"loaded {len(eval_data[2])} validation reads")

    if args.init:
        if args.hidden is not None:
            ap.error("--hidden cannot be combined with --init: the "
                     "checkpoint fixes the width")
        params = load_params(args.init, device)
        print(f"fine-tuning from {args.init}")
    else:
        params = init_params(
            torch.Generator().manual_seed(args.seed),
            hidden=args.hidden if args.hidden is not None else 128,
            device=device,
        )

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
        batch_size=args.batch,
        device=device,
        eval_data=eval_data,
        checkpoint_dir=args.out,
        monitor=monitor,
    )
    tracked = f"eval {monitor}" if eval_data is not None else "train loss (no val set)"
    print(f"checkpoints in {args.out} (best.npz tracks {tracked}); "
          "use with the engine via --config state_file, or export to torch: "
          "python -m ribodetector_tpu_torch.models.convert best.npz best.pth")


def main(argv=None):
    """Train on the card (the current CUDA device); raises when no CUDA
    device is visible rather than training on the CPU."""
    _train(argv, "cuda")


def main_cpu(argv=None):
    """The same CLI pinned to the host CPU."""
    _train(argv, "cpu")


if __name__ == "__main__":
    main()
