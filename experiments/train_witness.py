"""Does the motif task of chip_smoke.py's train phase learn from a random
init, and does the port train as the JAX package does there? Over the
same FASTA files as that phase (its labeled_fasta with seed 17), from the
random-init npz of the port's init_params with a seed (the training CLI's
default is 0), at lr 5e-3 and batch 200:

  --steps K   on the CPU, three trainers in lockstep over the first K
              batches of epoch 0 (the CLI's data order for the first of
              --seeds): the JAX package's, the port's, and the port's again
              from the npz with every weight moved up by one float32 ulp;
              per step the losses and the largest parameter gap of JAX
              against the port and of the port against its nudged copy;
              and before step GRAD_STEP (where the loss of seed 0 starts to
              move), each package's float32 gradient at JAX's parameters
              against the port's float64 one
  --epochs N  each package's training CLI for each seed (--init the seed's
              npz, --seed the seed, the validation files): per epoch the
              train loss and the val accuracy; the port on --device (cpu,
              or cuda: the card, where no JAX is needed)

    JAX_PLATFORMS=cpu python experiments/train_witness.py --steps 81
    JAX_PLATFORMS=cpu python experiments/train_witness.py --epochs 16 --packages jax
    JAX_PLATFORMS=cpu python experiments/train_witness.py --len 40 --epochs 4
    python experiments/train_witness.py --epochs 16 --packages torch \\
        --device cuda --seeds 0,1,2

One JSON line per step or epoch, then a summary line.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
GRAD_STEP = 74


def grads_against_fp64(jp, batch):
    """max-abs gap per leaf of JAX's and the port's float32 gradients at
    the JAX params `jp` from the port's float64 gradient there."""
    import jax
    import jax.numpy as jnp
    import torch

    from ribodetector_tpu.train import trainer as jt
    from ribodetector_tpu_torch.models import bilstm as tb
    from ribodetector_tpu_torch.train import trainer as tt

    (_, _), jg = jax.value_and_grad(jt._loss_fn, has_aux=True)(
        jp, *(jnp.asarray(x.numpy()) for x in batch[:2]),
        jnp.asarray(batch[2].numpy().astype(np.int32)), "dense", jnp.float32)
    tg = {}
    for dtype in (torch.float32, torch.float64):
        leaves = tb.BiLSTMParams(*(torch.tensor(np.asarray(x), dtype=dtype).requires_grad_(True)
                                   for x in jp))
        loss, _ = tt._loss_fn(leaves, *batch, "dense", dtype)
        loss.backward()
        tg[dtype] = [p.grad.numpy().astype(np.float64) for p in leaves]
    return {n: {"max_abs_g": float(np.abs(ref).max()),
                "jax_vs_fp64": float(np.abs(np.asarray(j, np.float64) - ref).max()),
                "torch_vs_fp64": float(np.abs(t - ref).max())}
            for n, j, t, ref in zip(tb.BiLSTMParams._fields, jg, tg[torch.float32],
                                    tg[torch.float64])}


def lockstep(paths, init, max_len, steps, seed):
    import torch

    from chip_smoke import TRAIN_BATCH, TRAIN_LR
    from ribodetector_tpu.models import bilstm as jb
    from ribodetector_tpu.train import trainer as jt
    from ribodetector_tpu_torch.models import bilstm as tb
    from ribodetector_tpu_torch.train import trainer as tt
    from ribodetector_tpu_torch.train.__main__ import _load_labeled

    tok, lens, lab = _load_labeled(paths["train_rrna"], paths["train_norrna"], max_len, seed)
    jcfg, tcfg = jt.TrainConfig(learning_rate=TRAIN_LR), tt.TrainConfig(learning_rate=TRAIN_LR)
    jp = jb.load_params(init)
    jopt = jt.make_optimizer(jcfg)
    jstate = jopt.init(jp)
    jstep = jt.make_train_step(jcfg, jopt)
    params = tb.load_params(init)
    nudged = tb.BiLSTMParams(*(torch.from_numpy(np.nextafter(p.numpy(), np.float32(np.inf)))
                               for p in params))
    models = [tb.BiLSTM(params), tb.BiLSTM(nudged)]
    tsteps = [tt.make_train_step(tcfg, tt.make_optimizer(tcfg, m.parameters())) for m in models]
    perm = np.random.default_rng(0).permutation(len(lab))  # fit's epoch-0 order

    def gap(a, b):
        return max(float(np.abs(np.asarray(x) - np.asarray(y)).max()) for x, y in zip(a, b))

    apart = {"jax_vs_torch": None, "torch_vs_nudged": None}
    fp64 = None
    for k in range(steps):
        idx = perm[k * TRAIN_BATCH:(k + 1) * TRAIN_BATCH]
        batch = (torch.from_numpy(tok[idx]), torch.from_numpy(lens[idx]),
                 torch.from_numpy(lab[idx].astype(np.int64)))
        if k == GRAD_STEP:
            fp64 = grads_against_fp64(jp, batch)
            print(json.dumps({"step": k, "gradients_at_jax_params": fp64}), flush=True)
        jp, jstate, jloss = jstep(jp, jstate, tok[idx], lens[idx], lab[idx])
        tloss, nloss = (float(step(m.params(), *batch)) for step, m in zip(tsteps, models))
        tp, npar = ([p.detach().numpy() for p in m.params()] for m in models)
        row = {"step": k, "jax_loss": float(jloss), "torch_loss": tloss, "nudged_loss": nloss,
               "param_gap_jax_vs_torch": gap(jp, tp), "param_gap_torch_vs_nudged": gap(tp, npar)}
        print(json.dumps(row), flush=True)
        for key, d in (("jax_vs_torch", float(jloss) - tloss), ("torch_vs_nudged", tloss - nloss)):
            if apart[key] is None and abs(d) > 1e-5:
                apart[key] = k
    return {"steps": steps, "first_step_losses_apart_1e-5": apart,
            "gradient_step": GRAD_STEP if fp64 else None}


def fit_cli(paths, init, max_len, epochs, pkg, out, seed, device):
    from chip_smoke import TRAIN_BATCH, TRAIN_LR
    from ribodetector_tpu_torch.models.bilstm import load_params_meta

    if pkg == "jax":
        from ribodetector_tpu.train.__main__ import main as train
    elif device == "cuda":
        from ribodetector_tpu_torch.train.__main__ import main as train
    else:
        from ribodetector_tpu_torch.train.__main__ import main_cpu as train
    t0 = time.perf_counter()
    train(["--rrna", paths["train_rrna"], "--norrna", paths["train_norrna"],
           "--val-rrna", paths["val_rrna"], "--val-norrna", paths["val_norrna"],
           "-l", str(max_len), "--batch", str(TRAIN_BATCH), "--lr", str(TRAIN_LR),
           "--epochs", str(epochs), "--init", init, "--seed", str(seed), "--out", out])
    wall = time.perf_counter() - t0
    accs = []
    for e in range(epochs):
        m = load_params_meta(os.path.join(out, f"epoch{e:03d}.npz"))["metrics"]
        accs.append(m["acc"])
        print(json.dumps({"package": pkg, "seed": seed, "epoch": e,
                          "train_loss": m["train_loss"], "val_acc": m["acc"],
                          "val_loss": m["loss"]}), flush=True)
    return {"wall_s": wall, "best_val_acc": max(accs),
            "first_epoch_over_0.8": next((e for e, a in enumerate(accs) if a > 0.8), None),
            "epochs_at_val_acc_over_0.8": sum(a > 0.8 for a in accs)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--len", type=int, default=100)
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--epochs", type=int, default=0)
    ap.add_argument("--packages", default="jax,torch")
    ap.add_argument("--seeds", default="0")
    ap.add_argument("--device", default="cpu", choices=["cpu", "cuda"])
    args = ap.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import torch

    from chip_smoke import labeled_fasta
    from ribodetector_tpu_torch.models.bilstm import init_params, save_params

    seeds = [int(x) for x in args.seeds.split(",")]
    summary = {"len": args.len, "device": args.device}
    with tempfile.TemporaryDirectory() as tmp:
        paths, _, _ = labeled_fasta(tmp, np.random.default_rng(17), args.len)
        inits = {}
        for seed in seeds:
            inits[seed] = os.path.join(tmp, f"init{seed}.npz")
            save_params(inits[seed], init_params(torch.Generator().manual_seed(seed)),
                        {"init": f"ribodetector_tpu_torch init_params, seed {seed}"})
        if args.steps:
            summary["lockstep"] = lockstep(paths, inits[seeds[0]], args.len, args.steps,
                                           seeds[0])
        for pkg in args.packages.split(",") if args.epochs else ():
            summary[pkg] = {seed: fit_cli(paths, inits[seed], args.len, args.epochs, pkg,
                                          os.path.join(tmp, f"{pkg}{seed}"), seed, args.device)
                            for seed in seeds}
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
