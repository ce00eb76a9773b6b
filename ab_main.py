#!/usr/bin/env python3
"""Time the detect CLI's main path of this tree against another, on one card.

    python3 ab_main.py OTHER_TREE [--rounds 3] [--reps 4]

OTHER_TREE is another checkout of the repo (for example the parent commit
unpacked with `git archive` into the git-ignored .tree_check/). The main
path's inputs are written once (chip_smoke.write_pairs: 2 x 262144 paired
gz reads, seed 3) and every run uses chip_smoke's main-path command line
(-l 100, -e both). Each tree first builds its kernels in a process of its
own (not timed). Then each round runs A B B A (A = this tree, B =
OTHER_TREE), each a fresh process that calls its tree's cli.main --reps
times in a row and times each call to the card's last kernel. The first
call of a process holds its start-up (the CUDA context, the first
allocations); the later calls are the warm main path, the metric this
script reports per tree (all warm walls, their median, and reads/s at the
median). The parity-probe marker is kept per tree, so only the first
process of each tree runs the probe.

Prints one JSON line per process and a last JSON line with the summary.
Needs one CUDA card; imports nothing of the JAX package.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile

import numpy as np

import chip_smoke

PAIRS = 262144  # the main path's size (chip_smoke.phase_main)
CHILD = """
import json, sys, time
reps, argv = int(sys.argv[1]), sys.argv[2:]
import torch
from ribodetector_tpu_torch.cli import main
walls = []
for _ in range(reps):
    t0 = time.perf_counter()
    main(argv)
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t0)
print(json.dumps({"walls_s": walls}), flush=True)
"""


def run_tree(tree, reps, argv, cache):
    """cli.main of the tree at `tree`, reps times in one fresh process."""
    env = {**os.environ, "RIBODETECTOR_TPU_TORCH_CACHE": cache}
    proc = subprocess.run([sys.executable, "-c", CHILD, str(reps), *argv],
                          cwd=tree, env=env, capture_output=True, text=True)
    if proc.returncode != 0:
        chip_smoke.fail(f"{tree}: exit {proc.returncode}: {proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])["walls_s"]


def main(argv):
    import torch

    if not argv or not os.path.isdir(argv[0]):
        chip_smoke.fail("usage: python3 ab_main.py OTHER_TREE [--rounds N] [--reps N]")
    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is false: this needs a CUDA card")
    rounds = int(argv[argv.index("--rounds") + 1]) if "--rounds" in argv else 3
    reps = int(argv[argv.index("--reps") + 1]) if "--reps" in argv else 4
    trees = {"A": chip_smoke.REPO, "B": os.path.abspath(argv[0])}
    with tempfile.TemporaryDirectory() as tmp:
        inputs, _ = chip_smoke.write_pairs(tmp, PAIRS, np.random.default_rng(3))
        cli_argv, _ = chip_smoke.main_argv(tmp, "ab", inputs)
        caches = {k: os.path.join(tmp, f"cache_{k}") for k in trees}
        for k, tree in trees.items():  # builds the tree's kernels, untimed
            run_tree(tree, 1, cli_argv, caches[k])
        warm = {k: [] for k in trees}
        for r in range(rounds):
            for k in "ABBA":
                walls = run_tree(trees[k], reps, cli_argv, caches[k])
                warm[k] += walls[1:]
                chip_smoke.emit("ab", round=r, tree=k, path=trees[k], walls_s=walls)
    summary = {}
    for k, walls in warm.items():
        med = statistics.median(walls)
        summary[k] = {"path": trees[k], "warm_walls_s": walls, "median_s": med,
                      "reads_per_s_at_median": 2 * PAIRS / med}
    summary["B_over_A_median"] = summary["B"]["median_s"] / summary["A"]["median_s"]
    print(json.dumps({"ab_summary": summary}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
