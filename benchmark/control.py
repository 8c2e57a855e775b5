"""Readings of the output check's control and planted faults, at a cell's
own size, for setting its limits (benchmark/workloads/<cell>.json).

For each seed, on the cell's panel and initial weights, the reference put
in the program's place:

  control   the reference with TF32 matrix products (the configuration
            states fp32 with TF32 off), for the first three steps and for
            the Q pass of every row;
  half      half of each batch left out and the loss taken over the rest,
            scaled to the whole batch (the fault "half of the batch left
            out, the mean taken over the rest"): its losses and step 1's
            gradient are those of the half batch times two, and Adam's
            change is the half batch's (Adam does not see the scale);
  still     a step that returns its state unchanged (learning rate 0):
            its losses are those of the initial weights on each batch.

Each is read as the harness reads the program: harness.check_numbers
against the fp32 reference, and the Q pass's largest gap. A state left
unchanged reads a change gap of 1 by that measure.

With ``--window SECONDS`` each seed is instead a whole run of the cell
(harness.run, a window of about SECONDS): the program's numbers, and at
each replayed window step, from the program's state just before it, the
control (the reference with TF32 products) and the half batch, each held
against the fp32 reference from the same state (``win_*``).

    python3 benchmark/control.py --workload <cell> --seeds <n> <n> ...
        [--window SECONDS]

prints one JSON line per seed and reading.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark import harness, plans as plan_maker  # noqa: E402
from benchmark import reference, sim, spec  # noqa: E402


def readings(cell: spec.Cell, seed: int, device, chunk: int = 65536,
             q_pass: bool = True):
    """{"control": numbers, "half": numbers, "still": numbers} of one
    seed."""
    config, traffic = cell.config, cell.traffic
    N, M = int(traffic["samples"]), int(traffic["snps"])
    batch, blk = int(config["batch_size"]), int(config["sample_block"])
    panel, P_star = sim.simulate_panel(traffic, seed, device)
    params = sim.init_params(config, P_star, sim.padded_snps(traffic), seed,
                             device)
    del P_star
    plan = plan_maker.epoch_plans(N, batch, blk, 1, seed)[0]
    order = plan_maker.pre_shuffle(N, seed)
    batches = [torch.from_numpy(panel[order[plan_maker.batch_rows(
        plan[0][i], blk)]]).to(device) for i in range(harness.CHECK_STEPS)]
    args = (M, float(config["learning_rate"]), tuple(config["betas"]),
            float(config["adam_eps"]), chunk)
    ref = reference.train_steps(params, batches, *args)
    tf32 = reference.train_steps(params, batches, *args, tf32=True)
    out = {"control": harness.check_numbers(tf32, ref)}
    half = reference.train_steps(
        params, [b[:b.shape[0] // 2] for b in batches], *args)
    half["loss"] = [2 * x for x in half["loss"]]
    half["grad"] = {k: 2 * v for k, v in half["grad"].items()}
    out["half"] = harness.check_numbers(half, ref)
    still = reference.train_steps(params, batches, M, 0.0, *args[2:])
    out["still"] = harness.check_numbers(still, ref)
    if q_pass:
        ks = sorted(int(k) for k in config["ks"])
        q32 = reference.q_pass(params, panel, device, chunk)
        q_tf32 = reference.q_pass(params, panel, device, chunk, tf32=True)
        out["control"]["q_gap"] = harness.q_gap(
            [q_tf32[f"k{k}"] for k in ks], q32, ks)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="control and fault readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--window", type=float, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload, ROOT)
    for seed in args.seeds:
        t0 = time.perf_counter()
        if args.window is None:
            out = readings(cell, seed, torch.device("cuda:0"))
        else:
            res = harness.run(cell, seed, args.window, False,
                              torch.device("cuda:0"), t0, controls=True)
            out = dict(res["readings"])
            out["program"] = dict(out["program"], correct=res["correct"],
                                  **{k: v["value"] for k, v in
                                     res["metrics"].items()})
        for kind, numbers in out.items():
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "reading": kind, **numbers,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
