"""Readings that the limits of ``correct`` are set from, at a cell's own size:

    python3 -m ptbench.calibrate --workload <cell> --seed <first> \\
        [--sound 12] [--control 3] [--faults 3]

For each of ``--sound`` seeds it sets the cell up as a run does (with a
train cell's first steps), runs the first frame or step of the window
through the program, and prints the numbers that the check compares: the
lower readings.  For
``--control`` seeds it prints the same numbers of the reference computed
in bfloat16, the precision below the configuration's float32, against the
float32 reference: the control, which has to fail.  For ``--faults`` seeds
it plants each fault of :mod:`ptbench.faults` in the program and prints
the numbers.  One JSON line a reading, then a summary: per number the
largest sound reading and the smallest control and fault readings.

It runs on the CUDA device; the tests call its functions on the CPU at a
small size.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ptbench import cells, faults, spec


def reading(c, seed, device, fault=None):
    cell = cells.make_cell(c["config"], c["traffic"], seed, device)
    if fault is None:
        return _program(cell)
    with faults.fault(c["traffic"]["kind"], fault):
        return _program(cell)


def _program(cell):
    cell.setup()
    i = cell.first_unit
    cell.kept = [(i, cell.unit(i))]
    cell.release()
    return cell.check()[0]


def control(c, seed, device):
    """The bfloat16 reference in the program's place, against float32."""
    cell = cells.make_cell(c["config"], c["traffic"], seed, device)
    if isinstance(cell, cells.RenderCell):
        i = cell.first_unit
        low, _, _ = cell.reference(cell.reference_world(torch.bfloat16), i, torch.bfloat16)
        cell.kept = [(i, low.float())]
        return cell.check()[0]
    from ptbench.reference import train as ref_train

    g = torch.Generator(device=cell.device)
    g.manual_seed(seed)
    n = cell.resolution[0] * cell.resolution[1]
    cell.target = torch.rand((n, 3), generator=g, device=cell.device)
    i = cell.first_unit  # set-up's steps, then the window's first
    seeds = [cells.unit_seed(seed, k) for k in range(i + 1)]
    colors = torch.as_tensor(cell.inputs.mat_color, device=cell.device)
    losses, hist = ref_train.sgd_steps(
        cell.reference_world(torch.bfloat16), cell.config["camera"], cell.resolution, cell.spp,
        cell.bounces, seeds, cell.target.bfloat16(), colors.bfloat16(), cell.traffic["lr"])
    hist = [h.float() for h in hist]
    cell.losses, cell.history = losses[:i], hist[:i + 1]
    cell.kept = [(i, (torch.tensor(losses[i]), hist[i], hist[i + 1]))]
    return cell.check()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True, help="the first seed; then +1, +2, ...")
    ap.add_argument("--sound", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = spec.cell(spec.load_benchmark(), args.workload)
    plan = [("sound", None, k) for k in range(args.sound)]
    plan += [("control", None, k) for k in range(args.control)]
    plan += [(f"fault:{f}", f, k) for f in faults.FAULTS for k in range(args.faults)]
    summary = {}
    for what, fault, k in plan:
        seed = args.seed + k
        nums = control(c, seed, device) if what == "control" else reading(c, seed, device, fault)
        print(json.dumps({"workload": args.workload, "what": what, "seed": seed,
                          "numbers": nums}), flush=True)
        for name, v in nums.items():
            s = summary.setdefault(name, {})
            agg = max if what == "sound" else min
            s[what] = agg(s.get(what, v), v)
    print(json.dumps({"workload": args.workload, "summary": summary,
                      "limits": c["traffic"].get("limits")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
