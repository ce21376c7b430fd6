"""The readings that the limits of `correct` are set from, for one cell,
in one process (the set-up's imports and builds paid once):

    python -m avatarbench.readings --workload <cell> --seconds <s> \
        --seeds a,b,... [--control a,b,c] [--faults a,b,c]

- `--seeds`: the program's numbers, each seed a set-up, a short window
  at the cell's own load (long enough to hold what the comparison reads)
  and the comparison, as a run makes them;
- `--control`: the lower-precision control, the reference computed with
  TF32 on (the configuration states float32 with TF32 off) in the
  program's place, against the reference;
- `--faults`: the reference with each planted fault of the loop's kind
  (`FAULTS`) in the program's place; a train loop's are the image losses
  over half of the rows ("half_rows", half of the batch left out) and a
  step that leaves the state unchanged ("unchanged").

One JSON line per reading. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from avatarbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _numbers(loop, prog, ref):
    n = loop.compare(prog, ref)
    return {k: v for k, v in n.items() if k != "_detail"}, n["_detail"]


def program_reading(cfg, tr, limits, seed, seconds, device,
                    root=ROOT) -> dict:
    loop = harness.make_loop(root, cfg, tr, limits, seed, device)
    try:
        loop.warm_up()
        res = loop.window(seconds)
        prog = loop.program_readings()
        loop.free_program()
        numbers, detail = _numbers(loop, prog, loop.reference_readings())
    finally:
        loop.close()
    return dict(what="program", seed=seed, iterations=res["n"],
                numbers=numbers, detail=detail)


def control_reading(cfg, tr, limits, seed, device, fault=None,
                    root=ROOT) -> dict:
    """The reference in the program's place: with TF32 on (fault None),
    or with a planted fault."""
    loop = harness.make_loop(root, cfg, tr, limits, seed, device)
    try:
        prog, ref = loop.control_pair(fault)
        numbers, detail = _numbers(loop, prog, ref)
    finally:
        loop.close()
    return dict(what=fault or "control_tf32", seed=seed, numbers=numbers,
                detail=detail)


def _seeds(text):
    return [int(s) for s in text.split(",") if s] if text else []


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--faults", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    _, _, cfg, tr, limits = harness.find_cell(ROOT, args.workload)
    for seed in _seeds(args.seeds):
        t0 = time.perf_counter()
        out = program_reading(cfg, tr, limits, seed, args.seconds, device)
        print(json.dumps(dict(out, s=time.perf_counter() - t0)), flush=True)
    for seed in _seeds(args.control):
        print(json.dumps(control_reading(cfg, tr, limits, seed, device)),
              flush=True)
    faults = harness.loop_class(ROOT, tr["kind"]).FAULTS
    for seed in _seeds(args.faults):
        for fault in faults:
            print(json.dumps(control_reading(cfg, tr, limits, seed, device,
                                             fault)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
