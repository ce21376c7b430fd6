"""Where a cell's device idles, named by the program's own spans.

    python3 -m avatarbench.idle_by_span --workload <cell> --seed <n> \
        [--seconds 10]

Sets the cell up and warms it up as a run does, iterates for `--seconds`,
then profiles the traffic's `profile_iterations` from the next epoch's
start, as a `--trace 1` run does, and prints one JSON line (`what:
"idle_by_span"`): the device's idle seconds in those iterations, each gap
put down to the innermost `ga:` span of the program open at its start
(`program_trace.idle_by_span`), beside the benchmark's `idle_gaps` (each
gap named by the mark that opened the stage it fell in), the busy and
window seconds, and the readings of the metrics in `program_trace.py`
with each sync site's share.
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import types


def line(root, workload, cfg, tr, limits, seed, seconds, device) -> dict:
    from avatarbench import harness, program_trace
    from avatarbench import trace as tracing

    loop = harness.make_loop(root, cfg, tr, limits, seed, device)
    try:
        loop.warm_up()
        loop.window(seconds)
        k0 = loop.profile_start()
        loop.seek(k0)
        n = tr["profile_iterations"]
        prof = tracing.profile(lambda i, mark: loop.iteration(mark), n,
                               device)
    finally:
        loop.close()
    data = types.SimpleNamespace(profiled=prof)     # what the readers read
    root_span = "render" if tr["kind"] == "replay" else "train_step"
    readings = {
        "host_syncs": program_trace.host_syncs(data),
        "sync_wait_ms": program_trace.sync_wait_ms(data),
        "sync_idle_ms": program_trace.sync_idle_ms(data),
        "launches": program_trace.launches(root_span)(data),
        "flame_reg_ms": program_trace.span_ms("flame_reg")(data),
        "sync_sites": program_trace.sync_sites(prof)}
    return dict(what="idle_by_span", workload=workload, seed=seed, k0=k0,
                iterations=n, busy_s=prof.busy_s, window_s=prof.window_s,
                idle_by_span=program_trace.idle_by_span(prof),
                idle_gaps=prof.idle_gaps, **readings)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)

    from avatarbench import harness, run
    run.cache_env()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    _, _, cfg, tr, limits = harness.find_cell(run.ROOT, args.workload)
    out = line(run.ROOT, args.workload, cfg, tr, limits, args.seed,
               args.seconds, device)
    out["device"] = torch.cuda.get_device_name(device)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
