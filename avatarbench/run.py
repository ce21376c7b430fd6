"""Run one benchmark cell once on one NVIDIA GPU and print its result.

    python -m avatarbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Sets up the cell from the seed, warms it up, measures for `--seconds`,
and with `--trace 1` reads the per-layer metrics from host spans and a
short profiled sub-window. Then it frees the program, runs the plain
reference and decides `correct`. The last line of standard output is one
JSON object (`correct`, `attempted`, `failed`, `metrics`, `device`, with
`--trace 1` `breakdown`, and `check` last); the compared numbers with
their limits are also the last lines of standard error.

Exits non-zero without a result when there is no CUDA device, and when
a module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "avatarbench", "_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "gaussianavatars_tpu")


def cache_env():
    """Fixed cache directories inside the checkout, so that only a cell's
    first run there builds anything."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")


def forbidden_modules() -> list:
    """Top-level names of loaded modules that belong to JAX or the JAX
    package, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def log(line: str):
    print(line, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env()

    import torch
    import avatarbench.program  # noqa: F401  (the program must be there)
    from avatarbench import harness

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("no CUDA device: this benchmark measures the GPU and does not "
              "run on the CPU", file=sys.stderr)
        return 2
    torch.set_num_threads(1)         # one process, few threads, steady
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                           bool(args.trace), device, T0, log)
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    for name, c in out["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"correct {out['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
