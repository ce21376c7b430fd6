"""Train an avatar (the port's counterpart of the root `train.py`;
reference train.py:316-353):

    python -m gaussianavatars_torch.train -s <dataset> -m <output> \\
        --bind_to_mesh [--eval] [--iterations N] [--device cuda]

The flags are the reference's (the ModelConfig, OptimizationConfig and
PipelineConfig groups; --test_iterations, --save_iterations,
--checkpoint_iterations, --start_checkpoint, --quiet, --seed), plus
--device (default cuda; the run raises when no GPU is present unless it is
cpu). --interval (default 60000) is the iteration interval of the tests,
saves and checkpoints not listed explicitly. The network viewer, the
profiler, anomaly detection and multi-host flags of the JAX package's
script (--ip, --port, --no_gui, --profile_dir, --detect_anomaly,
--distributed) are not accepted: they are not ported.
"""

from __future__ import annotations

import contextlib
import os
import sys
from argparse import ArgumentParser

from gaussianavatars_torch.config import (
    ModelConfig,
    OptimizationConfig,
    PipelineConfig,
)


def main(argv=None):
    parser = ArgumentParser(description="Training script parameters")
    ModelConfig.add_to_parser(parser)
    OptimizationConfig.add_to_parser(parser)
    PipelineConfig.add_to_parser(parser)
    parser.add_argument("--interval", type=int, default=60_000,
                        help="iteration interval of the tests, saves and "
                             "checkpoints not listed explicitly")
    parser.add_argument("--test_iterations", nargs="+", type=int, default=[])
    parser.add_argument("--save_iterations", nargs="+", type=int, default=[])
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int,
                        default=[])
    parser.add_argument("--start_checkpoint", type=str, default=None)
    parser.add_argument("--quiet", action="store_true",
                        help="print nothing")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    if args.interval > args.iterations:
        args.interval = max(args.iterations // 5, 1)
    schedule = list(range(args.interval, args.iterations + 1, args.interval))
    tests = args.test_iterations or schedule
    saves = args.save_iterations or schedule
    checkpoints = args.checkpoint_iterations or schedule

    model_cfg = ModelConfig.extract(args)
    opt_cfg = OptimizationConfig.extract(args)
    pipe_cfg = PipelineConfig.extract(args)

    from gaussianavatars_torch.train.loop import training

    with contextlib.ExitStack() as stack:
        if args.quiet:
            stack.enter_context(contextlib.redirect_stdout(
                stack.enter_context(open(os.devnull, "w"))))
        print("Optimizing " + model_cfg.model_path)
        training(model_cfg, opt_cfg, pipe_cfg,
                 testing_iterations=set(tests), saving_iterations=set(saves),
                 checkpoint_iterations=set(checkpoints),
                 start_checkpoint=args.start_checkpoint, seed=args.seed,
                 device=args.device)
        print("\nTraining complete.")


if __name__ == "__main__":
    sys.exit(main())
