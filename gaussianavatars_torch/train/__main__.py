"""Train an avatar (the port's counterpart of the root `train.py`;
reference train.py:316-353):

    python -m gaussianavatars_torch.train -s <dataset> -m <output> \\
        --bind_to_mesh [--eval] [--iterations N] [--device cuda]

The flags are the reference's (the ModelConfig, OptimizationConfig and
PipelineConfig groups, with --convert_SHs_python, --compute_cov3D_python
and --debug; --test_iterations, --save_iterations, --checkpoint_iterations,
--start_checkpoint, --debug_from, --detect_anomaly, --quiet, --seed, --ip,
--port, --no_gui, --profile_dir), plus --device (default cuda; the run
raises when no GPU is present unless it is cpu). --interval (default
60000) is the iteration interval of the tests, saves and checkpoints not
listed explicitly. --detect_anomaly runs the training under
`torch.autograd.set_detect_anomaly(True)`.

The run serves the network viewer (`viewer/network_gui.py`, for
`python -m gaussianavatars_torch.remote_viewer`) on --ip:--port (default
127.0.0.1:6009) unless --no_gui is given; an address that cannot be bound
is printed and the run trains without the viewer. It always logs to a
tensorboard event file `events.out.tfevents.*` in the model directory
(`utils/tensorboard.py`). --profile_dir DIR records the whole run with
`torch.profiler` and writes a Chrome trace there: meant for short runs.
The JAX script's --distributed is not accepted: multi-device training is
not ported.
"""

from __future__ import annotations

import contextlib
import os
import sys
from argparse import ArgumentParser

import torch

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
    parser.add_argument("--debug_from", type=int, default=-1,
                        help="set the pipeline's debug option (stop with a "
                             "state snapshot at a non-finite loss) from "
                             "this iteration on")
    parser.add_argument("--detect_anomaly", action="store_true",
                        help="train under torch.autograd anomaly detection")
    parser.add_argument("--quiet", action="store_true",
                        help="print nothing")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--ip", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6009)
    parser.add_argument("--no_gui", action="store_true",
                        help="do not serve the network viewer")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler Chrome trace of the "
                             "run here")
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
    from gaussianavatars_torch.utils.system import profile_trace
    from gaussianavatars_torch.utils.tensorboard import SummaryWriter
    from gaussianavatars_torch.viewer.network_gui import NetworkGUI

    with contextlib.ExitStack() as stack:
        if args.quiet:
            stack.enter_context(contextlib.redirect_stdout(
                stack.enter_context(open(os.devnull, "w"))))
        if args.detect_anomaly:
            stack.enter_context(torch.autograd.set_detect_anomaly(True))
        print("Optimizing " + model_cfg.model_path)
        tb_writer = SummaryWriter(model_cfg.model_path)
        stack.callback(tb_writer.close)
        gui = None
        if not args.no_gui:
            gui = NetworkGUI(args.ip, args.port)
            try:
                gui.init()
            except OSError as exc:
                print(f"[warn] GUI server unavailable on {args.ip}:"
                      f"{args.port}: {exc}")
                gui = None
            else:
                stack.callback(gui.close)
        with profile_trace(args.profile_dir):
            training(model_cfg, opt_cfg, pipe_cfg,
                     testing_iterations=set(tests),
                     saving_iterations=set(saves),
                     checkpoint_iterations=set(checkpoints),
                     start_checkpoint=args.start_checkpoint,
                     tb_writer=tb_writer, gui=gui,
                     debug_from=args.debug_from, seed=args.seed,
                     device=args.device)
        print("\nTraining complete.")


if __name__ == "__main__":
    sys.exit(main())
