"""Measure the tile-blend kernels K1 and K2 alone on the bench stream.

    python -m gaussianavatars_torch.profile_render --blend-stats
        [--tile-size 32] [--binning dense|sort] [--baseline-csrc DIR] [--count]

On the bench stream (timestep 0; `--binning sort` builds the sort
binning's longer stream) it prints one JSON line each: the distribution of
range lengths over the tiles; registers, shared memory and resident CTAs
per SM; the kernels' times (CUDA events, the builds taken in turns within
every round) for the library the port runs and for the kernels of another
source directory (`--baseline-csrc`, for instance an earlier commit's
`csrc/`); whether each build's image equals the port's bit for bit; and,
with `--count`, the cull tests, surviving warp-slots and pixel evaluations
of a counting build beside the plain version's pair counts.

A whole render or train step is profiled by the benchmark
(`python3 -m avatarbench.run --trace 1`) and by `train --profile_dir`,
whose Chrome trace names the program's spans.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import time
from argparse import ArgumentParser
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from gaussianavatars_torch import kernels
from gaussianavatars_torch.benchmark import (
    HEIGHT, WIDTH, bench_camera, blend_inputs, bound_bench_scene,
    make_bound_bench_model,
)
from gaussianavatars_torch.device import resolve_device
from gaussianavatars_torch.ops import tile_blend


def range_stats(ranges) -> dict:
    """The distribution of range lengths over the tiles."""
    counts = (ranges[:, 1] - ranges[:, 0]).long().sort(descending=True).values
    total = int(counts.sum())
    return {
        "tiles": int(counts.numel()), "slots": total,
        "empty_tiles": int((counts == 0).sum()),
        "max": int(counts[0]), "median": int(counts.median()),
        "mean": total / max(int(counts.numel()), 1),
        "top10": counts[:10].tolist(),
        "top10_share": int(counts[:10].sum()) / max(total, 1),
        "deciles": [int(counts[min(i * counts.numel() // 10,
                                   counts.numel() - 1)]) for i in range(11)],
    }


def _residency(lib, name, tile_size):
    """Registers, local memory per thread, shared memory per CTA and
    resident CTAs per SM, as the runtime reports them for the kernel;
    None for a library that does not export the query."""
    fn = getattr(lib, name + "_residency", None)
    if fn is None:
        return None
    out = (ctypes.c_int * 4)()
    err = fn(ctypes.c_int(tile_size), out)
    if err != 0:
        raise RuntimeError(f"{name}_residency: CUDA error {err}")
    return {"registers": out[0], "shared_bytes": out[1],
            "ctas_per_sm": out[2], "local_bytes": out[3]}


@dataclasses.dataclass
class _Build:
    """One build of both kernels: the port's, another source directory's
    (same C interface) or the port's counting build."""

    label: str
    defines: tuple = ()
    csrc: str | None = None
    fwd: object = None
    bwd: object = None

    def load(self):
        kernels.build(None, self.defines, self.csrc)
        self.fwd = kernels.load("blend_fwd", self.defines, self.csrc)
        self.bwd = kernels.load("blend_bwd", self.defines, self.csrc)

    def forward(self, inst, ranges, args):
        return tile_blend.blend_image_cuda(inst, ranges, *args, lib=self.fwd)

    def backward(self, inst, ranges, args, color, trans, g_c, g_t):
        return tile_blend.blend_image_bwd_cuda(
            inst, ranges, *args, color, trans, g_c, g_t, lib=self.bwd)


def _event_ms(fn, iters):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def blend_stats(args) -> list[dict]:
    dev = resolve_device("cuda")
    model = make_bound_bench_model(device=dev)
    cam = bench_camera(WIDTH, HEIGHT, device=dev)
    inst, ranges, bargs = blend_inputs(bound_bench_scene(model, 0), cam,
                                       args.tile_size, binning=args.binning)
    card = {"device": torch.cuda.get_device_name(dev),
            "tile_size": args.tile_size, "binning": args.binning}
    lines = [dict(card, what="ranges", **range_stats(ranges))]
    print(json.dumps(lines[-1]), flush=True)

    builds = [_Build("port")]
    if args.baseline_csrc:
        builds.append(_Build("baseline", csrc=args.baseline_csrc))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:      # two nvcc processes each
        list(pool.map(_Build.load, builds))
    build_s = time.perf_counter() - t0

    rng = np.random.default_rng(100)
    g_c = torch.as_tensor(rng.normal(size=(3, bargs[2], bargs[1])).astype(
        np.float32), device=dev)
    g_t = torch.as_tensor(rng.normal(size=(bargs[2], bargs[1])).astype(
        np.float32), device=dev)
    ref_color, ref_trans = builds[0].forward(inst, ranges, bargs)
    ref_grad = builds[0].backward(inst, ranges, bargs, ref_color, ref_trans,
                                  g_c, g_t)
    torch.cuda.synchronize()
    results = {}
    for b in builds:
        color, trans = b.forward(inst, ranges, bargs)
        grad = b.backward(inst, ranges, bargs, ref_color, ref_trans, g_c, g_t)
        again = b.backward(inst, ranges, bargs, ref_color, ref_trans, g_c,
                           g_t)
        scale = ref_grad.abs().amax(0).clamp(min=1e-30)
        results[b.label] = {
            "image_equals_port": bool(torch.equal(color, ref_color)
                                      and torch.equal(trans, ref_trans)),
            "image_max_abs_diff": float((color - ref_color).abs().max()),
            "grad_max_column_rel_diff": float(
                ((grad - ref_grad).abs().amax(0) / scale).max()),
            "grad_same_bits_twice": bool(torch.equal(grad, again)),
            "fwd_ms": [], "bwd_ms": [],
        }
        for name, lib in (("blend_fwd", b.fwd), ("blend_bwd", b.bwd)):
            results[b.label][name] = _residency(lib, name, args.tile_size)
    for _ in range(args.rounds):
        for b in builds:
            r = results[b.label]
            r["fwd_ms"].append(_event_ms(
                lambda: b.forward(inst, ranges, bargs), args.iters))
            r["bwd_ms"].append(_event_ms(
                lambda: b.backward(inst, ranges, bargs, ref_color, ref_trans,
                                   g_c, g_t), args.iters))
    for b in builds:
        r = results[b.label]
        lines.append(dict(card, what="kernels", build=b.label,
                          fwd_ms_min=min(r["fwd_ms"]),
                          bwd_ms_min=min(r["bwd_ms"]), **r))
        print(json.dumps(lines[-1]), flush=True)

    if args.count:
        counting = _Build("counting", defines=("GA_COUNT=1",))
        counting.load()
        counts = {}
        for name, lib, run in (
                ("blend_fwd", counting.fwd,
                 lambda: counting.forward(inst, ranges, bargs)),
                ("blend_bwd", counting.bwd,
                 lambda: counting.backward(inst, ranges, bargs, ref_color,
                                           ref_trans, g_c, g_t))):
            out = (ctypes.c_ulonglong * 3)()
            read = getattr(lib, name + "_counts")
            read(out)                      # zero them
            run()
            err = read(out)
            if err != 0:
                raise RuntimeError(f"{name}_counts: CUDA error {err}")
            counts[name] = {"cull_tests": out[0], "warp_slots_walked": out[1],
                            "pixel_evaluations": out[2]}
        _, work = tile_blend.blend_image_plain(inst, ranges, *bargs,
                                               count_work=True)
        tile_pixels = args.tile_size ** 2
        lines.append(dict(
            card, what="pairs", **counts, plain=work,
            whole_tile_pairs=int(inst.shape[0]) * tile_pixels))
        print(json.dumps(lines[-1]), flush=True)
    print(json.dumps(dict(card, what="build", seconds=build_s,
                          builds=[b.label for b in builds])))
    return lines


def main(argv=None) -> list[dict]:
    parser = ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--blend-stats", action="store_true", required=True,
                        help="measure kernels K1 and K2 on the bench stream")
    parser.add_argument("--tile-size", type=int, default=32,
                        choices=(16, 32))
    parser.add_argument("--binning", default="dense",
                        choices=("dense", "sort"))
    parser.add_argument("--baseline-csrc", default=None,
                        help="another csrc directory to time beside the port")
    parser.add_argument("--count", action="store_true",
                        help="count cull tests and pixel evaluations")
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--iters", type=int, default=20)
    return blend_stats(parser.parse_args(argv))


if __name__ == "__main__":
    main()
