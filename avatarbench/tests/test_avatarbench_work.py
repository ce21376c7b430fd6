"""The frozen work counts against a brute-force count on a tiny scene."""

import math

import torch

from avatarbench import scene
from avatarbench.reference import render as R
from avatarbench.work import counts


def _tiny_scene(n=60, width=40, height=32):
    params = scene.cloud_params(11, n, 16, "cpu")
    params["scaling"] = params["scaling"] + 2.5     # a few px each
    cam = R.Camera(**{k: v for k, v in scene.camera(
        scene.look_at(0.2, 0.1, 1.0), width, height, 0.5, "cpu").items()})
    return params, cam


def _brute_force(proj, cam, tile):
    """Walk every pixel through the depth-sorted Gaussians whose tile rect
    covers it, one at a time, as the rasterizer's loop does."""
    x0, y0, x1, y1 = R.tile_rects(proj.means2d, proj.radii, cam.width,
                                  cam.height, tile)
    order = sorted(range(proj.means2d.shape[0]),
                   key=lambda i: (float(proj.depths[i]), i))
    blended = needed = 0
    slots = set()
    for py in range(cam.height):
        for px in range(cam.width):
            tx, ty = px // tile, py // tile
            t = 1.0
            for i in order:
                if not (proj.valid[i] and x0[i] <= tx < x1[i]
                        and y0[i] <= ty < y1[i]):
                    continue
                dx = float(proj.means2d[i, 0]) - px
                dy = float(proj.means2d[i, 1]) - py
                cxx, cxy, cyy = (float(c) for c in proj.conics[i])
                power = -0.5 * (cxx * dx * dx + cyy * dy * dy) - cxy * dx * dy
                e = float(proj.opacities[i]) * math.exp(min(power, 0.0))
                if power > 0 or e < R.ALPHA_MIN:
                    continue
                test = t * (1.0 - min(e, R.ALPHA_MAX))
                needed += 1
                if test < R.T_EPS:
                    break
                blended += 1
                slots.add((ty * 1000 + tx, i))
                t = test
    return dict(blended=blended, needed=needed, slots=len(slots))


def test_counts_match_brute_force():
    params, cam = _tiny_scene()
    with torch.no_grad():
        res, proj = R.render(params, None, None, cam, torch.ones(3), tile=16,
                             count=True)
    brute = _brute_force(proj, cam, 16)
    assert brute["blended"] > 100
    for key in ("blended", "needed", "slots"):
        assert res.work[key] == brute[key], key
    assert res.work["pixels"] == 40 * 32 and res.work["tiles"] == 3 * 2


def test_bounds_from_counts():
    w = dict(needed=10, blended=8, slots=5, tiles=2, pixels=100,
             gaussians=7, vertices=0, faces=0, flame_elems=0, bound=False)
    f, b = counts.blend_fwd(w)
    assert f == 13 * 10 + 9 * 8 and b == 36 * 5 + 8 * 2 + 16 * 100
    f, b = counts.blend_bwd(w)
    assert f == 13 * 10 + 50 * 8 and b == 72 * 5 + 8 * 2 + 32 * 100
    pk = counts.peaks()
    assert counts.bound_seconds(67e12, 0, pk) == 1.0
    assert counts.step_flops(w) > counts.frame_flops(w) > 0
