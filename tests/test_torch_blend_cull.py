"""The per-warp cull of the tile-blend kernels K1 and K2, held on the CPU
through its plain PyTorch mirror `patch_cull_plain` (the kernels themselves
run only on the card, where chip_smoke.py holds them against the plain
versions on cull-stressing scenes):

  * it is conservative: it never drops a (patch, instance) pair in which
    the plain decision path accepts some pixel of the patch;
  * applied inside the plain versions (`cull=True`) it changes no bit;
  * it does cull: most (patch, instance) pairs of a bound-avatar stream go;
  * the constants of `csrc/blend_common.cuh` are those of
    `ops/tile_blend.py`, and an edited header gives a new library name.
"""

import re
import shutil

import numpy as np
import pytest
import torch

from gaussianavatars_torch import kernels
from gaussianavatars_torch.benchmark import (
    bench_camera, blend_inputs, bound_bench_scene, make_bound_bench_model,
)
from gaussianavatars_torch.ops import tile_blend as tblend
from gaussianavatars_torch.ops.binning_dense import tile_grid

from .test_torch_blend import (  # noqa: F401
    CASES, WIDTH, _case, one_torch_thread,
)

HEADER = kernels.CSRC_DIR / "blend_common.cuh"
BLEND_KERNELS = ("blend_fwd", "blend_bwd")     # the kernels of the header
# (tile_size, patch_w, patch_h): the kernels' 8x4 patches and other shapes
# a warp could own
SHAPES = [(16, 8, 4), (16, 16, 2), (32, 8, 4), (32, 16, 8), (32, 32, 4)]
# the culled share of (patch, instance) pairs on the 160x120 bound avatar
# measures 0.655 at tile 16 and 0.873 at tile 32 (8x4 patches); the floors
# leave room for other platforms' rounding
CULLED_SHARE_FLOOR = {16: 0.5, 32: 0.75}


def _stress_stream(seed, tile_size, width, height, per_tile=48):
    """A (K, 9) stream and ranges made directly (no projection): per tile
    a mix of ordinary, huge, needle-thin, border-centred and
    threshold-opacity Gaussians, centred in and around the tile."""
    rng = np.random.default_rng(seed)
    ntx, nty = tile_grid(width, height, tile_size)
    rows, ranges = [], []
    for tile in range(ntx * nty):
        x0, y0 = tile % ntx * tile_size, tile // ntx * tile_size
        n = int(rng.integers(0, per_tile))
        kind = rng.integers(0, 5, n)
        mean = np.stack([x0 + rng.uniform(-40, tile_size + 40, n),
                         y0 + rng.uniform(-40, tile_size + 40, n)], 1)
        # covariance eigenvalues (the projection's 0.3 px^2 blur is the
        # floor) and a random orientation
        lam1 = np.exp(rng.uniform(np.log(0.3), np.log(60.0), n))
        lam2 = np.exp(rng.uniform(np.log(0.3), np.log(60.0), n))
        huge = kind == 1
        lam1[huge] = np.exp(rng.uniform(np.log(1e4), np.log(1e6),
                                        huge.sum()))
        lam2[huge] = lam1[huge] * rng.uniform(0.5, 1.0, huge.sum())
        needle = kind == 2
        lam1[needle] = np.exp(rng.uniform(np.log(1e3), np.log(1e5),
                                          needle.sum()))
        lam2[needle] = 0.3
        border = kind == 3          # on patch and tile borders, exactly
        mean[border] = np.stack([
            x0 + 4.0 * rng.integers(0, tile_size // 4 + 1, border.sum()),
            y0 + 2.0 * rng.integers(0, tile_size // 2 + 1, border.sum())], 1)
        mean[border] -= 0.5 * rng.integers(0, 2, (border.sum(), 1))
        theta = rng.uniform(0, np.pi, n)
        c, s = np.cos(theta), np.sin(theta)
        sxx = lam1 * c * c + lam2 * s * s
        sxy = (lam1 - lam2) * c * s
        syy = lam1 * s * s + lam2 * c * c
        det = sxx * syy - sxy * sxy
        conic = np.stack([syy / det, -sxy / det, sxx / det], 1)
        opacity = rng.uniform(0.01, 0.99, n)
        faint = kind == 4           # at and around the 1/255 threshold
        opacity[faint] = (1.0 / 255.0) * rng.choice(
            [1.0 - 1e-6, 1.0, 1.0 + 1e-6, 1.0 + 1e-3, 1.1, 2.0], faint.sum())
        rows.append(np.concatenate(
            [mean, conic, rng.uniform(0, 1, (n, 3)), opacity[:, None]], 1))
        ranges.append(n)
    ends = np.cumsum(ranges)
    inst = torch.from_numpy(np.concatenate(rows).astype(np.float32))
    ranges = torch.from_numpy(
        np.stack([ends - ranges, ends], 1).astype(np.int32))
    return inst, ranges


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("tile_size,patch_w,patch_h", SHAPES)
def test_cull_never_drops_an_accepted_pair(tile_size, patch_w, patch_h, seed):
    width, height, py_offset = 75, 50, 16 * seed      # ragged edges, a slab
    inst, ranges = _stress_stream(seed, tile_size, width, height)
    keep = tblend.patch_cull_plain(inst, ranges, py_offset, width, height,
                                   tile_size, patch_w, patch_h)
    g = tblend._TileGrid(inst, ranges, py_offset, width, height, tile_size,
                         patch_w, patch_h)
    assert keep.shape == (g.num_tiles, g.num_patches, g.max_count)
    ones = torch.ones((g.num_tiles, g.p))
    never = torch.zeros((g.num_tiles, g.p), dtype=torch.bool)
    accepted_pairs = culled_pairs = 0
    for j in range(g.max_count):
        s = g.step(j, ones, never)
        accepted = s.live & (s.power <= 0.0) & (s.e >= tblend.ALPHA_MIN)
        by_patch = torch.zeros((g.num_tiles, g.num_patches), dtype=torch.int32)
        by_patch = by_patch.index_add_(1, g.patch_of_pixel,
                                       accepted.int()) > 0
        dropped = by_patch & ~keep[:, :, j]
        assert not dropped.any(), (
            f"position {j}: culled an accepted pair, rows "
            f"{g.rows(j)[dropped.any(1)]}")
        accepted_pairs += int(by_patch.sum())
        culled_pairs += int(((j < g.counts)[:, None] & ~keep[:, :, j]).sum())
    assert accepted_pairs > 100 and culled_pairs > 100     # not vacuous


@pytest.mark.parametrize("name", sorted(CASES))
def test_cull_changes_no_bit_of_the_plain_forward(name):
    c = _case(name)
    args = (c["port_inst"], c["port_ranges"], c["py_offset"], WIDTH,
            c["height"], c["tile_size"])
    (color, trans), work = tblend.blend_image_plain(*args, count_work=True)
    (color_c, trans_c), work_c = tblend.blend_image_plain(
        *args, count_work=True, cull=True)
    assert torch.equal(color, color_c) and torch.equal(trans, trans_c)
    assert work_c["blended"] == work["blended"]
    assert work_c["pairs"] < work["pairs"]


@pytest.mark.parametrize("name", sorted(CASES))
def test_cull_changes_no_bit_of_the_plain_backward(name):
    c = _case(name)
    args = (c["port_inst"], c["port_ranges"], c["py_offset"], WIDTH,
            c["height"], c["tile_size"])
    color, trans = tblend.blend_image_plain(*args)
    rng = np.random.default_rng(len(name))
    g_color = torch.from_numpy(rng.normal(size=tuple(color.shape)).astype(
        np.float32))
    g_trans = torch.from_numpy(rng.normal(size=tuple(trans.shape)).astype(
        np.float32))
    grad = tblend.blend_image_bwd_plain(*args, color, trans, g_color, g_trans)
    grad_c = tblend.blend_image_bwd_plain(*args, color, trans, g_color,
                                          g_trans, cull=True)
    assert float(grad.abs().max()) > 0
    assert torch.equal(grad, grad_c)


@pytest.mark.parametrize("tile_size", [16, 32])
def test_cull_culls_most_of_a_bound_avatar_stream(tile_size):
    model = make_bound_bench_model(n_per_face=1, device="cpu")
    cam = bench_camera(160, 120, device="cpu")
    inst, ranges, args = blend_inputs(bound_bench_scene(model, 0), cam,
                                      tile_size)
    keep = tblend.patch_cull_plain(inst, ranges, *args)
    pairs = int(inst.shape[0]) * keep.shape[1]
    assert pairs > 10_000
    culled_share = 1.0 - int(keep.sum()) / pairs
    assert culled_share > CULLED_SHARE_FLOOR[tile_size], culled_share
    # and the image is the same bit for bit
    plain = tblend.blend_image_plain(inst, ranges, *args)
    culled = tblend.blend_image_plain(inst, ranges, *args, cull=True)
    assert torch.equal(plain[0], culled[0]) and torch.equal(plain[1],
                                                            culled[1])


def _header_number(name):
    text = HEADER.read_text()
    found = re.search(rf"constexpr \w+ {name} = ([^;\n]+)", text)
    assert found, name
    return float(eval(found.group(1).replace("f", ""), {}))


def test_header_constants_are_the_plain_versions():
    assert np.float32(_header_number("kAlphaMin")) == np.float32(
        tblend.ALPHA_MIN)
    assert np.float32(_header_number("kAlphaMax")) == np.float32(
        tblend.ALPHA_MAX)
    assert np.float32(_header_number("kTEps")) == np.float32(tblend.T_EPS)
    assert np.float32(_header_number("kCullAbs")) == np.float32(
        tblend.CULL_ABS)
    assert np.float32(_header_number("kCullRel")) == np.float32(
        tblend.CULL_REL)
    assert _header_number("kCols") == tblend.PACK_COLS
    assert (_header_number("kPatchW"),
            _header_number("kPatchH")) == tblend.PATCH_SHAPE


def test_both_kernels_take_the_decision_path_from_the_header():
    for name in BLEND_KERNELS:
        files = kernels.source_files(name)
        assert HEADER in files, name
        text = files[0].read_text()
        assert "decide(" in text and "walk_survivors" in text
        for word in ("expf(", "__fmul_rn(s.", "atomicAdd"):
            assert word not in text, f"{name}: {word} outside the header"


def test_library_name_follows_an_included_header(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC_DIR, csrc)
    before = {n: kernels.library_path(n, csrc=csrc) for n in kernels.SOURCES}
    assert before == {n: kernels.library_path(n, csrc=csrc)
                      for n in kernels.SOURCES}
    for n in kernels.SOURCES:      # the copy hashes like the original
        assert before[n] == kernels.library_path(n)
        assert before[n] != kernels.library_path(n, defines=("GA_COUNT=1",))
    header = csrc / HEADER.name
    header.write_text(header.read_text().replace(
        "kCullAbs = 1e-4f", "kCullAbs = 2e-4f"))
    for n in kernels.SOURCES:      # only the kernels that include it change
        changed = kernels.library_path(n, csrc=csrc) != before[n]
        assert changed == (n in BLEND_KERNELS), n
