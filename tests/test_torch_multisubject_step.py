"""`make_multisubject_train_step` for S = 2 subjects (those of
`test_torch_multisubject.py`) on 2 and 4 gloo CPU ranks
(`tests/torch_ranks.py`) against JAX's on a (2, 1) and a (2, 2) mesh, each
subject at the step gates of `test_torch_parallel.py::check_step_against_jax`
against the JAX step and its one-device step of the subject's view; the
losses are the mean over the subjects."""

import jax
import pytest

from gaussianavatars_tpu.config import OptimizationConfig as JaxOpt
from gaussianavatars_tpu.parallel.mesh import make_mesh as jax_make_mesh
from gaussianavatars_tpu.parallel.sharded import (
    make_multisubject_train_step as jax_multisubject_step,
)

from . import torch_ranks
from .test_torch_blend import one_torch_thread  # noqa: F401
from .test_torch_multisubject import subjects  # noqa: F401
from .test_torch_parallel import (
    JAX_PIPE,
    W,
    H,
    _jax_step_inputs,
    _rank_outputs,
    check_step_against_jax,
    jax_single_steps,
)


@pytest.mark.parametrize("n_prim", [1, 2])
def test_multisubject_step_matches_jax(subjects, n_prim, tmp_path):
    root, jmodel = subjects["root"], subjects["jmodel"]
    n = jmodel.n_alive
    for name in ("model0.npz", "model1.npz", "views.npz"):
        (tmp_path / name).write_bytes((root / name).read_bytes())
    torch_ranks.run_ranks(torch_ranks.train_step, 2 * n_prim, tmp_path,
                          n_data=2, width=W, height=H, tile_size=32,
                          subjects=True)
    step = jax_multisubject_step(jax_make_mesh(n_data=2, n_prim=n_prim),
                                 jmodel, JaxOpt(), JAX_PIPE, W, H,
                                 sh_degree=3)
    jout = step(*_jax_step_inputs(jmodel, subjects["cams"], subjects["views"],
                                  subjects=subjects["pairs"]))
    for d, (params, flame_tr) in enumerate(subjects["pairs"]):
        port = _rank_outputs(tmp_path, range(d * n_prim, (d + 1) * n_prim))
        assert set(k[5:] for k in port if k.startswith("loss_")) == \
            {"l1", "ssim", "xyz", "scale", "total"}
        views = {k: v[d:d + 1] for k, v in subjects["views"].items()
                 if k in ("gts", "bgs", "timesteps")}
        views.update({k.replace(f"c{d}_", "c0_"): v for k, v in
                      subjects["views"].items() if k.startswith(f"c{d}_")})
        singles = jax_single_steps(jmodel, params, flame_tr,
                                   [subjects["cams"][d]], views)
        mine = tuple(jax.tree.map(lambda x: x[d], jout[i])
                     for i in range(6)) + (jout[6],) + tuple(
            x[d] for x in jout[7:10]) + tuple(jout[10:])
        check_step_against_jax(port, mine, singles, n, False, f"s{d} ")
