"""The port's serving slice end to end: the FLAME-bound avatar carried
across from the JAX package renders as JAX `make_render_fn` does (jnp
backend, atol 5e-5), the entry point runs on the CPU when asked and raises
without a GPU otherwise, and the port imports nothing of JAX, of the JAX
package, of the tests, nor PIL, tqdm or tensorboardX."""

import ast
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianavatars_tpu.benchmark import (
    make_bound_bench_model as jax_bound_model,
)
from gaussianavatars_tpu.config import PipelineConfig as JaxPipeline
from gaussianavatars_tpu.train.loop import (
    binding_arg,
    camera_arrays as jax_camera_arrays,
    make_render_fn as jax_make_render_fn,
)
from gaussianavatars_torch import benchmark as tbench
from gaussianavatars_torch import (
    fps_benchmark_dataset,
    fps_benchmark_demo,
    kernels,
)
from gaussianavatars_torch import metrics as metrics_cli
from gaussianavatars_torch.metrics_lib.lpips import LPIPS
from gaussianavatars_torch.models.gaussians import GaussianModel
from gaussianavatars_torch.render import __main__ as render_cli
from gaussianavatars_torch.config import PipelineConfig
from gaussianavatars_torch.convert import from_jax_arrays
from gaussianavatars_torch.device import resolve_device
from gaussianavatars_torch.train.loop import camera_arrays, make_render_fn

from .flame_fixtures import make_flame_assets
from .utils import make_camera
from .test_torch_blend import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 64, 48


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """The JAX bound bench avatar (1 Gaussian per face, SH 3) and the
    port's copy of it made with from_jax_arrays."""
    jmodel = jax_bound_model(sh_degree=3, n_per_face=1, seed=0,
                             num_timesteps=4)
    # the JAX builder's FLAME assets come from this same seeded generator
    paths = make_flame_assets(str(tmp_path_factory.mktemp("flame")), seed=0)
    params = {k: np.asarray(getattr(jmodel.params, k))
              for k in jmodel.params._fields}
    flame_param = {k: np.asarray(v) for k, v in jmodel.flame_param.items()}
    tmodel = from_jax_arrays(
        params, jmodel.binding, flame_param, sh_degree=3,
        n_alive=jmodel.n_alive, flame_model_path=paths["model"],
        flame_template_mesh_path=paths["obj"], device="cpu")
    return jmodel, tmodel


def test_render_matches_jax(carried):
    jmodel, tmodel = carried
    assert tmodel.num_gaussians == jmodel.n_alive == 10144
    jcam = make_camera(width=W, height=H, fovx=0.5, dist=1.0)
    jpipe = JaxPipeline(backend="jnp", capacity=1 << 16, chunk=16,
                        tile_size=32, binning="dense")
    jrender = jax_make_render_fn(jmodel, jpipe, W, H, 3)
    tcam = tbench.bench_camera(W, H, device="cpu")
    for name in ("viewmatrix", "projmatrix", "campos"):
        np.testing.assert_array_equal(getattr(tcam, name).numpy(),
                                      np.asarray(getattr(jcam, name)))
    trender = make_render_fn(tmodel, PipelineConfig(), W, H, 3)
    bg = np.ones(3, np.float32)
    for timestep in (0, 2):
        ref = jrender(jmodel.params, dict(jmodel.flame_param),
                      binding_arg(jmodel), jmodel.active_mask(),
                      jax_camera_arrays(jcam), jnp.asarray(bg),
                      jnp.int32(timestep))
        out = trender(tmodel.params, tmodel.flame_param, tmodel.binding,
                      camera_arrays(tcam), torch.from_numpy(bg), timestep)
        assert out.instance_total > 0
        assert out.image.std() > 0.01
        np.testing.assert_allclose(out.image.numpy(), np.asarray(ref),
                                   atol=5e-5, rtol=0,
                                   err_msg=f"timestep {timestep}")


def test_port_builds_the_jax_bench_avatar(carried):
    jmodel, tmodel = carried
    model = tbench.make_bound_bench_model(sh_degree=3, n_per_face=1, seed=0,
                                          device="cpu")
    for k in model.params._fields:
        # local scaling = log(world scale / face scale): the face scale of
        # near-degenerate synthetic triangles carries float32 frame drift
        atol = 1e-4 if k == "scaling" else 0.0
        np.testing.assert_allclose(getattr(model.params, k).numpy(),
                                   getattr(tmodel.params, k).numpy(),
                                   atol=atol, rtol=0, err_msg=k)
    assert torch.equal(model.binding, tmodel.binding)
    for k, v in model.flame_param.items():
        torch.testing.assert_close(v, tmodel.flame_param[k], atol=0, rtol=0)


def test_entry_point_on_cpu():
    fps = fps_benchmark_demo.main([
        "--device", "cpu", "--n_iter", "2", "--n_rounds", "1",
        "--width", str(W), "--height", str(H), "--n_per_face", "1"])
    assert len(fps) == 1 and fps[0] > 0


def test_entry_points_raise_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError):
        fps_benchmark_demo.main(["--n_iter", "1", "--n_rounds", "1"])
    with pytest.raises(RuntimeError):
        tbench.make_bench_scene(n=10)
    with pytest.raises(RuntimeError):
        fps_benchmark_demo.main(["--point_path", str(tmp_path / "p.ply"),
                                 "--n_iter", "1", "--n_rounds", "1"])
    with pytest.raises(RuntimeError):
        render_cli.main(["-m", str(tmp_path)])
    with pytest.raises(RuntimeError):
        fps_benchmark_dataset.main(["-m", str(tmp_path)])
    with pytest.raises(RuntimeError):
        metrics_cli.main(["-m", str(tmp_path)])
    with pytest.raises(RuntimeError):
        LPIPS(str(tmp_path / "weights.npz"))
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_models_default_to_the_gpu():
    """A model built without parameters lives on cuda unless asked."""
    assert GaussianModel(3).device == torch.device("cuda")
    assert GaussianModel(3, device="cpu").device == torch.device("cpu")


def test_kernel_build_raises_without_nvcc():
    try:
        kernels._nvcc()
    except RuntimeError:
        with pytest.raises(RuntimeError):
            kernels.load("blend_fwd")
    else:
        pytest.skip("nvcc is present")


FORBIDDEN = ("jax", "jaxlib", "gaussianavatars_tpu", "tests", "PIL", "tqdm",
             "tensorboardX", "tensorboard", "dearpygui")
# imported only inside the function that needs it: the viewers' dearpygui
# shells (`main` of local_viewer.py and remote_viewer.py), which the hosts
# without a display never run
SHELLS_ONLY = {"dearpygui": ("local_viewer.py", "remote_viewer.py")}
# the offline tools' modules, the COLMAP reader, the quality protocols, the
# viewers, the parallel and multi-subject training, the sort binning, the
# oracle rasterizer and the diagnostic tools, which the GPU host must
# import as well
NEW_MODULES = ("gaussianavatars_torch.metrics",
               "gaussianavatars_torch.metrics_lib.lpips",
               "gaussianavatars_torch.models.flame_mask_tables",
               "gaussianavatars_torch.render.__main__",
               "gaussianavatars_torch.render.mesh_renderer",
               "gaussianavatars_torch.data.colmap",
               "gaussianavatars_torch.examples.bound_avatar_recovery",
               "gaussianavatars_torch.examples.synthetic_recovery",
               "gaussianavatars_torch.viewer.orbit_camera",
               "gaussianavatars_torch.viewer.network_gui",
               "gaussianavatars_torch.viewer.remote_client",
               "gaussianavatars_torch.local_viewer",
               "gaussianavatars_torch.remote_viewer",
               "gaussianavatars_torch.fps_benchmark_dataset",
               "gaussianavatars_torch.utils.tensorboard",
               "gaussianavatars_torch.utils.jpeg",
               "gaussianavatars_torch.utils.nvjpeg",
               "gaussianavatars_torch.parallel.mesh",
               "gaussianavatars_torch.parallel.distributed",
               "gaussianavatars_torch.parallel.sharded",
               "gaussianavatars_torch.train.multisubject",
               "gaussianavatars_torch.bench_multisubject",
               "gaussianavatars_torch.ops.binning",
               "gaussianavatars_torch.ops.rasterize_reference",
               "gaussianavatars_torch.tools.parity_vs_reference",
               "gaussianavatars_torch.tools.diag_eval_views")


def test_port_imports_no_jax():
    """Importing every module of the port loads none of FORBIDDEN beyond
    what numpy and torch load themselves (the GPU host has no JAX, PIL,
    tqdm, tensorboardX or dearpygui, and maybe no tensorboard; this host's
    torch imports tqdm)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import numpy, torch\n"
        "before = set(sys.modules)\n"
        "import gaussianavatars_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "'gaussianavatars_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in set(sys.modules) - before\n"
        f"       if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert len(mods) >= 30, mods\n"
        f"assert not set({NEW_MODULES!r}) - set(mods), mods\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _imported_names(path, in_functions=True):
    """The modules the file's import statements name; without
    `in_functions`, only the statements outside any function."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names = []

    def visit(node, in_function):
        if isinstance(node, ast.Import) and (in_functions or not in_function):
            names.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and (in_functions
                                                   or not in_function):
            names.append("." if node.level else node.module or "")
        inner = in_function or isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda))
        for child in ast.iter_child_nodes(node):
            visit(child, inner)

    visit(tree, False)
    return names


def test_port_sources_import_no_jax():
    """No import statement of the port, at module level or inside a
    function, names a module of FORBIDDEN, except dearpygui inside the
    viewers' shells (SHELLS_ONLY)."""
    sources = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "gaussianavatars_torch")):
        sources += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(sources) >= 35
    for name in NEW_MODULES:
        assert os.path.join(REPO, *name.split(".")) + ".py" in sources, name
    shells = set()
    for path in sources:
        top_level = _imported_names(path, in_functions=False)
        for name in _imported_names(path):
            root = name.split(".")[0]
            if os.path.basename(path) in SHELLS_ONLY.get(root, ()) and \
                    name not in top_level:
                shells.add(os.path.basename(path))
                continue
            assert root not in FORBIDDEN, (path, name)
    assert shells == set(SHELLS_ONLY["dearpygui"])


def test_chip_smoke_imports_no_jax():
    names = _imported_names(os.path.join(REPO, "chip_smoke.py"))
    assert "gaussianavatars_torch.train.loop" in names
    for name in names:
        assert name.split(".")[0] not in FORBIDDEN, name
