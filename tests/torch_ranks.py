"""Spawned torch.distributed ranks for the port's parallel tests.

Each rank is a fresh process (multiprocessing "spawn") that imports torch
and the port only, never JAX: it joins a gloo process group through a
`file://` rendezvous in the test's temporary directory, runs one of the
functions below and writes its outputs with `np.save` / `np.savez` for the
parent test to compare. `run_ranks` joins every rank with a timeout and
fails the test (killing what is left) if a rank raises or hangs.
"""

import datetime
import multiprocessing
import os
import traceback

import numpy as np

RANK_TIMEOUT_S = 240     # a whole rank run, joined by the parent
GROUP_TIMEOUT_S = 120    # one collective, inside the ranks


def _entry(fn, rank, world, root, kwargs):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        from gaussianavatars_torch.parallel.distributed import (
            initialize_distributed,
        )

        initialize_distributed(f"file://{root}/rendezvous", world, rank,
                               backend="gloo", device="cpu",
                               timeout_s=GROUP_TIMEOUT_S)
        fn(rank, world, root, **kwargs)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        os._exit(1)


def run_ranks(fn, world, root, timeout=RANK_TIMEOUT_S, **kwargs):
    """Run fn(rank, world, root, **kwargs) on `world` gloo CPU ranks."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(fn, r, world, str(root),
                                              kwargs))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=timeout)
    for p in procs:
        p.join(max(1.0, (deadline - datetime.datetime.now()).total_seconds()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    codes = [p.exitcode for p in procs]
    assert not hung, f"ranks {hung} did not finish in {timeout} s"
    assert codes == [0] * world, f"rank exit codes {codes}"


def _camera(d, prefix=""):
    import torch

    from gaussianavatars_torch.train.loop import CameraArrays

    return CameraArrays(
        viewmatrix=torch.from_numpy(d[prefix + "viewmatrix"]),
        projmatrix=torch.from_numpy(d[prefix + "projmatrix"]),
        campos=torch.from_numpy(d[prefix + "campos"]),
        tan_fovx=float(d[prefix + "tan_fovx"]),
        tan_fovy=float(d[prefix + "tan_fovy"]))


def sharded_render(rank, world, root, width, height, sh_degree, tile_size):
    """make_sharded_render of the unbound scene in scene.npz over a
    (1, world) mesh; writes image_<rank>.npy."""
    import torch

    from gaussianavatars_torch.models.gaussians import GaussianParams
    from gaussianavatars_torch.parallel import (
        make_mesh,
        make_sharded_render,
    )

    d = np.load(f"{root}/scene.npz")
    params = GaussianParams(**{k: torch.from_numpy(d[k])
                               for k in GaussianParams._fields})
    mesh = make_mesh(1, world)
    assert (mesh.data_index, mesh.prim_index) == (0, rank)
    render = make_sharded_render(mesh, width, height, sh_degree, tile_size,
                                 bound=False)
    image = render(params, None, None, _camera(d), torch.ones(3))
    np.save(f"{root}/image_{rank}.npy", image.numpy())


def _carried_model(path):
    """The port's model from the arrays a test wrote with `save_model`."""
    from gaussianavatars_torch.convert import from_jax_arrays

    m = np.load(path)
    return from_jax_arrays(
        {k[2:]: m[k] for k in m.files if k.startswith("p_")}, m["binding"],
        {k[2:]: m[k] for k in m.files if k.startswith("f_")},
        sh_degree=int(m["sh_degree"]), n_alive=int(m["n_alive"]),
        flame_model_path=str(m["flame_model"]),
        flame_template_mesh_path=str(m["flame_obj"]), spatial_lr_scale=1.0,
        device="cpu")


def save_model(path, params, binding, flame_param, sh_degree, flame_paths,
               n_alive):
    """Write a JAX model's numpy arrays (capacity rows, the first n_alive
    live) for `_carried_model`."""
    np.savez(path, binding=binding, sh_degree=sh_degree, n_alive=n_alive,
             flame_model=flame_paths["model"], flame_obj=flame_paths["obj"],
             **{f"p_{k}": v for k, v in params.items()},
             **{f"f_{k}": v for k, v in flame_param.items()})


def train_step(rank, world, root, n_data, width, height, tile_size,
               subjects):
    """One make_sharded_train_step (or, with `subjects`,
    make_multisubject_train_step: data group d trains model<d>.npz) over an
    (n_data, world // n_data) mesh from model0.npz and the views in
    views.npz; writes this rank's shard of the result to out_<rank>.npz."""
    import torch

    from gaussianavatars_torch.config import (
        OptimizationConfig,
        PipelineConfig,
    )
    from gaussianavatars_torch.convert import shard_from_jax
    from gaussianavatars_torch.models.gaussians import GaussianParams
    from gaussianavatars_torch.parallel import make_mesh
    from gaussianavatars_torch.parallel.sharded import (
        make_multisubject_train_step,
        make_sharded_train_step,
        shard_state,
    )
    from gaussianavatars_torch.train.loop import initial_state, lr_pytree

    mesh = make_mesh(n_data, world // n_data)
    d = mesh.data_index
    model = _carried_model(f"{root}/model{d if subjects else 0}.npz")
    state = shard_state(initial_state(model), mesh)
    path = f"{root}/model{d if subjects else 0}.npz"
    with np.load(path) as m:
        carried = shard_from_jax(
            {k: m[f"p_{k}"] for k in GaussianParams._fields},
            int(m["n_alive"]), mesh, device="cpu")
    for k, v in carried.items():
        assert torch.equal(v, getattr(state.params, k)), k
    before = {f"before_{k}": getattr(state.params, k).numpy().copy()
              for k in GaussianParams._fields}
    fixed = {k: v for k, v in model.flame_param.items()
             if k not in state.flame_tr}
    opt = OptimizationConfig()
    make = make_multisubject_train_step if subjects \
        else make_sharded_train_step
    step = make(mesh, model, opt, PipelineConfig(tile_size=tile_size),
                width, height, model.max_sh_degree)
    v = np.load(f"{root}/views.npz")
    n = model.num_gaussians
    state, losses, instances = step(
        state, fixed, model.binding[mesh.shard(n)], _camera(v, f"c{d}_"),
        torch.from_numpy(v["gts"][d]), torch.from_numpy(v["bgs"][d]),
        int(v["timesteps"][d]), lr_pytree(opt, 1e-3, state.flame_tr, 1.0), n)
    out = {"count": state.count, "instances": instances, **before,
           "max_radii2d": state.max_radii2d.numpy(),
           "grad_accum": state.grad_accum.numpy(),
           "denom": state.denom.numpy()}
    for k in GaussianParams._fields:
        out[f"mu_{k}"] = getattr(state.mu["gauss"], k).numpy()
        out[f"param_{k}"] = getattr(state.params, k).numpy()
    out.update({f"fmu_{k}": v.numpy() for k, v in state.mu["flame"].items()})
    out.update({f"loss_{k}": float(v) for k, v in losses.items()})
    np.savez(f"{root}/out_{rank}.npz", **out)


def train_loop(rank, world, root, data, assets, out, schedule,
               render_parallel, data_parallel=1):
    """`training` on the mesh (data_parallel, render_parallel) with the
    dataset at `data`; writes loop_<rank>.npz (EMA history, Adam count,
    densifications, Gaussians, final xyz) and saves_<rank>.npy (the PLY
    writes this rank made)."""
    os.environ["FLAME_ASSET_DIR"] = assets
    from gaussianavatars_torch.config import (
        ModelConfig,
        OptimizationConfig,
        PipelineConfig,
    )
    from gaussianavatars_torch.models.flame_gaussians import (
        FlameGaussianModel,
    )
    from gaussianavatars_torch.train.loop import training

    saves = []
    save_ply = FlameGaussianModel.save_ply

    def counted(self, path):
        saves.append(path)
        return save_ply(self, path)

    FlameGaussianModel.save_ply = counted
    model, state, info = training(
        ModelConfig(source_path=data, model_path=out, bind_to_mesh=True,
                    eval=True, sh_degree=1),
        OptimizationConfig(**schedule),
        PipelineConfig(tile_size=16, data_parallel=data_parallel,
                       render_parallel=render_parallel),
        saving_iterations={schedule["iterations"]}, log_every=1,
        device="cpu")
    np.savez(f"{root}/loop_{rank}.npz",
             history=[v for _, v in info["history"]], count=state.count,
             densify=info["summary"]["densify"], n=model.num_gaussians,
             xyz=state.params.xyz.numpy())
    np.save(f"{root}/saves_{rank}.npy", len(saves))


def gather_round_trip(rank, world, root, n):
    """On a (1, world) mesh: `shard_state` then `gather_state` of a random
    n-Gaussian state give it back to the bit, and `GatherRows`'s backward
    sums every rank's cotangent onto the owner's rows; writes
    ok_<rank>.npy."""
    import torch

    from gaussianavatars_torch.models.gaussians import GaussianParams
    from gaussianavatars_torch.parallel import make_mesh
    from gaussianavatars_torch.parallel.sharded import (
        gather_rows,
        gather_state,
        shard_state,
    )
    from gaussianavatars_torch.train import optim
    from gaussianavatars_torch.train.loop import StepState

    gen = torch.Generator().manual_seed(0)
    widths = dict(xyz=3, features_dc=3, features_rest=9, scaling=3,
                  rotation=4, opacity=1)

    def tree():
        return GaussianParams(**{k: torch.randn(n, c, generator=gen)
                                 for k, c in widths.items()})

    flame = {"expr": torch.randn(2, 5, generator=gen)}
    full = StepState(params=tree(), flame_tr=flame,
                     mu={"gauss": tree(), "flame": flame},
                     nu={"gauss": tree(), "flame": flame}, count=3,
                     max_radii2d=torch.randn(n, generator=gen),
                     grad_accum=torch.randn(n, generator=gen),
                     denom=torch.randn(n, generator=gen))
    mesh = make_mesh(1, world)
    shard = shard_state(full, mesh)
    rows = mesh.shard(n)
    assert shard.params.xyz.shape[0] == rows.stop - rows.start
    back = gather_state(shard, mesh, n)
    for a, b in zip(optim.tree_leaves(back[:-4] + back[-3:]),
                    optim.tree_leaves(full[:-4] + full[-3:])):
        assert torch.equal(a, b)
    assert back.count == 3

    x = shard.params.xyz.clone().requires_grad_()
    block = mesh.shard_rows(n)
    gathered = gather_rows(x, block, mesh)
    assert gathered.shape == (world * block, 3)
    assert torch.equal(gathered[:n], full.params.xyz)
    base = torch.arange(gathered.numel(), dtype=torch.float32).reshape(
        gathered.shape)
    (gathered * base * (rank + 1)).sum().backward()
    start = rank * block
    want = base[start:start + x.shape[0]] * (world * (world + 1) / 2)
    assert torch.equal(x.grad, want)
    np.save(f"{root}/ok_{rank}.npy", np.ones(1))
