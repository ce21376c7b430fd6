"""Gaussian splat cloud: parameters, the binding chain, the densification
engine and IO (port of `gaussianavatars_tpu/models/gaussians.py`; reference
scene/gaussian_model.py).

The port holds exactly the live Gaussians: there are no capacity buckets,
dead padding slots or alive masks, so every surgery (clone, split, prune,
the sort by binding) makes tensors of the new length on the model's device.
The binding chain's per-Gaussian gather of the face frames is a plain
`index_select`, whose transpose is autograd's `index_add_`; the JAX
package's sorted segmented gather exists for the TPU and is not ported.

PLY files and checkpoints are bit-compatible with the JAX package's (and
the PLY files with the reference's, `binding_0` included), so artifacts
move between the two packages both ways.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from gaussianavatars_torch.ops.knn import mean_sq_dist_to_3nn
from gaussianavatars_torch.ops.quaternion import (
    quat_multiply,
    quat_normalize,
    quat_to_rotmat,
)
from gaussianavatars_torch.ops.sh import rgb2sh
from gaussianavatars_torch.utils import ply as plyio


def inverse_sigmoid(x):
    return np.log(x / (1.0 - x))


class GaussianParams(NamedTuple):
    """Raw parameters of N Gaussians.

    SH features are flat 2D: `features_dc` [N, 3] and `features_rest`
    [N, 3*(K-1)] CHANNEL-major (all K-1 red coeffs, then green, then blue;
    the reference PLY f_rest_* order).
    """

    xyz: torch.Tensor            # [N, 3] local (bound) or world (unbound)
    features_dc: torch.Tensor    # [N, 3]
    features_rest: torch.Tensor  # [N, 3*(K-1)] flat channel-major blocks
    scaling: torch.Tensor        # [N, 3] log-scale
    rotation: torch.Tensor       # [N, 4] wxyz (unnormalized)
    opacity: torch.Tensor        # [N, 1] logit


class FaceFrames(NamedTuple):
    """Per-triangle rigid frames of the driven mesh."""

    center: torch.Tensor       # [F, 3]
    orient_mat: torch.Tensor   # [F, 3, 3] columns (a0, a1, a2)
    orient_quat: torch.Tensor  # [F, 4] wxyz
    scaling: torch.Tensor      # [F, 1]
    table: torch.Tensor        # [F, 17]: orient 9 | scale | center 3 | quat 4


class AdamState(NamedTuple):
    """The Adam moments of the Gaussian parameters and the step count."""

    mu: GaussianParams
    nu: GaussianParams
    count: int


class GaussianModel:
    """Gaussian cloud on one device: the parameters, the densification
    statistics the train step accumulates, the binding (None unbound) and
    the host engine that grows, prunes, saves and restores them.

    `active_sh_degree` starts at `sh_degree`, what a served model renders
    with; `create_from_pcd` starts training at 0 and `load_ply` sets the
    maximum, as the JAX package does. Without `params` the model lives on
    `device` (default cuda, as every entry point of the port).
    """

    def __init__(self, sh_degree: int, params: Optional[GaussianParams] = None,
                 device: str | torch.device = "cuda"):
        self.max_sh_degree = sh_degree
        self.active_sh_degree = sh_degree
        self.params = params
        self._device = torch.device(device)
        self.binding: Optional[torch.Tensor] = None          # [N] int64
        self.binding_counter: Optional[torch.Tensor] = None  # [F] int64
        self.spatial_lr_scale = 0.0
        self.max_radii2d: Optional[torch.Tensor] = None          # [N]
        self.xyz_gradient_accum: Optional[torch.Tensor] = None   # [N]
        self.denom: Optional[torch.Tensor] = None                # [N]
        self.opt_state: Optional[tuple] = None   # (mu, nu, count)
        self.num_timesteps = 1

    @property
    def device(self) -> torch.device:
        return self.params.xyz.device if self.params is not None \
            else self._device

    @property
    def num_gaussians(self) -> int:
        return 0 if self.params is None else self.params.xyz.shape[0]

    @property
    def n_sh_coeffs(self) -> int:
        return (self.max_sh_degree + 1) ** 2

    def one_up_sh_degree(self):
        if self.active_sh_degree < self.max_sh_degree:
            self.active_sh_degree += 1

    def reset_stats(self):
        """Zero the densification statistics, one entry per Gaussian."""
        zeros = torch.zeros(self.num_gaussians, dtype=torch.float32,
                            device=self.device)
        self.max_radii2d = zeros
        self.xyz_gradient_accum = zeros.clone()
        self.denom = zeros.clone()

    def _install(self, arrays: dict):
        """Make `arrays` (GaussianParams fields) the parameters and zero the
        statistics."""
        self.params = GaussianParams(**{
            k: torch.as_tensor(arrays[k], dtype=torch.float32,
                               device=self.device).contiguous()
            for k in GaussianParams._fields})
        self.reset_stats()

    def create_from_pcd(self, points: Optional[np.ndarray],
                        colors: Optional[np.ndarray],
                        spatial_lr_scale: float, seed: int = 0):
        """Initial Gaussians (reference scene/gaussian_model.py:172-206).

        Bound (`points` None): one per binding entry at the face's origin,
        unit local scale, a random dark DC colour from
        `numpy.random.default_rng(seed)`. Unbound: one per point, coloured
        by the point, scaled by the mean squared distance to its 3 nearest
        neighbours. Both with identity rotation and opacity 0.1, and SH
        degree 0 active.
        """
        self.spatial_lr_scale = spatial_lr_scale
        rng = np.random.default_rng(seed)
        if points is None:
            if self.binding is None:
                raise ValueError("an unbound model needs a point cloud")
            n = len(self.binding)
            xyz = np.zeros((n, 3), np.float32)
            f_dc = (rng.random((n, 3)) / 255.0).astype(np.float32)
            scales = np.zeros((n, 3), np.float32)
        else:
            n = len(points)
            xyz = np.asarray(points, np.float32)
            f_dc = rgb2sh(torch.as_tensor(np.asarray(colors, np.float32))
                          ).numpy()
            dist2 = torch.clamp(mean_sq_dist_to_3nn(
                torch.as_tensor(xyz, device=self.device)), min=1e-7)
            scales = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)
        rots = np.zeros((n, 4), np.float32)
        rots[:, 0] = 1.0
        self._install(dict(
            xyz=xyz, features_dc=f_dc,
            features_rest=np.zeros((n, 3 * (self.n_sh_coeffs - 1)),
                                   np.float32),
            scaling=scales, rotation=rots,
            opacity=inverse_sigmoid(0.1 * np.ones((n, 1), np.float32))))
        self.active_sh_degree = 0

    # ------------------------------------------------------------------
    # Densification (reference scene/gaussian_model.py:334-519)
    # ------------------------------------------------------------------

    @torch.no_grad()
    def densify_and_prune(
        self,
        opt_state: AdamState,
        max_grad: float,
        min_opacity: float,
        extent: float,
        max_screen_size: Optional[float],
        percent_dense: float,
        face_scaling: Optional[torch.Tensor] = None,
        seed: int = 0,
        screen_size_prune: str = "reference",
    ) -> AdamState:
        """Clone, split and prune with the Adam moments cut and grown row by
        row, as the JAX package does (reference :446-515, with the bound
        path's world-scale thresholds, local-frame split samples, binding
        inheritance and the never-empty-a-face guard). The work runs on the
        model's device; the split samples are drawn on the host by one
        `numpy.random.default_rng(seed).normal(0, 1, (2 n_split, 3))`.

        `face_scaling` [F, 1] is the driven mesh's face scale (bound only).
        `screen_size_prune`: "reference" reproduces the reference's literal
        behaviour (no screen-size prune: its radii were zeroed before the
        test), "effective" prunes on the radii from before this call.
        Afterwards the binding is sorted (stably) and the statistics are
        zero. Returns the new Adam state; every tensor of the model and of
        the state passed in is replaced.
        """
        if screen_size_prune not in ("reference", "effective"):
            raise ValueError(f"screen_size_prune {screen_size_prune!r}")
        rng = np.random.default_rng(seed)
        dev = self.device
        n = self.num_gaussians
        p = self.params._asdict()
        mu, nu = opt_state.mu._asdict(), opt_state.nu._asdict()
        binding = self.binding
        counter = None if binding is None else self.binding_counter.clone()

        grads = torch.nan_to_num(
            self.xyz_gradient_accum / torch.clamp(self.denom, min=1e-12),
            nan=0.0)

        def world_scale_max(p_, binding_):
            s = torch.exp(p_["scaling"])
            if binding_ is not None:
                s = s * face_scaling[binding_]
            return s, s.amax(dim=1)

        def append(dst, src):
            return {k: torch.cat([dst[k], src[k]]) for k in dst}

        def zeros_of(src):
            return {k: torch.zeros_like(v) for k, v in src.items()}

        # clone: small Gaussians with a large screen gradient (:481-499)
        _, ws_max = world_scale_max(p, binding)
        clone = (grads >= max_grad) & (ws_max <= percent_dense * extent)
        new = {k: v[clone] for k, v in p.items()}
        p, mu, nu = append(p, new), append(mu, zeros_of(new)), \
            append(nu, zeros_of(new))
        if binding is not None:
            nb = binding[clone]
            binding = torch.cat([binding, nb])
            counter.index_add_(0, nb, torch.ones_like(nb))

        # split: large ones, each into 2 samples of itself (:446-479)
        n_split = 2
        padded_grad = torch.zeros(p["xyz"].shape[0], dtype=torch.float32,
                                  device=dev)
        padded_grad[:n] = grads
        ws, ws_max = world_scale_max(p, binding)
        split = (padded_grad >= max_grad) & (ws_max > percent_dense * extent)
        stds = ws[split]
        stds2 = stds.repeat(n_split, 1)
        samples = torch.as_tensor(
            rng.normal(0.0, 1.0, tuple(stds2.shape)).astype(np.float32),
            device=dev) * stds2
        rots2 = quat_to_rotmat(p["rotation"][split]).repeat(n_split, 1, 1)
        new_xyz = torch.einsum("nij,nj->ni", rots2, samples) \
            + p["xyz"][split].repeat(n_split, 1)
        if binding is not None:
            local_scale = stds / face_scaling[binding[split]]
            new_scaling = torch.log(local_scale.repeat(n_split, 1)
                                    / (0.8 * n_split))
        else:
            new_scaling = torch.log(stds2 / (0.8 * n_split))
        new = {k: p[k][split].repeat(n_split, 1) for k in p}
        new["xyz"], new["scaling"] = new_xyz, new_scaling
        p, mu, nu = append(p, new), append(mu, zeros_of(new)), \
            append(nu, zeros_of(new))
        if binding is not None:
            nb = binding[split].repeat(n_split)
            binding = torch.cat([binding, nb])
            counter.index_add_(0, nb, torch.ones_like(nb))
        # the split originals go
        prune_split = torch.cat([split, torch.zeros(
            n_split * stds.shape[0], dtype=torch.bool, device=dev)])
        p, mu, nu, binding, counter = self._prune(p, mu, nu, binding,
                                                  counter, prune_split)

        # prune: transparent or (optionally) oversized (:501-513)
        prune = 1.0 / (1.0 + torch.exp(-p["opacity"][:, 0])) < min_opacity
        if max_screen_size:
            _, ws_max = world_scale_max(p, binding)
            prune |= ws_max > 0.1 * extent
            if screen_size_prune == "effective":
                # the radii of the originals that were kept, in their
                # order at the head of the cloud; children have none yet
                radii = torch.zeros(p["xyz"].shape[0], dtype=torch.float32,
                                    device=dev)
                kept = torch.nonzero(~split[:n]).squeeze(1)
                radii[:kept.shape[0]] = self.max_radii2d[kept]
                prune |= radii > max_screen_size
        p, mu, nu, binding, counter = self._prune(p, mu, nu, binding,
                                                  counter, prune)

        if binding is not None:
            # sorted by face, stably: the JAX package keeps this order for
            # its segmented frame gather, and the two stay row for row equal
            order = torch.argsort(binding, stable=True)
            binding = binding[order]
            p = {k: v[order] for k, v in p.items()}
            mu = {k: v[order] for k, v in mu.items()}
            nu = {k: v[order] for k, v in nu.items()}
            self.binding, self.binding_counter = binding, counter
        self.params = GaussianParams(**p)
        self.reset_stats()
        return AdamState(mu=GaussianParams(**mu), nu=GaussianParams(**nu),
                         count=opt_state.count)

    @staticmethod
    def _prune(p, mu, nu, binding, counter, mask):
        """Drop the masked rows, except that no face loses its last Gaussian
        (reference scene/gaussian_model.py:371-398): where every Gaussian
        of a face is masked, none of them goes."""
        mask = mask.clone()
        if binding is not None:
            to_prune = binding[mask]
            counter_prune = torch.zeros_like(counter).index_add_(
                0, to_prune, torch.ones_like(to_prune))
            redundant = (counter - counter_prune) > 0
            mask[mask.clone()] = redundant[to_prune]
            gone = binding[mask]
            counter.index_add_(0, gone, -torch.ones_like(gone))
            binding = binding[~mask]
        keep = ~mask
        return ({k: v[keep] for k, v in p.items()},
                {k: v[keep] for k, v in mu.items()},
                {k: v[keep] for k, v in nu.items()}, binding, counter)

    @torch.no_grad()
    def reset_opacity(self, opt_state: AdamState) -> AdamState:
        """Clamp every opacity to at most 0.01 and zero its Adam moments
        (reference scene/gaussian_model.py:277-280, 334-347)."""
        opac = torch.clamp(torch.sigmoid(self.params.opacity), max=0.01)
        self.params = self.params._replace(
            opacity=torch.log(opac / (1.0 - opac)))
        return AdamState(
            mu=opt_state.mu._replace(
                opacity=torch.zeros_like(opt_state.mu.opacity)),
            nu=opt_state.nu._replace(
                opacity=torch.zeros_like(opt_state.nu.opacity)),
            count=opt_state.count)

    # ------------------------------------------------------------------
    # PLY interchange (reference scene/gaussian_model.py:253-332)
    # ------------------------------------------------------------------

    def save_ply(self, path: str):
        """The reference layout: x y z nx ny nz f_dc_* f_rest_* opacity
        scale_* rot_* [binding_0], float32 columns."""
        p = {k: getattr(self.params, k).detach().cpu().numpy()
             for k in GaussianParams._fields}
        n = self.num_gaussians
        cols = [(name, p["xyz"][:, i]) for i, name in enumerate("xyz")]
        cols += [(name, np.zeros(n, np.float32))
                 for name in ("nx", "ny", "nz")]
        # the flat channel-major features_rest IS the f_rest_* order
        cols += [(f"f_dc_{i}", p["features_dc"][:, i]) for i in range(3)]
        cols += [(f"f_rest_{i}", p["features_rest"][:, i])
                 for i in range(p["features_rest"].shape[1])]
        cols.append(("opacity", p["opacity"][:, 0]))
        cols += [(f"scale_{i}", p["scaling"][:, i]) for i in range(3)]
        cols += [(f"rot_{i}", p["rotation"][:, i]) for i in range(4)]
        if self.binding is not None:
            cols.append(("binding_0",
                         self.binding.cpu().numpy().astype(np.float32)))
        plyio.write_ply(path, [(k, np.ascontiguousarray(v, np.float32))
                               for k, v in cols])

    def load_ply(self, path: str, has_target: bool = False):
        """Read a PLY of `save_ply`'s layout (or the reference's); SH
        degree `max_sh_degree` becomes active."""
        del has_target      # FlameGaussianModel reads it
        d = plyio.read_ply(path)

        def stack(prefix):
            names = sorted((k for k in d if k.startswith(prefix)),
                           key=lambda s: int(s.split("_")[-1]))
            return np.stack([d[k] for k in names], 1).astype(np.float32)

        f_rest = stack("f_rest_")
        if f_rest.shape[1] != 3 * (self.n_sh_coeffs - 1):
            raise ValueError(
                f"{path} has {f_rest.shape[1]} f_rest columns, expected "
                f"{3 * (self.n_sh_coeffs - 1)} for SH degree "
                f"{self.max_sh_degree}")
        if "binding_0" in d:
            self.binding = torch.as_tensor(
                d["binding_0"].astype(np.int64), device=self.device)
            if self.binding_counter is not None:
                self.binding_counter = torch.bincount(
                    self.binding, minlength=self.binding_counter.shape[0])
        self._install(dict(
            xyz=np.stack([d["x"], d["y"], d["z"]], 1),
            features_dc=np.stack([d["f_dc_0"], d["f_dc_1"], d["f_dc_2"]], 1),
            features_rest=f_rest, scaling=stack("scale_"),
            rotation=stack("rot_"), opacity=d["opacity"][:, None]))
        self.active_sh_degree = self.max_sh_degree

    # ------------------------------------------------------------------
    # Training-state checkpoints (reference capture/restore :75-111)
    # ------------------------------------------------------------------

    def capture(self, opt_state: AdamState) -> dict:
        """The model and its Adam state as numpy arrays, under the JAX
        package's keys (`GaussianModel.capture`), so either package
        restores the other's checkpoints."""
        def host(t):        # a copy: on the CPU .numpy() would share
            return t.detach().to("cpu", copy=True).numpy()

        out = {
            # flat channel-major features_rest (the JAX package's "cmajor")
            "features_rest_layout": "cmajor",
            "active_sh_degree": self.active_sh_degree,
            "n_alive": self.num_gaussians,
            "spatial_lr_scale": self.spatial_lr_scale,
            "max_radii2d": host(self.max_radii2d),
            "xyz_gradient_accum": host(self.xyz_gradient_accum),
            "denom": host(self.denom),
            "adam_count": int(opt_state.count),
        }
        for k in GaussianParams._fields:
            out[f"param_{k}"] = host(getattr(self.params, k))
            out[f"mu_{k}"] = host(getattr(opt_state.mu, k))
            out[f"nu_{k}"] = host(getattr(opt_state.nu, k))
        if self.binding is not None:
            out["binding"] = host(self.binding).astype(np.int32)
            out["binding_counter"] = host(self.binding_counter).astype(
                np.int32)
        return out

    def restore(self, data: dict, source: str = "checkpoint") -> AdamState:
        """Load `capture`'s dict (from either package) into the model;
        returns the Adam state. Only the flat channel-major features_rest
        layout is read: a checkpoint without `features_rest_layout:
        cmajor` raises, naming `source`."""
        layout = str(np.asarray(data.get("features_rest_layout", "")))
        if layout != "cmajor":
            raise ValueError(
                f"{source}: features_rest_layout is {layout or 'missing'}; "
                "only checkpoints labelled 'cmajor' (flat channel-major "
                "features_rest) are read")
        n = int(data["n_alive"])
        dev = self.device

        def rows(a):
            return torch.as_tensor(np.asarray(a, np.float32)[:n], device=dev)

        self.active_sh_degree = int(data["active_sh_degree"])
        self.spatial_lr_scale = float(data["spatial_lr_scale"])
        if "binding" in data:
            self.binding = torch.as_tensor(
                np.asarray(data["binding"], np.int64)[:n], device=dev)
            self.binding_counter = torch.as_tensor(
                np.asarray(data["binding_counter"], np.int64), device=dev)
        self.params = GaussianParams(**{k: rows(data[f"param_{k}"])
                                        for k in GaussianParams._fields})
        self.max_radii2d = rows(data["max_radii2d"])
        self.xyz_gradient_accum = rows(data["xyz_gradient_accum"])
        self.denom = rows(data["denom"])
        return AdamState(
            mu=GaussianParams(**{k: rows(data[f"mu_{k}"])
                                 for k in GaussianParams._fields}),
            nu=GaussianParams(**{k: rows(data[f"nu_{k}"])
                                 for k in GaussianParams._fields}),
            count=int(data["adam_count"]))


def world_space_gaussians(
    params: GaussianParams,
    binding: Optional[torch.Tensor],
    frames: Optional[FaceFrames],
    return_face_scale: bool = False,
):
    """Activate raw params and (when bound) carry them into world space.

    Returns (means3d [N,3], scales [N,3], quats [N,4], opacities [N],
    shs [N, 3*K] flat channel-major), following the reference property
    chain get_xyz / get_scaling / get_rotation
    (scene/gaussian_model.py:113-150). With `return_face_scale` a sixth
    item is the gathered [N, 1] face scale (None unbound), which the scale
    regularizer reads.
    """
    scales = torch.exp(params.scaling)
    opacities = torch.sigmoid(params.opacity[:, 0])
    km = params.features_rest.shape[1] // 3
    dc, rest = params.features_dc, params.features_rest
    shs = torch.cat(
        [dc[:, 0:1], rest[:, :km],
         dc[:, 1:2], rest[:, km:2 * km],
         dc[:, 2:3], rest[:, 2 * km:]], dim=1)

    if binding is None:
        out = (params.xyz, scales, quat_normalize(params.rotation),
               opacities, shs)
        return (*out, None) if return_face_scale else out

    rows = frames.table.index_select(0, binding)         # (N, 17)
    face_scale = rows[:, 9:10]
    face_center = rows[:, 10:13]
    face_quat = quat_normalize(rows[:, 13:17])

    x, y, z = params.xyz[:, 0], params.xyz[:, 1], params.xyz[:, 2]
    wx = rows[:, 0] * x + rows[:, 1] * y + rows[:, 2] * z
    wy = rows[:, 3] * x + rows[:, 4] * y + rows[:, 5] * z
    wz = rows[:, 6] * x + rows[:, 7] * y + rows[:, 8] * z
    means3d = torch.stack([wx, wy, wz], dim=-1) * face_scale + face_center
    scales = scales * face_scale
    quats = quat_multiply(face_quat, quat_normalize(params.rotation))
    out = (means3d, scales, quats, opacities, shs)
    return (*out, face_scale) if return_face_scale else out
