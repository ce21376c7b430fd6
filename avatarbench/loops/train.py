"""Loop kind "train": a closed training loop, one view an iteration, in
seeded shuffled epochs over the rig's cameras and the motion's timesteps
(one timestep for an unbound model); the ground truth is one smooth image
per view. At every epoch's start the initial parameters, the Adam state
and the statistics are restored, so every window replays the same span of
training whatever its speed.

The comparison reads the window's own steps: from each epoch start that
the measured window reaches, the first `checked_steps` steps are read on
the device (each loss, the first gradient from the first moment after
step 1, m = (1 - beta1) g, and every leaf's change after the last), and
the last complete reading counts. The reference runs the same views from
the same initial state.
"""

from __future__ import annotations

import torch

from avatarbench import check, scene, traffic
from avatarbench.reference import flame as ref_flame
from avatarbench.reference import train as ref_train

B1 = 0.9                     # Adam's beta1, to read the first gradient


class TrainViews(traffic.Loop):
    FAULTS = ("half_rows", "unchanged")

    def __init__(self, cfg, tr, limits, seed, device):
        super().__init__(cfg, tr, limits, seed, device)
        inp = self.inputs
        rig = scene.rig(tr["cameras"], tr["yaw_deg"], tr["pitch"], tr["dist"])
        self.cams = [scene.camera(c, self.width, self.height, tr["fovx"],
                                  device) for c in rig]
        self.views = [(t, c) for t in range(inp.timesteps)
                      for c in range(len(rig))]
        self.gt = scene.smooth_images(seed, len(self.views), self.height,
                                      self.width, device,
                                      tuple(tr["gt_grid"]))
        from avatarbench.program import camera_arrays
        self.cam_arrays = [camera_arrays(c) for c in self.cams]
        self.step, self.state, self.fixed, self.lrs = self.prog.train_step(
            self.width, self.height)
        self.binding = self.prog.model.binding
        self.init = [x.detach().clone() for _, x in self._leaves(self.state)]
        self.k = 0                # iterations issued so far
        self.perms = {}
        self.pending = None       # the reading being taken
        self.reading = None       # the last complete reading
        self.check_k0 = None      # the epoch start it was taken from

    # -- the program's state ------------------------------------------------

    @staticmethod
    def _leaves(state):
        out = [(k, getattr(state.params, k)) for k in ref_train.GAUSS_KEYS]
        return out + [(f"flame.{k}", state.flame_tr[k])
                      for k in sorted(state.flame_tr)]

    @staticmethod
    def _moments(tree):
        out = [getattr(tree["gauss"], k) for k in ref_train.GAUSS_KEYS]
        return out + [tree["flame"][k] for k in sorted(tree["flame"])]

    def restore(self):
        """The initial parameters, zero moments and statistics."""
        with torch.no_grad():
            for (_, x), x0 in zip(self._leaves(self.state), self.init):
                x.copy_(x0)
            for m in self._moments(self.state.mu) + self._moments(
                    self.state.nu):
                m.zero_()
            for s in (self.state.grad_accum, self.state.denom,
                      self.state.max_radii2d):
                s.zero_()
        self.state = self.state._replace(count=0)

    def _drop_program_state(self):
        self.step = self.state = self.fixed = self.init = None
        self.cam_arrays = self.binding = None

    # -- the schedule -------------------------------------------------------

    def view(self, k: int) -> int:
        """The view of iteration k: epoch k // V in a seeded order."""
        v = len(self.views)
        e = k // v
        if e not in self.perms:
            g = torch.Generator().manual_seed(
                (self.seed * 7919 + 101 + e) % (1 << 63))
            self.perms = {e: torch.randperm(v, generator=g).tolist()}
        return self.perms[e][k % v]

    def iteration(self, mark=None):
        k, nv = self.k, len(self.views)
        if k and k % nv == 0:
            self.restore()
        if self.recording and k % nv == 0:
            self.pending = dict(k0=k, losses=[])
        v = self.view(k)
        t, c = self.views[v]
        self.state, losses, slots = self.step(
            self.state, self.fixed, self.binding, self.cam_arrays[c],
            self.gt[v], self.bg, t, self.lrs, mark=mark)
        if self.recording and self.pending is not None:
            self._keep(losses)
        if mark is not None and k % nv in (0, nv - 1):
            self.stream_log.append([k, v, slots])
        self.k += 1
        return losses

    def _keep(self, losses):
        """Read step i of the pending reading on the device (no sync)."""
        p = self.pending
        i = len(p["losses"])
        p["losses"].append(losses["total"])
        with torch.no_grad():
            if i == 0:
                norms = torch._foreach_norm(self._moments(self.state.mu))
                p["grad"] = torch.cat([torch.stack(norms) / (1.0 - B1),
                                       self.state.grad_accum.norm()[None]])
            if i == self.tr["checked_steps"] - 1:
                now = [x for _, x in self._leaves(self.state)]
                p["change"] = torch.stack(torch._foreach_norm(
                    torch._foreach_sub(now, self.init)))
                self.reading, self.pending = p, None
                self.check_k0 = p["k0"]

    def ready(self) -> bool:
        return self.reading is not None

    def seek(self, k0: int):
        """Continue at iteration `k0`, an epoch's start (its iteration
        restores the initial state; iteration 0's is restored here)."""
        self.k, self.pending = k0, None
        if k0 == 0:
            self.restore()

    def profile_start(self) -> int:
        """The next epoch's start."""
        v = len(self.views)
        return -(-self.k // v) * v

    # -- set-up -------------------------------------------------------------

    def warm_up(self):
        for _ in range(self.tr["warmup_steps"]):
            self.iteration()
        traffic.sync(self.device)

    def work(self, k0: int, n: int) -> list:
        """The work of iterations k0 .. k0 + n - 1 of a `timed` run, each
        view counted by the reference's binning at the parameters it is
        rendered with (the same steps run again from the same state)."""
        inp = self.inputs
        out = []
        self.seek(k0)
        self.restore()
        for _ in range(n):
            t, c = self.views[self.view(self.k)]
            leaves = dict(self._leaves(self.state))
            params = {k: leaves[k].detach() for k in ref_train.GAUSS_KEYS}
            flame = None
            if inp.bound:
                flame = dict(inp.flame, **{k[6:]: x.detach()
                                           for k, x in leaves.items()
                                           if k.startswith("flame.")})
            out.append(inp.work(params, flame, t, self.cams[c], self.bg,
                                self.cfg["tile_size"]))
            self.iteration()
        return out

    # -- the comparison -----------------------------------------------------

    def program_readings(self) -> dict:
        r = self.reading
        if r is None:
            return {}
        return dict(k0=r["k0"], losses=[float(x) for x in r["losses"]],
                    grad=r["grad"].tolist(), change=r["change"].tolist(),
                    names=[k for k, _ in self._leaves(self.state)])

    def prepare_control(self):
        self.check_k0 = len(self.views)

    def reference_readings(self, fault=None) -> dict:
        """The reference's `checked_steps` steps on the views of the
        program's reading, from the same initial inputs, read as the
        program's were."""
        inp = self.inputs
        tr = {k: v for k, v in (inp.flame or {}).items()
              if k in ref_flame.FINETUNE_KEYS}
        fixed = {k: v for k, v in (inp.flame or {}).items() if k not in tr}
        st = ref_train.init_state(inp.params, tr)
        p0 = [x.clone() for _, x in ref_train.leaves(st)]
        opt = self.cfg["optimization"]
        lrs = dict(xyz=opt["position_lr_init"] * self.cfg["spatial_lr_scale"],
                   features_dc=opt["feature_lr"],
                   features_rest=opt["feature_lr"] / 20.0,
                   scaling=opt["scaling_lr"], rotation=opt["rotation_lr"],
                   opacity=opt["opacity_lr"])
        for k in tr:
            lrs[f"flame.{k}"] = (opt["flame_expr_lr"] if k == "expr" else
                                 opt["flame_trans_lr"] if k == "translation"
                                 else opt["flame_pose_lr"])
        r = dict(k0=self.check_k0, losses=[],
                 names=[k for k, _ in ref_train.leaves(st)])
        if self.check_k0 is None:
            return r
        for i in range(self.tr["checked_steps"]):
            t, c = self.views[self.view(self.check_k0 + i)]
            terms, grads = ref_train.step(
                inp.head, st, fixed, inp.binding,
                traffic.ref_camera(self.cams[c]),
                self.gt[self.view(self.check_k0 + i)], self.bg, t, lrs, opt,
                self.cfg["tile_size"], fault=fault)
            r["losses"].append(terms["total"])
            if i == 0:
                r["grad"] = [float(g.norm()) for g in grads]
                r["grad"].append(float(st["grad_accum"].norm()))
        r["change"] = [float((x - x0).norm()) for (_, x), x0 in
                       zip(ref_train.leaves(st), p0)]
        return r

    def compare(self, prog: dict, ref: dict) -> dict:
        return check.train_numbers(prog, ref)


LOOP = TrainViews
