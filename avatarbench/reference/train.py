"""One GaussianAvatars train step in plain PyTorch (reference train.py:
127-210): FLAME at the timestep with the fine-tuned parameters, the face
frames, the binding chain, the render, L1 + D-SSIM and the xyz and scale
regularizers, autograd's gradients, one Adam step (eps 1e-15 outside the
square root, one step count) and the densification statistics.

`fault` plants a defect for the benchmark's own checks: "half_rows" takes
the image losses over the top half of the rows only, "unchanged" returns
the state as it came.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from avatarbench.reference.flame import FlameHead, face_frames
from avatarbench.reference.render import Camera, render

B1, B2, EPS = 0.9, 0.999, 1e-15
GAUSS_KEYS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
              "opacity")


def set_tf32(on: bool):
    """TF32 in float32 matrix products and convolutions (off in the
    reference; on only in its lower-precision control)."""
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def ssim(a, b, window=11, sigma=1.5):
    """Mean SSIM of two [3, H, W] images: an 11 x 11 Gaussian window of
    sigma 1.5, zero-padded same-size filtering, C1 = 0.01^2, C2 = 0.03^2
    (reference utils/loss_utils.py)."""
    g = torch.tensor([math.exp(-((x - window // 2) ** 2) / (2 * sigma ** 2))
                      for x in range(window)], device=a.device)
    g = g / g.sum()
    w = (g[:, None] * g[None, :]).expand(3, 1, window, window).contiguous()

    def blur(x):
        return F.conv2d(x[None], w, padding=window // 2, groups=3)[0]

    mu1, mu2 = blur(a), blur(b)
    s11 = blur(a * a) - mu1 * mu1
    s22 = blur(b * b) - mu2 * mu2
    s12 = blur(a * b) - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return (((2 * mu1 * mu2 + c1) * (2 * s12 + c2))
            / ((mu1 * mu1 + mu2 * mu2 + c1) * (s11 + s22 + c2))).mean()


def _norm(x):
    return torch.sqrt(torch.clamp((x * x).sum(-1), min=1e-24))


def _masked_mean(v, mask):
    return (v * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def losses(image, gt, vis, params, face_scale, cfg: dict, bound: bool,
           fault=None):
    """The loss terms: L1 (1 - lambda_dssim), D-SSIM lambda_dssim and, for
    a bound avatar, relu(|xyz| - threshold_xyz) and |relu(exp(scaling) -
    threshold_scale)| as means over the visible Gaussians."""
    if fault == "half_rows":
        rows = image.shape[1] // 2
        image, gt = image[:, :rows], gt[:, :rows]
    out = {"l1": torch.abs(image - gt).mean() * (1.0 - cfg["lambda_dssim"]),
           "ssim": (1.0 - ssim(image, gt)) * cfg["lambda_dssim"]}
    if bound:
        vis = vis.float()
        out["xyz"] = _masked_mean(torch.relu(_norm(params["xyz"])
                                             - cfg["threshold_xyz"]),
                                  vis) * cfg["lambda_xyz"]
        out["scale"] = _masked_mean(_norm(torch.relu(
            torch.exp(params["scaling"]) - cfg["threshold_scale"])),
            vis) * cfg["lambda_scale"]
    return out


def leaves(state: dict) -> list:
    """(name, tensor) of every trained leaf: the Gaussian parameters, then
    the fine-tuned FLAME parameters."""
    return ([(k, state["params"][k]) for k in GAUSS_KEYS]
            + [(f"flame.{k}", state["flame_tr"][k])
               for k in sorted(state["flame_tr"])])


def init_state(params: dict, flame_tr: dict) -> dict:
    """Copies of the initial parameters, zero moments and statistics."""
    params = {k: v.detach().clone() for k, v in params.items()}
    flame_tr = {k: v.detach().clone() for k, v in flame_tr.items()}
    n = params["xyz"].shape[0]
    zeros = torch.zeros(n, device=params["xyz"].device)
    st = dict(params=params, flame_tr=flame_tr, count=0,
              grad_accum=zeros.clone(), denom=zeros.clone(),
              max_radii=zeros.clone())
    st["mu"] = [torch.zeros_like(x) for _, x in leaves(st)]
    st["nu"] = [torch.zeros_like(x) for _, x in leaves(st)]
    return st


def step(head: FlameHead | None, st: dict, flame_fixed: dict, binding,
         cam: Camera, gt, bg, t: int, lrs: dict, cfg: dict, tile: int,
         fault=None):
    """One train step on `st` (updated in place). Returns (loss terms and
    "total" as floats, the gradients in `leaves` order)."""
    names = [k for k, _ in leaves(st)]
    xs = [x.detach().requires_grad_() for _, x in leaves(st)]
    p = dict(zip(GAUSS_KEYS, xs[:len(GAUSS_KEYS)]))
    tr = {k[6:]: x for k, x in zip(names[len(GAUSS_KEYS):],
                                   xs[len(GAUSS_KEYS):])}
    bound = head is not None
    frames = None
    if bound:
        frames = face_frames(head.verts({**flame_fixed, **tr}, t),
                             head.faces)
    offset = torch.zeros(p["xyz"].shape[0], 2, device=gt.device,
                         requires_grad=True)
    out, proj = render(p, binding, frames, cam, bg, tile=tile, offset=offset,
                       grad=True)
    face_scale = frames["scale"][binding] if bound else None
    terms = losses(out.image, gt, proj.valid, p, face_scale, cfg, bound,
                   fault)
    total = sum(terms.values())
    grads = torch.autograd.grad(total, xs + [offset], allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(xs + [offset], grads)]
    result = {k: float(v.detach()) for k, v in terms.items()}
    result["total"] = float(total.detach())
    if fault == "unchanged":
        return result, grads[:-1]

    with torch.no_grad():
        st["count"] += 1
        c1 = 1.0 - B1 ** st["count"]
        c2 = 1.0 - B2 ** st["count"]
        for (name, x), g, m, v in zip(leaves(st), grads, st["mu"], st["nu"]):
            lr = lrs[name]
            m.mul_(B1).add_(g, alpha=1.0 - B1)
            v.mul_(B2).addcmul_(g, g, value=1.0 - B2)
            x.sub_(lr * (m / c1) / (torch.sqrt(v / c2) + EPS))
        vis = proj.valid
        st["grad_accum"].add_(torch.where(
            vis, torch.linalg.norm(grads[-1], dim=-1), 0.0))
        st["denom"].add_(vis.float())
        torch.maximum(st["max_radii"], torch.where(vis, proj.radii, 0.0),
                      out=st["max_radii"])
    return result, grads[:-1]
