"""Loop kind "train_decode": the closed training loop of `loops/train.py`
with its ground truths read from files, as a trainer reads a dataset.

At set-up the seeded ground truths (one a view) are written as 8-bit RGB
PNGs into the loop's temporary directory by the program's PNG writer with
every row under the filter `png_filter` (4, Paeth: what an adaptive
writer such as libpng or PIL picks for most rows of a photograph) at its
zlib level, on `png_threads` threads. The program's `CameraLoader` then
serves them with `loader_threads` decoding threads and a host cache of
`cache_share` of the decoded dataset, so that views are decoded again in
every epoch. Each iteration takes its view and image from the loader and
puts the image on the device through the program's `GroundTruthCache`,
its budget the same share of the dataset: the views that fit stay on the
device, the others are copied on every use, as the program's training
loop treats a dataset larger than its device cache. The views come in
one seeded order, the same every epoch (the state is restored at each
epoch's start, so every epoch replays the same span of training); `seek`
moves the loader on to its next epoch's start.

The reference trains on the same 8-bit images, kept on the host as bytes
and made floats on the device one view at a time; the float copy the
base loop makes at set-up is freed before the first step, and the
device's peak memory is counted from there. The loader's decodes of each
epoch are printed as one JSON line when the program is freed, the last
epoch's possibly after `last_epoch_views` of its views.
"""

from __future__ import annotations

import json
import math
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from avatarbench import program_data
from avatarbench.loops.train import TrainViews


class HostBytes:
    """8-bit images [V, 3, H, W] on the host, indexed as float32 images in
    [0, 1] on `device`, the values the loader delivers."""

    def __init__(self, images: torch.Tensor, device):
        self.images, self.device = images, device

    def __getitem__(self, v: int) -> torch.Tensor:
        return self.images[v].to(self.device, torch.float32) / 255.0


class TrainDecode(TrainViews):

    def __init__(self, cfg, tr, limits, seed, device):
        super().__init__(cfg, tr, limits, seed, device)
        nv = len(self.views)
        q = torch.empty((nv, 3, self.height, self.width), dtype=torch.uint8)
        for v in range(nv):
            q[v] = torch.round(self.gt[v] * 255.0).to(torch.uint8).cpu()
        self.gt = HostBytes(q, device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        pixels = q.permute(0, 2, 3, 1).contiguous().numpy()
        folder = os.path.join(self.tmp.name, "images")
        os.makedirs(folder)
        paths = [os.path.join(folder, f"{v:04d}.png") for v in range(nv)]

        def write(v):
            program_data.write_png(paths[v], pixels[v], tr["png_filter"])

        with ThreadPoolExecutor(tr["png_threads"]) as pool:
            list(pool.map(write, range(nv)))
        del pixels
        g = torch.Generator().manual_seed((seed * 7919 + 211) % (1 << 63))
        self.order = torch.randperm(nv, generator=g).tolist()
        tan_x = math.tan(tr["fovx"] / 2)
        fovy = 2 * math.atan(tan_x * self.height / self.width)
        cams = [program_data.Camera(
            uid=v, R=np.eye(3), T=np.zeros(3), fovx=tr["fovx"], fovy=fovy,
            width=self.width, height=self.height, image_path=paths[v],
            image_name=f"{v:04d}") for v in self.order]
        self.cache_bytes = int(tr["cache_share"] * nv * 3 * self.height
                               * self.width * 4)
        self.loader = program_data.CameraLoader(
            cams, shuffle=False, num_threads=tr["loader_threads"],
            device=device, cache_bytes=self.cache_bytes)
        self.on_device = program_data.GroundTruthCache(device,
                                                       self.cache_bytes)
        self.served = 0          # views taken from the loader
        self.decodes = []        # views decoded in each loader epoch
        self.counted = 0         # the loader's decodes before this epoch

    def view(self, k: int) -> int:
        return self.order[k % len(self.views)]

    # -- the loader ---------------------------------------------------------

    def _count_decodes(self):
        self.decodes.append(self.loader.decodes - self.counted)
        self.counted = self.loader.decodes

    def _take(self):
        """The loader's next (camera, image); at each epoch's start the
        decodes of the epoch before are counted."""
        if self.served and self.served % len(self.views) == 0:
            self._count_decodes()
        item = next(self.loader)
        self.served += 1
        return item

    def ground_truth(self, v: int) -> torch.Tensor:
        cam, img = self._take()
        if cam.uid != v:
            raise RuntimeError(f"the loader served view {cam.uid} where the "
                               f"schedule has view {v}")
        return self.on_device.get(v, img)

    def seek(self, k0: int):
        """Continue at iteration `k0`, an epoch's start, with the loader at
        its next epoch's start."""
        while self.served % len(self.views):
            self._take()
        super().seek(k0)

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
            self.ground_truth(v), self.bg, t, self.lrs, mark=mark)
        if self.recording and self.pending is not None:
            self._keep(losses)
        if mark is not None and k % nv in (0, nv - 1):
            self.stream_log.append([k, v, slots])
        self.k += 1
        return losses

    # -- the end ------------------------------------------------------------

    def _stop_loader(self):
        if self.loader is None:
            return
        partial = self.served % len(self.views)
        if partial:
            self._count_decodes()
        self.loader.stop()
        self.loader = self.on_device = None
        print(json.dumps(dict(what="loader", views=len(self.views),
                              cache_bytes=self.cache_bytes,
                              served=self.served,
                              decodes_by_epoch=self.decodes,
                              last_epoch_views=partial or len(self.views))),
              flush=True)

    def _drop_program_state(self):
        self._stop_loader()
        super()._drop_program_state()

    def close(self):
        self._stop_loader()
        super().close()


LOOP = TrainDecode
