"""Row bands spread over several devices.

Port of ``raytracer_tpu/parallel/mesh.py``. The reference's only compute
parallelism is a static split of the frame's rows over CPU threads
(src/server.rs:165-168); here a band of ``n_dev * rows_per_dev`` rows is
split over a list of torch devices: device d renders rows
``[y0 + d*rows_per_dev, y0 + (d+1)*rows_per_dev)`` with the plain band
function of the resolved engine. The scene (and its precomputed tables) is
copied to each device once; nothing crosses between devices while a band
renders. Every device's band is started before any is waited for; then the
sums are gathered to the first device in row order and the ray counts
summed there, the counterpart of the JAX package's one ``psum``.

One host thread starts every device's band (``device_bands``). A megakernel
band is one asynchronous launch, so the devices run side by side. The regen
engine reads its loop condition back every iteration, so its bands run one
after the other and a sharded regen frame costs more than the plain one:
``make_renderer`` shards the megakernel by default and the regen engine
only when asked (``bench_torch.py --sharding`` times both, and a host
thread a device as well).

Seeds. The JAX package folds the device index into the band's key because
its key does not otherwise tell devices apart. Here nothing is folded: the
megakernel's seed is ``band_seed(cfg.seed, y0_d, salt)`` with the device's
own first row, and the regen engine keys every draw on the lane's slot in
the frame. Two properties follow:

(a) device d's rows equal, bit for bit, the plain band function called on
    one device at ``(y0_d, rows_per_dev)`` with that seed;
(b) for the regen engine a multi-device frame equals the plain
    ``Renderer``'s frame on every pixel (a pixel's samples depend neither on
    its band nor on its device); megakernel frames of different band
    heights agree statistically.

Spans (``utils/timing.py``): ``rt.mesh.launch`` around the devices'
megakernel launches (a regen band's own ``rt.regen.*`` spans stand for
it) and ``rt.mesh.gather`` around the gather to the first device.

The same device may be listed more than once (``[cuda:0, cuda:0]`` runs the
whole path on one card; ``["cpu"] * n`` on the CPU).
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.models.scene import SceneArrays
from raytracer_tpu_torch.ops.intersect import scene_precompute
from raytracer_tpu_torch.ops.megakernel import band_seed, render_band_mega
from raytracer_tpu_torch.render.renderer import SHARDED_ENGINES, Renderer
from raytracer_tpu_torch.render.wavefront import render_band_regen
from raytracer_tpu_torch.utils.device import resolve_device
from raytracer_tpu_torch.utils.timing import span


class ShardedRenderer(Renderer):
    """Renderer whose bands are split over ``devices``. A one-device list
    gives the plain ``Renderer``'s schedule."""

    FRAME_IN_ONE_LAUNCH = False  # a frame goes band by band, each over the devices

    def __init__(
        self, scene: SceneArrays, cfg: RenderConfig | None = None, devices=("cuda",),
    ):
        devices = [resolve_device(d) for d in devices]
        if not devices:
            raise ValueError("ShardedRenderer needs at least one device")
        if (cfg or RenderConfig()).engine not in SHARDED_ENGINES:
            raise ValueError("ShardedRenderer supports the streaming engines only")
        super().__init__(scene, cfg, device=devices[0])
        self.devices = devices
        self.n_dev = len(devices)
        # One copy of the scene (and its tables) per distinct device; the
        # kernels' per-scene host tables are keyed on the copy.
        copies = {self.device: (self.scene, self.pre)}
        for dev in devices:
            if dev not in copies:
                on_dev = self.scene.to(dev)
                copies[dev] = (on_dev, scene_precompute(on_dev) if self.pre is not None else None)
        self._copies = [copies[dev] for dev in devices]

    def _band_rows(self, k: int, budget: int | None = None) -> int:
        # The fewest equal per-device bands such that a dispatch stays near
        # the lane budget per device; the last band may overshoot H
        # (render_image clips the excess rows).
        cfg = self.cfg
        lanes_per_row = cfg.width * 4 * (1 if cfg.engine != "simple" else k)
        target = max(1, (budget or cfg.rays_per_pass) // lanes_per_row)
        n_bands = max(1, -(-cfg.height // (target * self.n_dev)))
        n_bands = min(n_bands, self.MAX_BANDS)  # large-frame dispatch cap
        rows_per_dev = -(-cfg.height // (n_bands * self.n_dev))
        return rows_per_dev * self.n_dev

    def _delivery_rows(self, target: int) -> int:
        # A sharded band need not divide the frame height but must stay a
        # multiple of the device count.
        return self.n_dev * max(1, target // self.n_dev)

    def device_band(self, d: int, y0: int, rows: int, num_samples: int, salt: int = 0):
        """Device d's share of the band of ``rows`` rows at ``y0``: the plain
        band function on that device's scene copy -> (sums, rays) there."""
        scene, pre = self._copies[d]
        rows_per_dev = rows // self.n_dev
        y0_d = y0 + d * rows_per_dev
        if self.engine == "mega":
            return render_band_mega(
                scene, self.cfg, y0_d, rows_per_dev, num_samples,
                band_seed(self.cfg.seed, y0_d, salt),
            )
        return render_band_regen(
            scene, pre, self.cfg, y0_d, rows_per_dev, num_samples,
            band_seed(self.cfg.seed, 0, salt),
        )

    def device_bands(self, y0: int, rows: int, num_samples: int, salt: int = 0) -> list:
        """Every device's share of the band, in row order, started from this
        thread before any is waited for."""
        return [self.device_band(d, y0, rows, num_samples, salt) for d in range(self.n_dev)]

    def render_band_sums(
        self, y0: int, rows: int, k: int, n_passes: int, salt: int = 0,
        return_rays: bool = False,
    ):
        if rows % self.n_dev:
            raise ValueError(f"a band of {rows} rows does not split over {self.n_dev} devices")
        # A regen band's own rt.regen.* spans stand for its launch.
        with span("rt.mesh.launch" if self.engine == "mega" else None):
            parts = self.device_bands(y0, rows, k * n_passes, salt)
        with span("rt.mesh.gather"):
            sums = torch.cat([s.to(self.device) for s, _ in parts])
            rays = torch.stack([r.to(self.device) for _, r in parts]).sum()
        if return_rays:
            return sums, rays
        self.ray_counts.append(rays)
        return sums
