"""Renderer: row-band scheduling, band dispatch and finalize.

Port of ``raytracer_tpu/render/renderer.py``. The plans are the JAX
package's, unchanged: band heights divide the image height, and
progressive and serving plans are derived from the same lane budgets. A
megakernel scene renders a whole row band at its full sample count
(``num_samples = spp // 4`` per subpixel) in one dispatch; a BVH scene
takes bands of ``cfg.mesh_rays_per_pass`` lanes, one dispatch per sample,
summed on the device, and serves in at least ``DELIVERY_BANDS`` bands.

Four engines (``select_band_engine``): the bounce megakernel
(``ops.megakernel``, K1), the streaming regen engine
(``render.wavefront.render_band_regen``, with K3 and the BVH traversal, K2
or K4, on BVH scenes) and, where ``cfg.engine`` asks for them, the fused
engine ``"fused"`` (``render.wavefront_fused.render_band_fused``: regen's
estimator with one trace of twice the width an iteration; NEE only) and the
lockstep engine ``"simple"`` (``render.integrator.radiance``: k lanes per
subpixel, so its bands shrink with k). A scene on the GPU runs the CUDA kernels, a
scene on the CPU their plain PyTorch twins. ``make_renderer`` chooses
between this one-device ``Renderer`` and ``parallel.mesh.ShardedRenderer``,
which spreads a band's rows over several devices. The megakernel's 32-bit band seed is
derived from ``(cfg.seed, y0, salt)`` with the kernel's counter hash (the
JAX package folds y0 and the salt into a ``jax.random`` key); the regen
and fused engines key their draws on the frame slot, so their seed is
derived from ``(cfg.seed, salt)`` and a pixel's samples do not depend on
the band that holds it (a fused frame equals the regen frame); the lockstep engine's is derived from ``(cfg.seed, y0, salt)``
and the pass. ``render_image`` renders all the bands of a megakernel frame in
one launch (``render_bands_mega``) and finalizes them together; the served
paths keep one band per dispatch, so a client's first band does not wait
for the frame.

Finalize reproduces the reference's per-subpixel clamp-then-average and
gamma pipeline (src/server.rs:360-368) in numpy (``finalize``) and on the
device (``finalize_device``, ``finalize_device_dyn``).

A renderer keeps the regen engine's captured CUDA graphs
(``render.wavefront.StepGraphs``), so on a CUDA device its regen bands
replay their steps; they die with it.

Spans (``utils/timing.py``; live only while a ``torch.profiler`` records):
``rt.mega.launch`` around each K1 launch (``pack_params``, the band
table's pin and the launch), ``rt.render.finalize`` and ``rt.render.pull``
(the blocking copy of the u8 pixels, also counted in ``host.syncs``). The
regen engine's own spans stand for its bands; no span covers a band or a
frame, which are the caller's.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.models.camera import camera_rays3
from raytracer_tpu_torch.models.scene import SceneArrays
from raytracer_tpu_torch.ops.intersect import ScenePre, scene_precompute
from raytracer_tpu_torch.ops.megakernel import (
    M32,
    band_seed,
    render_band_mega,
    render_bands_mega,
    supports_megakernel,
    uniform,
)
from raytracer_tpu_torch.render.integrator import radiance
from raytracer_tpu_torch.render.wavefront import StepGraphs, render_band_regen
from raytracer_tpu_torch.render.wavefront_fused import render_band_fused
from raytracer_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device
from raytracer_tpu_torch.utils.timing import count, span


# The values of ``cfg.engine`` the port renders: all of the JAX package's.
ENGINES = ("mega", "regen", "fused", "simple")
# The engines whose bands ``parallel.mesh.ShardedRenderer`` spreads over devices.
SHARDED_ENGINES = ("regen", "mega")
# Salt that folds the pass number into the lockstep engine's band seed.
PASS_SALT = 0x9A55


def select_band_engine(scene: SceneArrays, cfg: RenderConfig) -> str:
    """The engine that renders ``scene`` under ``cfg``: ``"simple"`` when
    asked for; ``"fused"`` when asked for without MIS (with MIS: ``"regen"``,
    as ``raytracer_tpu/render/renderer.py:143-144``; never the megakernel);
    ``"mega"`` for the megakernel's subset (``cfg.engine`` "mega", the
    default: NEE, diffuse and mirror materials, a sphere light, no BVH),
    else ``"regen"``, which also covers MIS, Phong and mesh lights, as in
    ``raytracer_tpu/render/renderer.py:134``. A name that is none of
    ``ENGINES`` raises (the JAX package renders it as regen)."""
    if cfg.engine not in ENGINES:
        raise NotImplementedError(
            f"engine {cfg.engine!r} is not one of raytracer_tpu_torch's ("
            + ", ".join(repr(e) for e in ENGINES) + ")"
        )
    if cfg.engine == "simple":
        return "simple"
    if cfg.engine == "fused":
        return "regen" if cfg.use_mis else "fused"
    if cfg.engine == "mega" and supports_megakernel(scene, cfg):
        return "mega"
    return "regen"


def _pass_sums(
    scene: SceneArrays, pre: ScenePre, cfg: RenderConfig,
    px: torch.Tensor,  # [Np] f32 pixel column
    py: torch.Tensor,  # [Np] f32 pixel row in RENDER space (0 = bottom)
    k: int,  # samples per subpixel in this pass
    seed: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One lockstep pass: trace Np*4*k lanes -> (per-subpixel radiance sums
    [Np, 4, 3], rays traced). Lane layout [Np, 4, k]: subpixel s sits at
    (sx, sy) = (s % 2, s // 2). Lane i's camera jitter is draws 0 and 1 of
    depth 0; ``radiance`` draws from depth 1 on."""
    n_pix = px.shape[0]
    n = n_pix * 4 * k
    dev = px.device
    s = torch.arange(4, dtype=torch.float32, device=dev)

    def lanes(v: torch.Tensor) -> torch.Tensor:
        return v.expand(n_pix, 4, k).reshape(n)

    lane = torch.arange(n, dtype=torch.int64, device=dev)
    seed_u = seed & M32
    ro, rd = camera_rays3(
        scene, cfg.width, cfg.height, cfg.fov_scale,
        lanes(px[:, None, None]), lanes(py[:, None, None]),
        lanes((s % 2)[None, :, None]), lanes((s // 2)[None, :, None]),
        uniform(seed_u, lane, 0, 0), uniform(seed_u, lane, 0, 1),
    )
    rad, rays = radiance(scene, pre, cfg, ro, rd, seed)
    return rad.view(n_pix, 4, k, 3).sum(dim=2), rays


def _render_band_impl(
    scene: SceneArrays, pre: ScenePre, cfg: RenderConfig,
    y0: int, rows: int, k: int, n_passes: int, seed: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The lockstep engine's band: rows [y0, y0 + rows) at k*n_passes samples
    per subpixel, pass after pass of k -> (sums f32[rows, W, 4, 3], rays
    traced i64 scalar), on the scene's device. Pass p draws under
    ``band_seed(seed, p, PASS_SALT)``."""
    w = cfg.width
    dev = scene.device
    ys = torch.arange(y0, y0 + rows, dtype=torch.float32, device=dev)
    py = ys[:, None].expand(rows, w).reshape(-1)
    px = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(rows, w).reshape(-1)
    sums = torch.zeros((rows * w, 4, 3), dtype=torch.float32, device=dev)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    for p in range(n_passes):
        s, r = _pass_sums(scene, pre, cfg, px, py, k, band_seed(seed, p, PASS_SALT))
        sums += s
        rays += r
    return sums.view(rows, w, 4, 3), rays


def finalize_device(sums: torch.Tensor, num_samples: int) -> torch.Tensor:
    """Device-side finalize: sums [..., 4, 3] -> u8 RGB [..., 3] (see finalize)."""
    return finalize_device_dyn(sums, num_samples)


def finalize_device_dyn(sums: torch.Tensor, num_samples) -> torch.Tensor:
    """``finalize`` on the sums' device, with the sample count an int or a
    0-dim tensor (the progressive path finalizes after every chunk with a
    growing divisor)."""
    ns = torch.as_tensor(num_samples, device=sums.device).to(torch.float32)
    mean = sums / torch.clamp_min(ns, 1.0)
    c = torch.clamp(mean, 0.0, 1.0)
    # Subpixels summed in order, as numpy's add.reduce does over 4 entries.
    pixel = (c[..., 0, :] + c[..., 1, :] + c[..., 2, :] + c[..., 3, :]) * 0.25
    v = torch.clamp(pixel, 0.0, 1.0) ** (1.0 / 2.2) * 255.0 + 0.5
    return torch.clamp(torch.floor(v), 0, 255).to(torch.uint8)


def finalize(sums: np.ndarray, num_samples: int) -> np.ndarray:
    """Per-subpixel sums [..., 4, 3] -> u8 RGB [..., 3].

    Reference pipeline: mean over samples, clamp to [0,1] per subpixel,
    x0.25 sum over subpixels (src/server.rs:360), then gamma:
    clamp, ^(1/2.2), *255 + 0.5, truncate (src/server.rs:366-368).
    """
    mean = sums / float(max(num_samples, 1))
    pixel = np.clip(mean, 0.0, 1.0).sum(axis=-2) * 0.25
    v = np.clip(pixel, 0.0, 1.0) ** (1.0 / 2.2) * 255.0 + 0.5
    return np.clip(np.floor(v), 0, 255).astype(np.uint8)


def _pow2_floor(n: int) -> int:
    return 1 << (max(n, 1).bit_length() - 1)


def _divisor_band(height: int, target: int) -> int:
    """Largest divisor of height that is <= target (>=1)."""
    target = max(1, min(target, height))
    for r in range(target, 0, -1):
        if height % r == 0:
            return r
    return 1


def shard_devices(device: str | torch.device = DEFAULT_DEVICE) -> list[torch.device]:
    """The devices a sharded renderer spreads over when ``device`` is asked
    for: every visible CUDA device, or the CPU alone."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_renderer(
    scene: SceneArrays, cfg: RenderConfig, device: str | torch.device = DEFAULT_DEVICE,
    sharded: bool | None = None,
) -> "Renderer":
    """The renderer the server and the tools use. ``sharded=None``: spread
    row bands over every visible CUDA device when there is more than one and
    the scene renders through the megakernel, whose bands are asynchronous
    launches that run side by side; else the plain one-device renderer. The
    JAX package (``raytracer_tpu/render/renderer.py:219``) also shards its
    regen engine by default; here that engine's bands each occupy the host
    until they are done, so a sharded regen frame costs more than the plain
    one and is built only when asked for. ``True`` forces the sharded
    renderer (ValueError if the engine cannot); ``False`` forces the
    one-device renderer."""
    if sharded is None:
        sharded = (
            cfg.engine in SHARDED_ENGINES
            and len(shard_devices(device)) > 1
            and select_band_engine(scene, cfg) == "mega"
        )
    elif sharded and cfg.engine not in SHARDED_ENGINES:
        raise ValueError("sharded rendering requires engine='regen' or 'mega'")
    if sharded:
        from raytracer_tpu_torch.parallel.mesh import ShardedRenderer

        return ShardedRenderer(scene, cfg, shard_devices(device))
    return Renderer(scene, cfg, device=device)


class Renderer:
    """Per-scene render pipeline with row-band scheduling on one device."""

    K_MAX = 16  # max samples/subpixel per dispatch chunk
    # Per-frame dispatch cap: large frames scale the band up instead of
    # multiplying dispatches.
    MAX_BANDS = 9
    # Minimum deliveries per served BVH frame, so a client sees pixels
    # before the whole frame is done.
    DELIVERY_BANDS = 4
    # render_image renders a megakernel frame's bands in one launch; a
    # renderer whose bands go through its own render_band_sums turns it off.
    FRAME_IN_ONE_LAUNCH = True

    def __init__(
        self,
        scene: SceneArrays,
        cfg: RenderConfig | None = None,
        device: str | torch.device = DEFAULT_DEVICE,
    ):
        self.device = resolve_device(device)
        self.scene = scene.to(self.device)
        self.cfg = cfg or RenderConfig()
        self.engine = select_band_engine(self.scene, self.cfg)
        self.pre = scene_precompute(self.scene) if self.engine != "mega" else None
        self.ray_counts: list[torch.Tensor] = []
        # The regen engine's captured steps (a CUDA device only); they die
        # with the renderer.
        self.graphs = StepGraphs()

    # --- scheduling -------------------------------------------------------

    def plan(self, spp: int) -> tuple[int, int, int]:
        """(band_rows, k, n_passes): a band renders k*n_passes samples per
        subpixel, num_samples = spp//4 (the reference's integer split,
        src/server.rs:332), k a power of two <= K_MAX."""
        num_samples = spp // 4
        if num_samples >= 2**24:
            raise ValueError(f"spp {spp} exceeds the 2^24 samples/subpixel cap")
        if num_samples <= 0:
            return self._band_rows(1), 1, 0
        if self.scene.use_bvh:
            # One sample per dispatch over bands of the mesh lane budget.
            return self._band_rows(1, self.cfg.mesh_rays_per_pass), 1, num_samples
        k = min(self.K_MAX, _pow2_floor(num_samples))
        n_passes = -(-num_samples // k)
        return self._band_rows(k), k, n_passes

    def _band_rows(self, k: int, budget: int | None = None) -> int:
        cfg = self.cfg
        # The streaming engines use one lane per (pixel, subpixel) whatever
        # k is; the lockstep engine uses k lanes per subpixel.
        lanes_per_row = cfg.width * 4 * (1 if cfg.engine != "simple" else k)
        target = max(1, (budget or cfg.rays_per_pass) // lanes_per_row)
        target = max(target, -(-cfg.height // self.MAX_BANDS))
        return _divisor_band(cfg.height, target)

    def plan_delivery(self, spp: int) -> tuple[int, int, int]:
        """(band_rows, k, n_passes) for serving non-progressive renders:
        ``plan``, except that a BVH scene's band is cut so the frame streams
        in at least ``DELIVERY_BANDS`` pieces."""
        rows, k, n_passes = self.plan(spp)
        if self.scene.use_bvh and n_passes > 0 and rows > 1:
            target = max(1, -(-self.cfg.height // self.DELIVERY_BANDS))
            if target < rows:
                rows = self._delivery_rows(target)
        return rows, k, n_passes

    def _delivery_rows(self, target: int) -> int:
        return _divisor_band(self.cfg.height, target)

    def plan_progressive(self, spp: int) -> tuple[int, int, int]:
        """(band_rows, k, n_chunks) for progressive refinement: chunks are
        sized so a full render always delivers several refinements."""
        num_samples = spp // 4
        if num_samples <= 0:
            return self._band_rows(1), 1, 0
        k = min(self.K_MAX, _pow2_floor(max(1, num_samples // 4)))
        n_chunks = -(-num_samples // k)
        return self._band_rows(k), k, n_chunks

    def iter_bands(self, spp: int, rows: int | None = None) -> Iterator[tuple[int, int]]:
        if rows is None:
            rows, _, _ = self.plan(spp)
        for y in range(0, self.cfg.height, rows):
            yield y, rows

    # --- rendering --------------------------------------------------------

    def samples_rendered(self, spp: int) -> int:
        _, k, n_passes = self.plan(spp)
        return k * n_passes

    def render_band_sums(
        self, y0: int, rows: int, k: int, n_passes: int, salt: int = 0,
        return_rays: bool = False,
    ):
        """Device sums [rows, W, 4, 3] for the band starting at render row y0,
        at k*n_passes samples per subpixel.

        The band's ray count (a device scalar) is appended to
        ``self.ray_counts``, unless ``return_rays=True``, which returns
        ``(sums, rays)`` instead and leaves ``ray_counts`` alone: callers
        that share one renderer (the server's warm-up thread and client
        renders) must use that form.
        """
        if self.engine == "mega":
            with span("rt.mega.launch"):
                sums, rays = render_band_mega(
                    self.scene, self.cfg, y0, rows, k * n_passes,
                    band_seed(self.cfg.seed, y0, salt),
                )
        elif self.engine == "simple":
            sums, rays = _render_band_impl(
                self.scene, self.pre, self.cfg, y0, rows, k, n_passes,
                band_seed(self.cfg.seed, y0, salt),
            )
        elif self.engine == "fused":
            sums, rays = render_band_fused(
                self.scene, self.pre, self.cfg, y0, rows, k * n_passes,
                band_seed(self.cfg.seed, 0, salt),
            )
        else:
            sums, rays = render_band_regen(
                self.scene, self.pre, self.cfg, y0, rows, k * n_passes,
                band_seed(self.cfg.seed, 0, salt), graphs=self.graphs,
            )
        if return_rays:
            return sums, rays
        self.ray_counts.append(rays)
        return sums

    def rays_traced(self) -> int:
        """Total rays traced by this renderer so far (syncs the device)."""
        return int(sum(int(r) for r in self.ray_counts))

    def render_rows(self, y0: int, spp: int) -> tuple[np.ndarray, int]:
        """u8 RGB for one band -> ([rows, W, 3], rows); spp<4 renders black."""
        rows, k, n_passes = self.plan(spp)
        if n_passes == 0:
            return np.zeros((rows, self.cfg.width, 3), np.uint8), rows
        if self.scene.use_bvh:
            # One dispatch per sample, summed on the device.
            sums = None
            for p in range(n_passes):
                out = self.render_band_sums(y0, rows, k, 1, salt=p)
                sums = out if sums is None else sums + out
        else:
            sums = self.render_band_sums(y0, rows, k, n_passes)
        return self._pull(sums, k * n_passes), rows

    @staticmethod
    def _pull(sums: torch.Tensor, num_samples: int) -> np.ndarray:
        """Finalize on the device and wait for the u8 pixels on the host."""
        with span("rt.render.finalize"):
            rgb = finalize_device(sums, num_samples)
        with span("rt.render.pull"):
            out = rgb.cpu().numpy()
        count("host.syncs")
        return out

    def render_image(self, spp: int, cancelled=None) -> np.ndarray | None:
        """Full image -> u8 [H, W, 3] with row 0 at the TOP (client space:
        the reference samples row height-y-1 under label y, src/server.rs:181).
        Returns None when ``cancelled()`` turns true between bands."""
        cfg = self.cfg
        rows, k, n_passes = self.plan(spp)
        if self.engine == "mega" and n_passes > 0 and self.FRAME_IN_ONE_LAUNCH:
            if cancelled is not None and cancelled():
                return None
            y0s = [y0 for y0, _ in self.iter_bands(spp)]
            with span("rt.mega.launch"):
                sums, rays = render_bands_mega(
                    self.scene, cfg, y0s, rows, k * n_passes,
                    [band_seed(cfg.seed, y0, 0) for y0 in y0s],
                )
            self.ray_counts.append(rays)
            # The bands tile the render rows [0, H) in order (rows divides H);
            # render row y lands at label row H-1-y.
            rgb = self._pull(sums, k * n_passes)
            return np.ascontiguousarray(rgb.reshape(-1, cfg.width, 3)[: cfg.height][::-1])
        img = np.zeros((cfg.height, cfg.width, 3), np.uint8)
        for y0, rows in self.iter_bands(spp):
            if cancelled is not None and cancelled():
                return None
            rgb, _ = self.render_rows(y0, spp)
            # Render rows [y0, y0+rows) land flipped at label rows [H-y0-rows,
            # H-y0); a sharded band may overshoot H and is clipped.
            valid = min(rows, cfg.height - y0)
            img[cfg.height - y0 - valid : cfg.height - y0] = rgb[:valid][::-1]
        return img
