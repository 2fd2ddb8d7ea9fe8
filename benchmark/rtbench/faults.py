"""Faults planted under the timed path, for the tests and ``calibrate.py``
only: each breaks the program underneath a run, and the comparison has to
read ``correct: false``. No run of a cell plants one.

- ``half_the_samples``: every frame renders half its sample count.
- ``answer_altered``: every pixel of every frame altered by one bit where
  the frame is produced.
- ``half_the_bands``: half of the batch left out: the rows of every other
  band of a frame (a frame of one band: the upper half of its rows) never
  reach the image.
- ``one_card_left_out``: on several cards, the last card's part of each
  band never reaches the gathered image.
- ``exchange_left_out``: on several cards, the first card's part stands
  for every card's.
"""

from __future__ import annotations

import contextlib

K1_FAULTS = ("half_the_samples", "answer_altered", "half_the_bands")
SHARDED_FAULTS = K1_FAULTS + ("one_card_left_out", "exchange_left_out")


def _drop_half(sums):
    """Sums [bands, rows, ...] with every other band zeroed, or with one
    band the upper half of its rows."""
    out = sums.clone()
    if out.shape[0] > 1:
        out[1::2] = 0
    else:
        out[:, out.shape[1] // 2:] = 0
    return out


def _patches(name: str) -> list[tuple[object, str, object]]:
    from raytracer_tpu_torch.parallel.mesh import ShardedRenderer
    from raytracer_tpu_torch.render import renderer as rmod

    if name == "half_the_samples":
        orig = rmod.Renderer.render_image
        return [(rmod.Renderer, "render_image", lambda self, spp, *a, **k: orig(self, spp // 2, *a, **k))]
    if name == "answer_altered":
        orig = rmod.Renderer.render_image

        def altered(self, spp, *a, **k):
            img = orig(self, spp, *a, **k)
            img ^= 1
            return img

        return [(rmod.Renderer, "render_image", altered)]
    if name == "half_the_bands":
        orig_bands = rmod.render_bands_mega
        orig_band = ShardedRenderer.render_band_sums

        def bands(*a, **k):
            sums, rays = orig_bands(*a, **k)
            return _drop_half(sums), rays

        def sharded_band(self, y0, rows, k, n_passes, salt=0, return_rays=False):
            got = orig_band(self, y0, rows, k, n_passes, salt, return_rays)
            sums = got[0] if return_rays else got
            if rows >= self.cfg.height:
                sums = _drop_half(sums[None])[0]
            elif (y0 // rows) % 2:
                sums = sums * 0
            return (sums, got[1]) if return_rays else sums

        return [(rmod, "render_bands_mega", bands), (ShardedRenderer, "render_band_sums", sharded_band)]
    if name in ("one_card_left_out", "exchange_left_out"):
        orig = ShardedRenderer.device_bands

        def parts(self, y0, rows, num_samples, salt=0):
            got = orig(self, y0, rows, num_samples, salt)
            if name == "exchange_left_out":
                return [got[0]] * len(got)
            sums, rays = got[-1]
            return got[:-1] + [(sums * 0, rays)]

        return [(ShardedRenderer, "device_bands", parts)]
    raise ValueError(f"unknown fault {name!r}")


@contextlib.contextmanager
def planted(name: str):
    """The program with fault ``name`` planted, for the duration."""
    patches = _patches(name)
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in patches]
    for obj, attr, fn in patches:
        setattr(obj, attr, fn)
    try:
        yield
    finally:
        for obj, attr, fn in saved:
            setattr(obj, attr, fn)
