"""Render checkpoint and resume.

Port of ``raytracer_tpu/render/checkpoint.py``. The per-subpixel sums are
the checkpoint: saving (sums, samples so far, a fingerprint of scene and
configuration) lets a render resume where it stopped, or refine a finished
one with more samples later. The checkpoint is numpy on the host; a band's
sums cross from the device once.

The ``.npz`` keys (``format``, ``fingerprint``, ``sums``, ``num_samples``)
and the fingerprint string are the JAX package's, and ``RenderConfig`` has
its fields, so for equal configurations a checkpoint written by either
package loads in the other. (The two draw different random numbers, so a
render resumed across packages is a valid estimate, not a reproduction.)
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.render.renderer import Renderer, finalize

FORMAT = 1


def _fingerprint(scene_name: str, cfg: RenderConfig) -> str:
    d = dataclasses.asdict(cfg)
    # Batching knobs do not affect the estimate; a checkpoint stays
    # resumable after they are retuned.
    d.pop("rays_per_pass", None)
    d.pop("mesh_rays_per_pass", None)
    return json.dumps({"scene": scene_name, "cfg": d}, sort_keys=True)


@dataclasses.dataclass
class RenderCheckpoint:
    """Accumulated render state: sums [H,W,4,3] and samples per subpixel."""

    scene_name: str
    cfg: RenderConfig
    sums: np.ndarray  # [H,W,4,3] f32, render-space row order
    num_samples: int  # accumulated samples per subpixel

    def image(self) -> np.ndarray:
        """Finalize to u8 [H,W,3] with row 0 at the TOP (label space)."""
        return finalize(self.sums, self.num_samples)[::-1]

    def save(self, path: str) -> None:
        np.savez_compressed(
            path,
            format=FORMAT,
            fingerprint=_fingerprint(self.scene_name, self.cfg),
            sums=self.sums,
            num_samples=self.num_samples,
        )

    @staticmethod
    def load(path: str, scene_name: str, cfg: RenderConfig) -> "RenderCheckpoint":
        data = np.load(path, allow_pickle=False)
        if int(data["format"]) != FORMAT:
            raise ValueError(f"unsupported checkpoint format {data['format']}")
        fp = str(data["fingerprint"])
        want = _fingerprint(scene_name, cfg)
        if fp != want:
            raise ValueError(
                "checkpoint was produced by a different scene/config:\n"
                f"  have {fp}\n  want {want}"
            )
        return RenderCheckpoint(
            scene_name=scene_name,
            cfg=cfg,
            sums=np.asarray(data["sums"], np.float32),
            num_samples=int(data["num_samples"]),
        )


def render_with_checkpoint(
    renderer: Renderer,
    scene_name: str,
    spp: int,
    checkpoint: RenderCheckpoint | None = None,
    cancelled=None,
) -> RenderCheckpoint:
    """Render up to ``spp`` in total, resuming from ``checkpoint`` if given.

    Returns the accumulated state, partial if cancelled; call again with the
    result to continue. A chunk of samples is salted by the count
    accumulated before it, so resumed samples never repeat a stream.
    """
    cfg = renderer.cfg
    if checkpoint is not None:
        ck = checkpoint
        if ck.sums.shape[:2] != (cfg.height, cfg.width):
            raise ValueError("checkpoint resolution mismatch")
    else:
        ck = RenderCheckpoint(
            scene_name=scene_name,
            cfg=cfg,
            sums=np.zeros((cfg.height, cfg.width, 4, 3), np.float32),
            num_samples=0,
        )

    target = spp // 4
    rows, k, _ = renderer.plan(spp)
    while ck.num_samples < target:
        if cancelled is not None and cancelled():
            break
        chunk = min(k, target - ck.num_samples)
        # Chunks are atomic: bands go to a staging buffer that is merged only
        # when every band is in, so a cancel inside a chunk cannot leave some
        # bands over-weighted in the checkpoint.
        staged = np.zeros_like(ck.sums)
        aborted = False
        for y0 in range(0, cfg.height, rows):
            if cancelled is not None and cancelled():
                aborted = True
                break
            valid = min(rows, cfg.height - y0)
            sums = renderer.render_band_sums(y0, rows, chunk, 1, salt=1000 + ck.num_samples)
            staged[y0 : y0 + valid] += sums[:valid].cpu().numpy()
        if aborted:
            break
        ck.sums += staged
        ck.num_samples += chunk
    return ck
