"""The port's regen engine against the JAX package's, both under the same
measurement hook, on the chair room of ``tests/test_torch_variants.py``
(60x45, 8 spp, without tail compaction: JAX compiles its loop once per
compaction stage, and each hook needs its own compile, 15-25 s on the CPU):

- ``RT_ABLATE=shadow`` (no shadow trace: every unculled light sample seen);
- ``RT_SHADOW_REVERSE=1`` (shadow segments from the light to the surface);
- ``RT_DEFER_SHADOW=1`` (shadow queries resolved in the next iteration).

Bounds as for the mesh-light frame there: the image mean within 1.5 u8 of
JAX's (``tests/test_wavefront.py:196``), the MAD to it at most 1.15 x
MAD(port seed 7, port seed 8) + 0.5. JAX's own test holds its deferred
frame to MAD < 3.0 against its default frame drawn from the same stream;
the port's draws are another stream (MAD ~16 between two renders here), so
that noise is the yardstick. The port against its own default frame under
each hook, to tighter bounds, is in ``tests/test_torch_variants.py``.
"""

import contextlib

import numpy as np
import pytest

from raytracer_tpu.models.loader import load_scene_dict as jax_load_scene_dict
from tests.test_torch_variants import (
    SCENES, _mad, assert_matches_jax, chair_doc, jax_frame, port_frame, port_seeds,
)
from tests.torch_cpu import one_torch_thread  # noqa: F401  (autouse)
from raytracer_tpu_torch.models.loader import load_scene_dict


@pytest.fixture(scope="module")
def chair():
    return load_scene_dict(chair_doc(), name="chair", scenes_dir=SCENES, device="cpu")


@pytest.fixture(scope="module")
def seeds(chair):
    return port_seeds(chair, tail_compact=False)


@pytest.mark.parametrize("hook,value", [
    ("RT_ABLATE", "shadow"), ("RT_SHADOW_REVERSE", "1"), ("RT_DEFER_SHADOW", "1"),
])
def test_hook_matches_jax(chair, seeds, monkeypatch, hook, value):
    want = jax_frame(jax_load_scene_dict(chair_doc(), name="chair", scenes_dir=SCENES), {hook: value},
                     tail_compact=False)
    with pytest.warns(RuntimeWarning, match=hook) if hook == "RT_ABLATE" else contextlib.nullcontext():
        got = port_frame(chair, monkeypatch, {hook: value}, tail_compact=False)
    print(f"{hook}={value}: port mean {got.mean():.4f}, JAX {want.mean():.4f}, MAD {_mad(got, want):.4f} "
          f"(port seeds {seeds['mad']:.4f})")
    assert np.isfinite(got).all()
    assert_matches_jax(got, want, seeds["mad"])
