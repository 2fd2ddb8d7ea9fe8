"""Render configuration of the port.

The port's own copy of ``raytracer_tpu/config.py``: ``Epsilons`` and
``RenderConfig`` with the same fields, defaults and f32 epsilons (the
reference's f64 values re-tuned for f32; keep them unchanged, the kernels'
parity with the JAX package rests on them), the default scene list, the
server port and the TOML loader. The tests hold the copy against the JAX
module field for field.
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass(frozen=True)
class Epsilons:
    """Geometric epsilons, re-tuned for f32.

    Reference (f64): sphere eps 1e-4 (src/geometry.rs:516), plane parallel
    cutoff 1e-4 (:553), triangle parallel cutoff 1e-4 and t>1e-4 (:640,:659),
    hit offset 1e-5 (:561,:663), visibility margin 1e-3 (src/scene.rs:259).
    """

    sphere_tmin: float = 2e-3
    plane_parallel: float = 1e-4
    tri_parallel: float = 1e-4
    tri_tmin: float = 1e-3
    hit_offset: float = 1e-3
    visibility_margin: float = 1e-2
    specular_match: float = 1e-3  # BRDF::eval specular dir match, src/scene.rs:35


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Full render configuration.

    Defaults reproduce the reference's live code path: NEE + Russian
    roulette, MIS off (the reference's MIS is dead code behind ``if false``,
    src/scene.rs:188), 600x450 output (src/server.rs:29-30).
    """

    width: int = 600
    height: int = 450

    # Integrator (reference: src/scene.rs:109-110): depth <= rr_start_depth
    # always continues, beyond it a path survives with rr_survival; max_depth
    # is the static cap of the streaming engines.
    rr_start_depth: int = 5
    rr_survival: float = 0.9
    max_depth: int = 24
    use_mis: bool = False

    # Camera (reference: src/server.rs:330-331).
    fov_scale: float = 0.5135

    # True rotates the Phong lobe sample into world space (the reference
    # returns it in the local tangent frame, src/scene.rs:74-95).
    fix_phong_frame: bool = True

    eps: Epsilons = dataclasses.field(default_factory=Epsilons)

    # Lane budgets per dispatch: sphere/plane scenes, and BVH scenes (2^21
    # lanes: the whole 600x450 frame as one band).
    rays_per_pass: int = 1 << 17
    mesh_rays_per_pass: int = 1 << 21

    # BVH tail compaction: when at most half a loop's lanes still hold work,
    # gather the stragglers into a half-width loop, up to this many stages.
    tail_compact: bool = True
    tail_compact_stages: int = 3

    # Band engine: "mega" (the bounce megakernel where the scene allows it,
    # else "regen") or "regen" (the streaming engine).
    engine: str = "mega"

    # Base seed of the counter-based draws.
    seed: int = 0
    # The JAX package's PRNG choice; the port draws from its counter hash
    # and keeps the field so configurations carry over unchanged.
    rng_impl: str = "rbg"


def config_from_toml(path: str) -> RenderConfig:
    """A RenderConfig from a TOML file with the reference's ``config.toml``
    keys (width/height/samples_per_pixel/scene/use_mis/show_window) and a
    few of this config's own; unknown keys are rejected."""
    import tomllib

    with open(path, "rb") as fh:
        doc = tomllib.load(fh)
    known = {
        "width": "width",
        "height": "height",
        "use_mis": "use_mis",
        "max_bounces": "rr_start_depth",
        "max_depth": "max_depth",
        "survival_probability": "rr_survival",
        "seed": "seed",
        "engine": "engine",
        # accepted for compatibility with the reference, not config fields:
        "samples_per_pixel": None,  # spp comes per render request
        "scene": None,  # scenes are all loaded at startup
        "show_window": None,  # no native window path
    }
    kwargs = {}
    for key, val in doc.items():
        if key not in known:
            raise ValueError(f"unknown config key {key!r} in {path}")
        if known[key] is not None:
            kwargs[known[key]] = val
    return RenderConfig(**kwargs)


DEFAULT_PORT = 8080  # reference: src/main.rs:16 (overridable via PORT env)
SCENE_NAMES = ("cornell_box", "cubes", "flying_unicorn")  # src/main.rs:17


def port_from_env() -> int:
    return int(os.environ.get("PORT", DEFAULT_PORT))
