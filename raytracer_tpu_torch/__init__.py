"""raytracer_tpu_torch — the PyTorch + CUDA port of ``raytracer_tpu``.

The reference's scenes (cornell_box, cubes, flying_unicorn, crewmate_phong)
rendered and served end to end on one NVIDIA GPU.

- TOML scene -> ``SceneArrays`` of torch tensors, with a BVH over mesh
  triangles (``models.loader``, ``models.obj``, ``ops.bvh``)
- row-band scheduling and finalize (``render.renderer``)
- two engines: the bounce megakernel (``ops.megakernel``, K1) for
  sphere/plane/small-triangle NEE scenes, and the streaming regen engine
  (``render.wavefront``) for BVH scenes, MIS, Phong and mesh lights, with
  the 8-wide traversal (``ops.bvh_traverse``, K2) or the binary skip-link
  walk (``ops.bvh_binary``, K4) and the coherence key (``ops.keys``, K3)
- every kernel is hand-written CUDA C++ for Hopper (``ops/csrc``) with a
  plain PyTorch twin beside it, used for CPU tensors
- the asyncio WebSocket server on the reference's wire protocol
  (``server.app``, ``server.wire``)

The JAX package ``raytracer_tpu`` is the reference this port is held
against, by the tests only. The port is self-contained: it keeps its own
copies of what it needs of that package (``config``, ``models.obj``,
``server.wire``, ``utils.timing.RenderStats``) and imports nothing of it,
nor jax, flax or triton.
"""

__version__ = "0.4.0"
