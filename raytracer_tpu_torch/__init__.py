"""raytracer_tpu_torch — the PyTorch + CUDA port of ``raytracer_tpu``.

Slices one and two of the port: the reference's three default scenes
(cornell_box, cubes, flying_unicorn) rendered and served end to end on one
NVIDIA GPU.

- TOML scene -> ``SceneArrays`` of torch tensors, with a BVH over mesh
  triangles (``models.loader``, ``ops.bvh``)
- row-band scheduling and finalize (``render.renderer``)
- two engines: the bounce megakernel (``ops.megakernel``, K1) for
  sphere/plane/small-triangle scenes, and the streaming regen engine
  (``render.wavefront``) for BVH scenes, with the 8-wide traversal
  (``ops.bvh_traverse``, K2) and the coherence key (``ops.keys``, K3)
- every kernel is hand-written CUDA C++ for Hopper (``ops/csrc``) with a
  plain PyTorch twin beside it, used for CPU tensors
- the asyncio WebSocket server on the reference's wire protocol
  (``server``)

The JAX package ``raytracer_tpu`` is the reference this port is held
against. Only its JAX-free modules are imported here (``config``,
``models.obj``, ``server.wire``, ``utils.timing``); nothing in this
package imports jax, flax or triton.
"""

__version__ = "0.2.0"
