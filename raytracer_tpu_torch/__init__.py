"""raytracer_tpu_torch — the PyTorch + CUDA port of ``raytracer_tpu``.

Slice one of the port: the default render path for sphere/plane/small-
triangle scenes (cornell_box, cubes), served end to end on one NVIDIA GPU.

- TOML scene -> ``SceneArrays`` of torch tensors (``models.loader``)
- row-band scheduling and finalize (``render.renderer``)
- the bounce megakernel, hand-written CUDA C++ for Hopper, with a plain
  PyTorch twin used for CPU tensors (``ops.megakernel``)
- the asyncio WebSocket server on the reference's wire protocol
  (``server``)

The JAX package ``raytracer_tpu`` is the reference this port is held
against. Only its JAX-free modules are imported here (``config``,
``models.obj``, ``server.wire``, ``utils.timing``); nothing in this
package imports jax, flax or triton.
"""

__version__ = "0.1.0"
