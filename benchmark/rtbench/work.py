"""The yardstick of the kernels' rooflines: the chip's peaks and the work
that a frame's inputs need, counted from the reference's rays.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet): 67 TFLOP/s in float32
outside the tensor cores (a fused multiply-add counts two), 3.35 TB/s of
HBM3. A kernel's least time is the larger of its operations over the first
and its bytes over the second.

Operations are counted from the algorithm's expressions (an add, subtract,
multiply, divide, square root, sine, cosine, minimum, maximum or float
compare is one; the counter hash's integer work and the loads are not
counted):

- the sphere/plane kernel tests every primitive for every ray it traces (it
  is brute force by design): a sphere test 25, a plane test 21; a camera
  ray's set-up 46; a bounce besides its test (hit point, normal, emission,
  roulette, BSDF sample, throughput) 130; a shadow ray besides its test
  (light sample, geometry terms) 60. Bytes: each lane's radiance sum and
  ray count out (16), the scene table in (4 a float).
- a BVH walk: per ray the inverse direction 9; per box tested 26 (two slab
  bounds on three axes, the entry and exit, three compares); per triangle
  of a visited leaf 16 (denominator, distance, its tests); per candidate
  (a triangle whose distance can still win) 30 more (the barycentric
  coordinates and their tests). The boxes and visits are those of the
  benchmark's own tree (``reference/bvh.py``). Bytes: 37 a ray (origin,
  direction, bound and flag in; distance and index out) and the tree once.
"""

from __future__ import annotations

PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

K1_OPS = dict(sphere=25, plane=21, camera=46, bounce=130, shadow=60)
WALK_OPS = dict(ray=9, box=26, tri=16, cand=30)


def least_s(ops: float, nbytes: float) -> float:
    """The least time the work could take on one card."""
    return max(ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)


def k1_work(counts: dict, n_spheres: int, n_planes: int, lanes: int, n_objects: int) -> tuple[float, float]:
    """(operations, bytes) of the sphere/plane kernel for ``counts`` of
    camera rays, main traces and shadow rays over ``lanes`` lanes."""
    test = K1_OPS["sphere"] * n_spheres + K1_OPS["plane"] * n_planes
    ops = (counts["camera"] * K1_OPS["camera"] + counts["bounce"] * (test + K1_OPS["bounce"])
           + counts["shadow"] * (test + K1_OPS["shadow"]))
    nbytes = lanes * 16 + (20 + 5 * n_spheres + 7 * n_planes + 10 * n_objects) * 4
    return ops, nbytes


def walk_work(counts: dict, table_bytes: int) -> tuple[float, float]:
    """(operations, bytes) of a BVH walk's counted visits."""
    ops = (counts["rays"] * WALK_OPS["ray"] + counts["boxes"] * WALK_OPS["box"]
           + counts["tris"] * WALK_OPS["tri"] + counts["cand"] * WALK_OPS["cand"])
    return ops, counts["rays"] * 37 + table_bytes
