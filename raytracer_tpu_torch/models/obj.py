"""Wavefront OBJ parsing and the ``cube``/``prism`` scene geometry.

The port's own copy of ``raytracer_tpu/models/obj.py``. ``load_obj`` parses
with the native library's C++ parser, as the JAX package's does;
``parse_obj`` (numpy) is its plain version.
Reference semantics (src/geometry.rs:777-833): line-oriented; ``v`` ->
vertex, ``vn`` -> normal, ``f`` -> three ``a/b/c`` tokens of which only the
first (vertex) index is used, 1-based; everything else is ignored.
"""

from __future__ import annotations

import numpy as np


class MeshLoadError(ValueError):
    pass


def parse_obj(text: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse OBJ text -> (vertices[V,3] f64, normals[Vn,3] f64, indices[F,3] i64),
    indices 0-based."""
    verts: list[list[str]] = []
    norms: list[list[str]] = []
    faces: list[list[str]] = []
    for line in text.splitlines():
        tok = line.split()
        if not tok:
            continue
        cmd = tok[0]
        if cmd == "v":
            if len(tok) < 4:
                raise MeshLoadError("unexpected end of vertex line")
            verts.append(tok[1:4])
        elif cmd == "vn":
            if len(tok) < 4:
                raise MeshLoadError("unexpected end of normal line")
            norms.append(tok[1:4])
        elif cmd == "f":
            if len(tok) < 4:
                raise MeshLoadError("unexpected end of face line")
            faces.append([t.split("/")[0] for t in tok[1:4]])
    try:
        v = np.asarray(verts, np.float64).reshape(-1, 3)
        vn = np.asarray(norms, np.float64).reshape(-1, 3)
        idx = np.asarray(faces, np.int64).reshape(-1, 3) - 1  # 1-based -> 0-based
    except ValueError as e:
        raise MeshLoadError(f"ill-formed OBJ: {e}") from e
    if len(idx) and (idx.min() < 0 or idx.max() >= len(v)):
        raise MeshLoadError("face index out of range")
    return v, vn, idx


def load_obj(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse an OBJ file with the native host library (``utils/native.py``),
    as the JAX package's ``load_obj`` does; raises where it cannot be built."""
    from raytracer_tpu_torch.utils import native

    return native.parse_obj_file(path)


def load_obj_plain(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``load_obj`` through the numpy ``parse_obj``."""
    with open(path) as fh:
        return parse_obj(fh.read())


# The reference's 12-triangle prism index list (src/geometry.rs:839-866).
# Its winding is not consistent (half the faces point inward); that split is
# the behavioural spec of `cube`/`prism` geometry, and mesh lights depend on
# it, so it is kept exactly.
_PRISM_INDICES = np.asarray(
    [
        1, 3, 7, 1, 5, 7,  # front
        0, 2, 6, 0, 4, 6,  # back
        0, 1, 3, 0, 2, 3,  # left
        4, 5, 7, 4, 6, 7,  # right
        2, 3, 7, 2, 6, 7,  # top
        0, 1, 5, 0, 4, 5,  # bottom
    ],
    np.int64,
).reshape(-1, 3)


def prism(p: np.ndarray, width: float, height: float, depth: float) -> tuple[np.ndarray, np.ndarray]:
    """Axis-aligned prism with min corner ``p`` -> (vertices[8,3], indices[12,3])."""
    x, y, z = float(p[0]), float(p[1]), float(p[2])
    verts = np.asarray(
        [
            [x, y, z],
            [x, y, z + depth],
            [x, y + height, z],
            [x, y + height, z + depth],
            [x + width, y, z],
            [x + width, y, z + depth],
            [x + width, y + height, z],
            [x + width, y + height, z + depth],
        ],
        np.float64,
    )
    return verts, _PRISM_INDICES.copy()


def cube(p: np.ndarray, size: float) -> tuple[np.ndarray, np.ndarray]:
    return prism(p, size, size, size)
