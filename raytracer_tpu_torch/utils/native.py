"""ctypes binding to the native host library (``native/*.cpp``).

The port's own counterpart of ``raytracer_tpu/utils/native.py``. At first
use ``native/rt_native.cpp`` and ``native/cpu_tracer.cpp`` are compiled in
place with ``$CXX`` (default ``g++``) and the flags of ``native/Makefile``
into ``build/raytracer_tpu_torch/librt_native-<hash>.so`` (``ops/_build.py
::build_host``: the hash covers both sources and the flags). Both packages
thus read one source and no copy of it can drift.

Entry points:

- ``parse_obj_file``: the C++ OBJ parser (``models/obj.py::load_obj``);
- ``pack_rows_blob`` / ``pack_row``: the wire packer (``server/wire.py``);
- ``cpu_render_band``: the reference-style multithreaded CPU tracer, the
  fair 1x baseline of ``bench_torch.py`` (scalar f64 recursion, a skip-link
  BVH walk per ray, one thread a row stripe).

There is no fallback: where the JAX package's binding returns None without
its library, this one raises ``RuntimeError`` with the compiler's output.
``models/obj.py::parse_obj`` and ``server/wire.py::pack_row_plain`` stay as
the plain versions the tests hold these against.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from raytracer_tpu_torch.ops import _build

NATIVE_DIR = os.path.join(os.path.dirname(_build._PKG), "native")
SOURCES = ("rt_native.cpp", "cpu_tracer.cpp")
# native/Makefile: CXXFLAGS without the warnings, -shared, and -lpthread.
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
LIBS = ("-lpthread",)

_D = ctypes.POINTER(ctypes.c_double)
_F = ctypes.POINTER(ctypes.c_float)
_I = ctypes.POINTER(ctypes.c_int)
_U8 = ctypes.POINTER(ctypes.c_uint8)


def sources() -> list[str]:
    return [os.path.join(NATIVE_DIR, s) for s in SOURCES]


def build() -> tuple[str, str]:
    """(library path, compiler output; empty when already built)."""
    return _build.build_host("rt_native", sources(), CXX_FLAGS, LIBS)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(build()[0])
    lib.rt_obj_counts.restype = ctypes.c_int
    lib.rt_obj_counts.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_long)]
    lib.rt_obj_parse.restype = ctypes.c_int
    lib.rt_obj_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_long, _D, _D, ctypes.POINTER(ctypes.c_long),
        ctypes.c_long,  # n_verts, the bound of a face index
    ]
    lib.rt_pack_rows.restype = ctypes.c_long
    lib.rt_pack_rows.argtypes = [_U8, ctypes.c_int, ctypes.c_int, _I, ctypes.c_int, _U8]
    lib.rt_cpu_render_band.restype = ctypes.c_longlong
    lib.rt_cpu_render_band.argtypes = [
        _D, ctypes.c_int,  # spheres
        _D, ctypes.c_int,  # planes
        _D, ctypes.c_int,  # triangles
        _F, _F, _I, _I, _I, ctypes.c_int, ctypes.c_int,  # bvh
        _D, ctypes.c_int,  # materials
        _D,  # camera
        _D, ctypes.c_int,  # light
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # width, height, y0, rows
        ctypes.c_int, ctypes.c_ulonglong, ctypes.c_int,  # spp, seed, n_threads
        _D,  # out
    ]
    return lib


def parse_obj_file(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """C++ OBJ parse -> (verts f64[V,3], normals f64[Vn,3], faces i64[F,3]),
    0-based; ``MeshLoadError`` on a malformed line or a face index out of
    range."""
    lib = _lib()
    with open(path, "rb") as fh:
        data = fh.read()
    counts = (ctypes.c_long * 3)()
    lib.rt_obj_counts(data, len(data), counts)
    nv, nn, nf = counts[0], counts[1], counts[2]
    verts = np.empty((nv, 3), np.float64)
    norms = np.empty((nn, 3), np.float64)
    faces = np.empty((nf, 3), np.int64)
    rc = lib.rt_obj_parse(
        data, len(data), verts.ctypes.data_as(_D), norms.ctypes.data_as(_D),
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_long)), nv,
    )
    if rc != 0:
        from raytracer_tpu_torch.models.obj import MeshLoadError

        raise MeshLoadError(f"native OBJ parse failed (code {rc}) for {path}")
    return verts, norms, faces


def pack_rows_blob(rgb: np.ndarray, y_labels, pixels_per_msg: int = 60) -> bytes:
    """Rows [R, W, 3] u8 -> one buffer of concatenated RenderedPixels
    messages, row after row, ``pixels_per_msg`` pixels a message, row r
    labelled ``y_labels[r]``."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    n_rows, width, _ = rgb.shape
    labels = np.ascontiguousarray(y_labels, np.int32)
    if labels.shape != (n_rows,) or not 0 < pixels_per_msg <= 255:
        raise ValueError(f"{labels.shape} labels for {n_rows} rows, {pixels_per_msg} pixels a message")
    msgs_per_row = -(-width // pixels_per_msg)
    out = np.empty(n_rows * (msgs_per_row * 6 + width * 3), np.uint8)
    n = _lib().rt_pack_rows(
        rgb.ctypes.data_as(_U8), n_rows, width, labels.ctypes.data_as(_I), pixels_per_msg,
        out.ctypes.data_as(_U8),
    )
    if n < 0:
        raise RuntimeError(f"rt_pack_rows failed ({n})")
    return out[:n].tobytes()


def pack_row(y: int, rgb_row: np.ndarray, pixels_per_msg: int = 60) -> list[bytes]:
    """One row (label ``y``) -> its messages, one bytes object each."""
    blob = pack_rows_blob(rgb_row[None], [y], pixels_per_msg)
    out, off = [], 0
    while off < len(blob):
        end = off + 6 + 3 * blob[off + 1]
        out.append(blob[off:end])
        off = end
    return out


def cpu_render_band(
    scene, width: int, height: int, y0: int, rows: int, spp: int,
    seed: int = 0, n_threads: int = 0,
) -> tuple[np.ndarray, int] | None:
    """Reference-style native CPU render of rows [y0, y0 + rows) of a
    ``width`` x ``height`` frame (``native/cpu_tracer.cpp``) -> (pixel RGB f64
    [rows, width, 3], pre-gamma in [0, 1], rays traced), or None for a scene
    with a mesh light, which the tracer lacks (as the JAX binding).

    ``scene`` is the port's ``SceneArrays`` on any device, marshalled as the
    JAX binding marshals its own. ``n_threads`` 0: one thread per core.
    """
    if scene.light_type != 0:
        return None

    def a(t) -> np.ndarray:
        return t.detach().cpu().numpy()

    ns, npl = scene.n_spheres, scene.n_planes
    sph = np.concatenate(
        [a(scene.sph_pos)[:ns], a(scene.sph_r)[:ns, None], a(scene.sph_obj)[:ns, None].astype(np.float64)], axis=1,
    ) if ns else np.zeros((0, 5))
    pln = np.concatenate(
        [a(scene.pln_pos)[:npl], a(scene.pln_n)[:npl], a(scene.pln_obj)[:npl, None].astype(np.float64)], axis=1,
    ) if npl else np.zeros((0, 7))
    tri = np.concatenate(
        [a(scene.tri_a), a(scene.tri_b), a(scene.tri_c), a(scene.tri_obj)[:, None].astype(np.float64)], axis=1,
    )
    mats = np.concatenate(
        [a(scene.brdf_type)[:, None].astype(np.float64), a(scene.c_d), a(scene.c_s), a(scene.k_d)[:, None],
         a(scene.k_s)[:, None], a(scene.phong_power)[:, None], a(scene.obj_emitted)], axis=1,
    )
    cam = np.concatenate([a(scene.cam_pos), a(scene.cam_dir)])
    light = np.concatenate([a(scene.light_sph_pos), a(scene.light_sph_r)[None]])
    sph, pln, tri, mats, cam, light = (np.ascontiguousarray(x, np.float64) for x in (sph, pln, tri, mats, cam, light))
    bvh_lo, bvh_hi = (np.ascontiguousarray(a(t), np.float32) for t in (scene.bvh_lo, scene.bvh_hi))
    skip, first, count = (np.ascontiguousarray(a(t), np.int32)
                          for t in (scene.bvh_skip, scene.bvh_first, scene.bvh_count))
    n_nodes = bvh_lo.shape[0] if scene.use_bvh else 0
    out = np.zeros((rows, width, 3), np.float64)
    rays = _lib().rt_cpu_render_band(
        sph.ctypes.data_as(_D), ns, pln.ctypes.data_as(_D), npl, tri.ctypes.data_as(_D), tri.shape[0],
        bvh_lo.ctypes.data_as(_F), bvh_hi.ctypes.data_as(_F), skip.ctypes.data_as(_I),
        first.ctypes.data_as(_I), count.ctypes.data_as(_I), n_nodes, scene.bvh_tri_start,
        mats.ctypes.data_as(_D), scene.n_objects, cam.ctypes.data_as(_D), light.ctypes.data_as(_D),
        scene.light_idx, width, height, y0, rows, spp, seed, n_threads, out.ctypes.data_as(_D),
    )
    return out, int(rays)
