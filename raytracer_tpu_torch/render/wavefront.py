"""Streaming (regen) wavefront integrator: the engine of BVH scenes, and of
every scene with MIS, Phong materials or a mesh light.

Port of ``raytracer_tpu/render/wavefront.py:139`` ``render_band_regen``,
with NEE and, under ``cfg.use_mis``, the balance heuristic. One lane per
(pixel, subpixel) slot renders its samples back to back; the moment a
lane's path ends (miss, Russian roulette, dead BSDF sample, depth cap) it
starts its next sample in the same iteration, and every contribution banks
straight into the lane's ``acc``. Each iteration:

1. regenerate idle lanes (camera ray from the lane's slot), park lanes with
   no work left at ``PARK_RO``/``PARK_RD`` (their rays miss at the root);
2. main trace through the BVH traversal (K2, or K4 under
   ``RT_BVH_KERNEL=binary``) on BVH scenes: the traversal's wrapper sorts
   the rays by the coherence key (K3), walks them and unsorts the hits
   (``ops/bvh_traverse.py::bvh_intersect``). Under ``RT_PERMUTE_STATE=1``
   (and the hooks that turn it on: ``RT_STATE_BF16``, ``RT_SHADOW_REVERSE``,
   ``RT_DEFER_SHADOW``) the whole lane state is permuted by that key first
   instead, and the main trace runs ``presorted``;
3. arrival emission, NEE with a shadow ray bounded at
   ``dist - visibility_margin`` that sorts by its own key, with the
   sphere-light back-face cull on BVH scenes;
4. Russian roulette and a cosine or mirror bounce.

BVH scenes also compact the tail: once at most half the loop's lanes hold
work, the working lanes move (stable) to the front of a half-width loop,
up to ``cfg.tail_compact_stages`` times.

The lane state is component-major: f32[C, lanes] (ro, rd, beta, emis, acc;
C = 15, 16 under MIS, 10 more under ``RT_DEFER_SHADOW``) and i32[4, lanes]
(active, j, depth, slot), one contiguous vector a component. A step reads
its components as views of those buffers and writes its carry back into
them; the slot row stays as it is, since only the tail compaction (and the
opt-in permutation) moves lanes, gathering along the lane axis.

Random numbers come from the counter hash of ``ops/megakernel.py``, keyed
on the lane's slot in the frame (``y0*W*4 + pixel*4 + sub``), the
iteration and the draw: ``uniform(seed, slot, it, draw)``, draws 0-1 camera
jitter, 2-3 the light sample, 4 Russian roulette, 5-6 the bounce, 7 the
Phong lobe's third draw and 8 the mesh light's (drawn only where the scene
has Phong materials or a mesh light). So a pixel's result depends neither
on the lane order (the permutation and the compaction change nothing) nor
on the band that holds it.

On a CUDA device, given a ``StepGraphs`` (every ``Renderer`` keeps one),
an iteration is a replay of a CUDA graph: the first step at each loop width
of a band key runs eagerly, the second captures the step into a graph, and
every later step at that width replays it, so the host makes one call a
step instead of the step's ~740 kernel launches. The step reads the
iteration and the dispatch seed from 0-d device tensors that the host
fills before each replay (the counter hash gives the same bits for them as
for Python ints), the camera basis is built once a band, and the step
writes its state back into the width's own buffers. The loop test, the tail
compaction and the final scatter stay eager. ``step_graphable`` decides
from the device and the one hook whose wrapper reads the host
(``RT_SHADOW_COMPACT``); on the CPU, and without a ``StepGraphs``, every
step is eager.

Spans and counters (``utils/timing.py``; live only while a ``torch.profiler``
records): each iteration's loop test is ``rt.regen.sync``, and its work
``rt.regen.camera`` (regenerate, park), ``rt.regen.sort`` (under the
permutation: key, argsort, the state's gather), ``rt.regen.trace`` (the
main trace), ``rt.regen.shadow`` (light sample and shadow trace) and
``rt.regen.shade`` (emission, material gather, BSDF, roulette, bounce,
write-back; two spans, on either side of the shadow); each tail compaction
is ``rt.regen.compact`` and the slot scatter at the end
``rt.regen.scatter``. Under a graph those phase spans run only while a step
runs eagerly or is captured; a replayed step is one span,
``rt.regen.replay``. Counted: ``regen.steps``, ``regen.lanes_stepped``
(the loop's width a step), ``regen.lanes_working`` (the lanes the loop test
found working, a step), ``host.syncs`` (one a loop test),
``regen.graph_steps`` (steps run by a replay), ``regen.graph_captures`` and
``regen.rows_gathered`` (the lanes whose state a gather moves: the loop's
width for each permuted step, the width each tail compaction compacts;
counted on the host, where both are known). A replay adds the launches it
makes to K2's, K3's and K4's ``LAUNCHES``, as the eager wrappers do. In a
scene with Phong materials the bounce also counts its Phong arms:
``regen.phong_hits``
(working lanes whose main hit is a Phong surface), ``regen.phong_lobe``
(of those, the lanes whose draw 5 picked the power-cosine lobe) and
``regen.phong_dead`` (those whose draw 5 picked nothing, which ends the
path). The step adds them on the device, lane slot by slot, into an i32
buffer the band owns (three rows of the band's width: an add into it is
one small kernel, where a sum each step would cast and reduce), so a
replayed step counts as an eager one does; the band sums the buffer once,
after its loop, only while a profiler records (one more ``host.syncs``). The arms have no span of their own: they run inside
``rt.regen.shade``, and a replayed step is one ``rt.regen.replay``.

MIS (``cfg.use_mis``) weighs the two strategies that reach the light by the
balance heuristic: the light sample's direct term is
``light_e*f*cos_x/(pdf_light_sa + pdf_bsdf)``, and emission reached through
a bounce is weighted ``pdf_prev/(pdf_prev + pdf_light_sa)``, where
``pdf_prev`` (a 16th state column, present only under MIS) is the density
of the bounce that led there, ``BIG`` after a camera ray or a mirror bounce.

The JAX engine's measurement hooks, each read at each call with JAX's name
and meaning (``utils/env.py``; a value outside a hook's set raises), none
set by the server or ``tools/render.py``:

- ``RT_PERMUTE_STATE=1`` (``wavefront.py:65``; BVH scenes): permute the
  whole lane state by the coherence key each step, so the main trace runs
  ``presorted`` (as ``permute=True``). **The port's default is 0** (JAX's
  is 1): the traces sort and unsort their own rays by the same key, which
  keeps K2's rays coherent for less device time than gathering every
  component of every lane each step;
- ``RT_SORT_GROUP=G`` (``wavefront.py:84``): the permutation moves groups
  of G consecutive lanes, ordered by their least key, where G divides the
  loop's width (``ops/keys.py::group_order``); without the permutation the
  traversal's own sort does (``ops/bvh_traverse.py``);
- ``RT_ABLATE`` = ``shadow`` / ``rng`` (``wavefront.py:403-407, :440, :531``),
  timing probes whose frames are not images: ``shadow`` takes the shadow
  lanes as visible and traces no shadow ray; ``rng`` gives every shading
  draw (light, roulette, bounce, Phong lobe, mesh-light pick) the constant
  of JAX's ``linspace(0.1, 0.9, n_draws)`` table at JAX's position
  (``ablate_draws``), camera jitter stays random. Each warns;
- ``RT_STATE_BF16=1`` (``wavefront.py:224-245``): beta and emis each ride
  one component of two bf16 halves, rounded to nearest (``pack2``),
  through the permutation's and the tail compaction's gathers: 15
  gathered float components become 12. It turns the permutation on
  (unless ``permute=False``), so the state rounds at every step, as JAX's
  does. **The port's default is f32 state** (JAX's is 1): the bf16 pair
  was a TPU gather saving, and the f32 frame is the one held against the
  references;
- ``RT_SHADOW_REVERSE=1`` (``wavefront.py:106``; BVH scenes with a sphere
  light): the shadow segment runs from the light sample to the surface,
  ``presorted`` in the main ray's order (no K3, sort or unsort for it),
  against the scene with the light sphere masked out of the sphere set of
  that trace only; it turns the permutation on (unless ``permute=False``);
- ``RT_DEFER_SHADOW=1`` (``wavefront.py:136``; BVH scenes, not under
  ``RT_SHADOW_REVERSE`` nor ``permute=False``): turns the permutation on
  for its band, since a shadow query and its unweighted direct term ride
  the lane state (``s_ro``, ``s_rd``, ``s_cap``, ``pend``: 10 more
  components) into the next iteration and resolve ``presorted`` beside its
  (permuted) main trace, banking ``vis * pend``; a lane
  with a pending query holds work, so the loop and the tail compaction
  keep it, and the band ends with one more iteration.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import threading
import warnings
from typing import NamedTuple

import torch

from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.models import vecmath as vm
from raytracer_tpu_torch.models.camera import camera_frame, camera_rays3
from raytracer_tpu_torch.models.scene import BRDF_SPECULAR, LIGHT_SPHERE, SceneArrays
from raytracer_tpu_torch.ops import brdf, bvh_binary, bvh_traverse, keys
from raytracer_tpu_torch.ops.intersect import ScenePre, trace_soa, trace_t
from raytracer_tpu_torch.ops.keys import coherence_order, group_order, sort_group
from raytracer_tpu_torch.ops.megakernel import M32, uniform
from raytracer_tpu_torch.render.integrator import sample_light3
from raytracer_tpu_torch.utils import env
from raytracer_tpu_torch.utils.timing import count, recording, span

# Parking spot for lanes with no ray this iteration: far outside any
# reference-scale scene, pointing away, so every test misses at once and
# the coherence key sorts parked lanes into the miss group.
PARK_RO = 3.0e7
PARK_RD = (1.0, 0.0, 0.0)
# pdf_prev of a vertex reached by a delta (camera ray, mirror bounce): its
# emission takes MIS weight 1.
BIG = 1e30

# Int state rows: active, j (samples started), depth, slot. A step writes
# the first three back; the slot row moves only with a gather.
ACTIVE, J, DEPTH, SLOT = 0, 1, 2, 3
# Float state rows of the loop's carry: ro, rd, beta (path throughput),
# emis (weight of the next hit's emission), acc (the lane's banked
# radiance); under MIS pdf_prev (the density of the bounce that reached the
# next hit); under RT_DEFER_SHADOW the pending query (s_ro, s_rd, s_cap)
# and its direct term pend. Under RT_STATE_BF16 the gathered state holds
# beta and emis as three rows of bf16 pairs (pack2).
ACC = slice(12, 15)


class Hooks(NamedTuple):
    """The regen engine's measurement hooks (see the module docstring)."""

    permute: bool  # RT_PERMUTE_STATE (the lane permutation)
    ablate: str  # RT_ABLATE: "", "shadow" or "rng"
    state_bf16: bool  # RT_STATE_BF16
    reverse: bool  # RT_SHADOW_REVERSE
    defer: bool  # RT_DEFER_SHADOW


def read_hooks() -> Hooks:
    return Hooks(
        permute=env.flag("RT_PERMUTE_STATE", False),
        ablate=env.choice("RT_ABLATE", "", ("", "shadow", "rng")),
        state_bf16=env.flag("RT_STATE_BF16", False),
        reverse=env.flag("RT_SHADOW_REVERSE", False),
        defer=env.flag("RT_DEFER_SHADOW", False),
    )


def pack2(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Two f32 tensors -> one f32 tensor of the bits (bf16(hi) << 16) |
    bf16(lo), each rounded to nearest (``wavefront.py:235-239``)."""
    pair = torch.stack([lo.to(torch.bfloat16), hi.to(torch.bfloat16)], dim=-1)  # little-endian: lo first
    return pair.view(torch.float32).squeeze(-1)


def unpack2(col: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``pack2``'s inverse -> (hi, lo) as f32 (``wavefront.py:241-245``)."""
    pair = col.contiguous().view(torch.bfloat16).view(*col.shape, 2).float()
    return pair[..., 1], pair[..., 0]


def ablate_draws(scene: SceneArrays) -> dict[int, float]:
    """``RT_ABLATE=rng``: the constant of each shading draw the scene uses,
    by the port's draw number. JAX lays its draws out as [light (2, or 3
    for a mesh light), roulette, bounce (2, or 3 with Phong)] and gives
    position i the value i of ``linspace(0.1, 0.9, n_draws)``; here in f32
    correctly rounded (JAX's eager and jitted tables differ by an ulp)."""
    light = 3 if scene.light_type != LIGHT_SPHERE else 2
    bsdf = 3 if scene.has_phong else 2
    table = torch.linspace(0.1, 0.9, light + 1 + bsdf, dtype=torch.float64).float().tolist()
    at = {2: 0, 3: 1, 4: light, 5: light + 1, 6: light + 2}
    if light == 3:
        at[8] = 2
    if bsdf == 3:
        at[7] = light + 3
    return {draw: table[i] for draw, i in at.items()}


def tail_widths(n: int, cfg: RenderConfig, use_bvh: bool) -> list[int]:
    """Loop widths of the compaction stages: halves of the band, rounded up
    to 1024 lanes, while they shrink and stay >= 1024."""
    widths: list[int] = []
    if use_bvh and cfg.tail_compact:
        wcur = n
        while len(widths) < cfg.tail_compact_stages:
            cand = -(-(wcur // 2) // 1024) * 1024
            if cand >= wcur or cand < 1024:
                break
            widths.append(cand)
            wcur = cand
    return widths


# The environment the step's callees read at each call (the BVH traversal's
# hooks); a captured step keeps the value it was captured under, so each is
# part of a graph's key.
STEP_ENV = ("RT_BVH_KERNEL", "RT_LEAF_TRIS", "RT_SORT_GROUP")
# The modules whose LAUNCHES a replay adds to: K2, K4, K3.
_KERNEL_MODULES = (bvh_traverse, bvh_binary, keys)
# One capture at a time in the process: a capture synchronizes the device
# and empties the allocator's cache.
_capture_lock = threading.Lock()


def step_graphable(device: torch.device) -> bool:
    """Whether the regen step on ``device`` runs as a CUDA graph: a CUDA
    device, and not under ``RT_SHADOW_COMPACT``, whose wrapper reads a live
    count on the host."""
    compact = env.choice("RT_SHADOW_COMPACT", "0", ("0", "1", "force"))
    return torch.device(device).type == "cuda" and compact == "0"


def _launches() -> list[int]:
    return [m.LAUNCHES for m in _KERNEL_MODULES]


def _add_launches(added: list[int]) -> None:
    for m, k in zip(_KERNEL_MODULES, added):
        if k:
            with m._launch_lock:
                m.LAUNCHES += k


class _Stage:
    """One loop width of a band key: the state buffers the step reads and
    writes back, and the step's graph once captured."""

    def __init__(self, fs: torch.Tensor, ints: torch.Tensor):
        self.fs, self.ints = fs, ints
        self.warm = False  # a step has run eagerly at this width
        self.graph: torch.cuda.CUDAGraph | None = None
        self.launches = [0] * len(_KERNEL_MODULES)  # the graph's K2, K4, K3 launches


class BandGraphs:
    """The graphs of one band key (``StepGraphs.band``): a ``_Stage`` a loop
    width, the 0-d tensors the step reads (iteration, dispatch seed), the
    ray count and the Phong tally it adds to, and the tensors built once a
    band that the captured step reads (``consts``). ``refs`` keeps the
    scene and its precompute, whose ids are in the key, alive while the
    graphs are; ``pools`` is the owner's memory pool a device."""

    def __init__(self, device: torch.device, pools: dict, refs: tuple):
        i64 = torch.int64
        self.device, self.pools, self.refs = device, pools, refs
        self.lock = threading.Lock()
        self.it = torch.zeros((), dtype=i64, device=device)
        self.seed = torch.zeros((), dtype=i64, device=device)
        self.rays = torch.zeros((), dtype=i64, device=device)
        self.phong: torch.Tensor | None = None
        self.consts: tuple | None = None
        self.stages: dict[int, _Stage] = {}

    def stage(self, fs: torch.Tensor, ints: torch.Tensor) -> _Stage:
        """The stage of ``fs``'s width, its buffers holding ``fs`` and ``ints``."""
        st = self.stages.get(fs.shape[1])
        if st is None:
            st = self.stages[fs.shape[1]] = _Stage(torch.empty_like(fs), torch.empty_like(ints))
        st.fs.copy_(fs)
        st.ints.copy_(ints)
        return st

    def step(self, st: _Stage, step, it: int) -> None:
        """Iteration ``it`` at ``st``'s width: eagerly the first time, then
        captured, then replayed; the step writes the new state into
        ``st``'s buffers and adds its rays to ``rays``."""
        if st.graph is None and st.warm:
            self._capture(st, step)
        if st.graph is None:
            self.it.fill_(it)
            step(self.it, st.fs, st.ints, self.rays)
            st.warm = True
            return
        with span("rt.regen.replay"):
            self.it.fill_(it)
            st.graph.replay()
        count("regen.graph_steps")
        _add_launches(st.launches)

    def _capture(self, st: _Stage, step) -> None:
        graph = torch.cuda.CUDAGraph()
        with _capture_lock, torch.cuda.device(self.device):
            pool = self.pools.get(self.device)
            if pool is None:
                pool = self.pools[self.device] = torch.cuda.graph_pool_handle()
            before = _launches()
            stream = torch.cuda.Stream(self.device)
            with torch.cuda.graph(graph, pool=pool, stream=stream, capture_error_mode="thread_local"):
                step(self.it, st.fs, st.ints, self.rays)
            # The wrappers counted the captured launches, which the replay
            # that follows makes; every replay adds them again.
            st.launches = [b - a for a, b in zip(before, _launches())]
            _add_launches([-k for k in st.launches])
        st.graph = graph
        count("regen.graph_captures")


class StepGraphs:
    """The captured regen steps of one renderer, by band key: everything a
    capture bakes in (the scene and its precompute, the config, the band's
    lane count, the samples a dispatch, the hooks, the traversal's
    environment, the device). At most ``MAX_BANDS`` keys, the least
    recently used idle one evicted first; one memory pool a device, shared
    by every graph, since a replay keeps nothing in the pool past its end.
    Threads may share it: a band holds its key's graphs while it renders,
    and a second band of the same key meanwhile steps eagerly."""

    MAX_BANDS = 8

    def __init__(self):
        self._lock = threading.Lock()
        self._bands: collections.OrderedDict = collections.OrderedDict()
        self._pools: dict = {}

    def __len__(self) -> int:
        return len(self._bands)

    @contextlib.contextmanager
    def band(self, key: tuple, device: torch.device, refs: tuple):
        """The ``BandGraphs`` of ``key``, held for the block; None when
        another band holds them."""
        with self._lock:
            bg = self._bands.get(key)
            if bg is None:
                bg = self._bands[key] = BandGraphs(device, self._pools, refs)
            self._bands.move_to_end(key)
            held = bg.lock.acquire(blocking=False)
            self._evict()
        try:
            yield bg if held else None
        finally:
            if held:
                bg.lock.release()

    def _evict(self) -> None:
        for key in list(self._bands):
            if len(self._bands) <= self.MAX_BANDS:
                return
            bg = self._bands[key]
            if bg.lock.acquire(blocking=False):  # idle: no replay of it in flight
                del self._bands[key]
                bg.lock.release()


def bounce(scene: SceneArrays, cfg: RenderConfig, mat, is_spec, nrm, o3, depth, valid, beta, u, tally=None):
    """Russian roulette and the BSDF (or mirror) bounce of a vertex, with
    draws 4 (roulette), 5-6 and, for Phong, 7 of ``u(draw)`` -> (wi,
    pdf_b, p: the survival probability, beta_next, live: the lanes whose
    path goes on). With a Phong scene and ``tally`` (i32[3, >= lanes] on the
    device), adds to its slots, lane by lane, the valid lanes on a Phong
    surface, those of them whose draw 5 picked the cosine lobe and those
    whose draw 5 picked the power-cosine lobe (the rest picked nothing)."""
    p = torch.where(depth <= cfg.rr_start_depth, 1.0, cfg.rr_survival)
    cont = valid & (u(4) < p) & (depth < cfg.max_depth)
    ub = u(5)
    picks = brdf.phong_picks(mat, ub) if scene.has_phong else None
    wi, pdf_b = brdf.sample3(
        mat, nrm, o3, ub, u(6), u(7) if scene.has_phong else ub,
        cfg.fix_phong_frame, scene.has_phong, picks,
    )
    if tally is not None and picks is not None:
        is_phong, pick_d, pick_s = picks
        on = valid & is_phong
        m = on.shape[0]
        tally[0, :m] += on
        tally[1, :m].addcmul_(on, pick_d)
        tally[2, :m].addcmul_(on, pick_s)
    f_c = brdf.eval_nonspecular3(mat, nrm, o3, wi, scene.has_phong)
    cos_c = vm.dot3(nrm, wi)
    w_nonspec = torch.where(
        (pdf_b > 1e-12)[:, None],
        f_c * (cos_c / torch.clamp_min(pdf_b, 1e-12))[:, None],
        0.0,
    )
    weight = torch.where(is_spec[:, None], mat.c_s, w_nonspec) / p[:, None]
    beta_next = beta * weight
    live = cont & (beta_next > 0.0).any(dim=1)
    return wi, pdf_b, p, beta_next, live


def render_band_regen(
    scene: SceneArrays,
    pre: ScenePre,
    cfg: RenderConfig,
    y0: int,
    rows: int,
    num_samples: int,
    seed: int,
    permute: bool | None = None,
    graphs: StepGraphs | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Render a row band -> (sums f32[rows, W, 4, 3], rays traced i64 scalar),
    on the scene's device. ``permute`` (BVH scenes) overrides
    ``RT_PERMUTE_STATE``: True permutes the lane state by the coherence key
    each step, False keeps the lanes in slot order (the traces then sort and
    unsort around the traversal themselves; ``RT_DEFER_SHADOW`` cannot
    defer), None follows the hook. With ``graphs``, where ``step_graphable``,
    the steps replay CUDA graphs kept there (the same kernels in the same
    order: the same sums); without, every step is eager. Reads the hooks of
    ``read_hooks`` once."""
    hooks = read_hooks()
    if graphs is None or not step_graphable(scene.device):
        return _render_band(scene, pre, cfg, y0, rows, num_samples, seed, permute, hooks, None)
    key = (
        id(scene), id(pre), cfg, rows * cfg.width * 4, num_samples, permute, hooks,
        tuple(os.environ.get(name) for name in STEP_ENV), scene.device,
    )
    with graphs.band(key, scene.device, (scene, pre)) as bg:
        return _render_band(scene, pre, cfg, y0, rows, num_samples, seed, permute, hooks, bg)


def _render_band(scene, pre, cfg, y0, rows, num_samples, seed, permute, hooks: Hooks, bg: BandGraphs | None):
    """``render_band_regen``'s band, its steps through ``bg`` when given."""
    eps = cfg.eps
    margin = eps.visibility_margin
    mis = cfg.use_mis
    w = cfg.width
    n = rows * w * 4
    dev = scene.device
    f32, i32 = torch.float32, torch.int32
    hard_cap = num_samples * (cfg.max_depth + 2) + 64
    bvh = scene.use_bvh
    sphere_light = scene.light_type == LIGHT_SPHERE
    cull = bvh and sphere_light
    reverse = hooks.reverse and bvh and sphere_light
    # Hooks whose JAX meaning rests on the permuted state turn the
    # permutation on: a reversed or deferred shadow trace runs presorted in
    # the main trace's order, and the bf16 state rounds at each of the
    # state's gathers, the permutation's every step.
    deferred = hooks.defer and bvh and not reverse and permute is not False
    if permute is None:
        permute = hooks.permute or hooks.state_bf16 or reverse or deferred
    permute = permute and bvh
    bf16 = hooks.state_bf16
    ablate = hooks.ablate
    draws = ablate_draws(scene) if ablate == "rng" else None
    if ablate:
        warnings.warn(f"RT_ABLATE={ablate}: a timing probe, the frame is not an image", RuntimeWarning,
                      stacklevel=2)
    # The tensors the step reads that are built once a band; a captured
    # step reads the ones of the band that captured it, which ``bg`` keeps.
    consts = bg.consts if bg is not None else None
    if consts is None:
        # The reversed segment leaves the light sphere's surface, which cannot
        # occlude it, but where f32 root noise could fake a hit just above eps:
        # its trace sees every sphere but the light.
        scene_shadow = (
            dataclasses.replace(scene, sph_valid=scene.sph_valid & (scene.sph_obj != scene.light_idx))
            if reverse else scene
        )
        consts = (
            scene.obj_emitted[scene.light_idx], scene_shadow,
            camera_frame(scene, w, cfg.height, cfg.fov_scale),
        )
        if bg is not None:
            bg.consts = consts
    light_e, scene_shadow, cam = consts
    seed_u = seed & M32
    if bg is not None:
        bg.seed.fill_(seed_u)
        seed_u = bg.seed
    base = y0 * w * 4
    c_sh = 16 if mis else 15  # first row of the pending query (deferred)

    fs = torch.zeros((c_sh + (10 if deferred else 0), n), dtype=f32, device=dev)
    if deferred:
        fs[c_sh:c_sh + 3] = PARK_RO
        fs[c_sh + 3:c_sh + 6] = torch.tensor(PARK_RD, dtype=f32, device=dev)[:, None]
    ints = torch.zeros((4, n), dtype=i32, device=dev)
    ints[SLOT] = torch.arange(base, base + n, dtype=i32, device=dev)
    if bg is None:
        rays = torch.zeros((), dtype=torch.int64, device=dev)
    else:
        st = bg.stage(fs, ints)
        fs, ints, rays = st.fs, st.ints, bg.rays
        rays.zero_()
    # The Phong arms' counts (bounce), added slot by slot over the band's steps.
    tally = None
    if scene.has_phong:
        if bg is None or bg.phong is None:  # ``n`` is in the band key
            tally = torch.zeros((3, n), dtype=i32, device=dev)
            if bg is not None:
                bg.phong = tally
        else:
            tally = bg.phong.zero_()

    def rows_of(ro, rd, beta, emis, acc, pdf_prev, sh, narrow: bool = False) -> list[torch.Tensor]:
        """The state's float components as [k, lanes] blocks in the order of
        ``fs``'s rows: the loop's carry, or (``narrow``) the gathered state
        with beta and emis as bf16 pairs."""
        out = [c[None] for c in (*ro, *rd)]
        out += [pack2(beta, emis).t()] if narrow else [beta.t(), emis.t()]
        out.append(acc.t())
        if mis:
            out.append(pdf_prev[None])
        if deferred:
            s_ro, s_rd, s_cap, pend = sh
            out += [c[None] for c in (*s_ro, *s_rd, s_cap)] + [pend.t()]
        return out

    def pack(*state, narrow: bool = False) -> torch.Tensor:
        """The state as a new f32[C, lanes] (``rows_of``)."""
        return torch.cat(rows_of(*state, narrow=narrow))

    def unpack(fs: torch.Tensor, narrow: bool = False):
        """``pack``'s inverse -> (ro, rd, beta, emis, acc, pdf_prev, sh): views
        of ``fs``'s rows, the 3-vectors of colour as [lanes, 3]."""
        if narrow:
            beta, emis = (v.t() for v in unpack2(fs[6:9]))
            c = 9
        else:
            beta, emis = fs[6:9].t(), fs[9:12].t()
            c = 12
        acc = fs[c:c + 3].t()
        c += 3
        pdf_prev = fs[c] if mis else None
        c += int(mis)
        sh = None
        if deferred:
            sh = (tuple(fs[c:c + 3]), tuple(fs[c + 3:c + 6]), fs[c + 6], fs[c + 7:c + 10].t())
        return tuple(fs[0:3]), tuple(fs[3:6]), beta, emis, acc, pdf_prev, sh

    def step(it, fs: torch.Tensor, ints: torch.Tensor, rays: torch.Tensor) -> None:
        """One iteration on the state in ``fs`` and ``ints``, written back
        into them, its rays added to ``rays``; ``it`` an int or a 0-d i64
        tensor on the device."""
        with span("rt.regen.camera"):
            active = ints[ACTIVE] != 0
            j = ints[J]
            slot = ints[SLOT]
            depth = ints[DEPTH]
            ro, rd, beta, emis, acc, pdf_prev, sh = unpack(fs)
            slot64 = slot.to(torch.int64)

            def u(draw: int) -> torch.Tensor:
                if draws is not None and draw in draws:
                    return torch.full(slot64.shape, draws[draw], dtype=f32, device=dev)
                return uniform(seed_u, slot64, it, draw)

            # 1) regenerate: idle lanes start their next sample
            got = ~active & (j < num_samples)
            pix = slot // 4
            sub = slot % 4
            cro, crd = camera_rays3(
                scene, w, cfg.height, cfg.fov_scale,
                (pix % w).to(f32), (pix // w).to(f32), (sub % 2).to(f32), (sub // 2).to(f32),
                u(0), u(1), cam,
            )
            g3 = got[:, None]
            ro = vm.where3(got, cro, ro)
            rd = vm.where3(got, crd, rd)
            depth = torch.where(got, 0, depth)
            beta = torch.where(g3, 1.0, beta)
            emis = torch.where(g3, 1.0, emis)
            if mis:
                pdf_prev = torch.where(got, BIG, pdf_prev)
            j = torch.where(got, j + 1, j)
            active = active | got

            # 1b) park lanes without work
            ro = vm.where3(active, ro, PARK_RO)
            rd = vm.where3(active, rd, PARK_RD)
        if permute:
            # 1c) permute the lane state by the key
            with span("rt.regen.sort"):
                p_fs = pack(ro, rd, beta, emis, acc, pdf_prev, sh, narrow=bf16)
                p_ints = torch.stack([active.to(i32), j, depth, slot])
                m = p_ints.shape[1]
                g = sort_group(m)
                if g > 1:
                    order_g = group_order(scene, ro, rd, eps, g)
                    p_fs = p_fs.view(p_fs.shape[0], -1, g)[:, order_g].view(-1, m)
                    p_ints = p_ints.view(4, -1, g)[:, order_g].view(4, m)
                else:
                    order = coherence_order(scene, ro, rd, eps)
                    p_fs, p_ints = p_fs[:, order], p_ints[:, order]
                active, j, depth, slot = p_ints.unbind(0)
                active = active != 0
                slot64 = slot.to(torch.int64)
                ro, rd, beta, emis, acc, pdf_prev, sh = unpack(p_fs, narrow=bf16)

        # 2) main trace: camera and continuation rays together
        with span("rt.regen.trace"):
            rays += active.sum()
            hit = trace_soa(scene, pre, ro, rd, eps, presorted=permute)
            valid = active & hit.valid

        if deferred:
            # 2b) the previous iteration's shadow queries, in this
            # iteration's order: they leave the vertex the continuation ray
            # leaves. Visible when the nearest hit is at or past the cap.
            with span("rt.regen.shadow"):
                s_ro, s_rd, s_cap, pend = sh
                if ablate == "shadow":
                    vis_prev = torch.ones_like(s_cap, dtype=torch.bool)
                else:
                    sh_t, sh_valid = trace_t(scene, pre, s_ro, s_rd, eps, t_max=s_cap, presorted=True)
                    vis_prev = ~sh_valid | (sh_t >= s_cap)
                acc = acc + torch.where(vis_prev[:, None], pend, 0.0)

        with span("rt.regen.shade"):
            # 3) arrival: emission through the bounce
            em_next = scene.obj_emitted[hit.obj]
            if mis:
                cos_yb = torch.clamp_min(-vm.dot3(hit.n, rd), 1e-8)
                pdf_l_sa = (hit.t * hit.t) / (cos_yb * scene.light_area)
                w_b = torch.where(hit.obj == scene.light_idx, pdf_prev / (pdf_prev + pdf_l_sa), 1.0)
                acc = torch.where(valid[:, None], acc + emis * em_next * w_b[:, None], acc)
            else:
                acc = torch.where(valid[:, None], acc + emis * em_next, acc)
            x, nrm = hit.pos, hit.n
            o3 = vm.neg3(rd)
            depth = torch.where(active, depth + 1, depth)
            mat = brdf.gather_mat(scene, hit.obj)
            is_spec = mat.brdf_type == BRDF_SPECULAR

        # 4) NEE: a light sample and its bounded shadow ray
        with span("rt.regen.shadow"):
            ul = u(2)
            y, ny, pdf_l = sample_light3(scene, ul, u(3), ul if sphere_light else u(8))
            to_y = vm.sub3(y, x)
            dist = torch.sqrt(vm.norm2_3(to_y))
            wi_d = vm.scale3(to_y, 1.0 / torch.clamp_min(dist, 1e-20))
            r2 = torch.clamp_min(dist * dist, 1e-20)
            cos_y = -vm.dot3(ny, wi_d)
            nee = valid & ~is_spec
            # Every NEE lane counts as a ray, culled or not: the reference traces
            # every visibility ray (src/scene.rs:218-229).
            rays += nee.sum()
            # A sample on the light's far side is self-occluded by the convex
            # light sphere; BVH scenes skip its trace.
            shadow = nee & (cos_y > 0.0) if cull else nee
            cap = torch.where(shadow, dist - margin, 0.0)
            vis = None  # deferred: resolved in the next iteration (2b)
            if deferred:
                sh = (vm.where3(shadow, x, PARK_RO), vm.where3(shadow, wi_d, PARK_RD), cap)
            elif ablate == "shadow":
                vis = shadow
            elif reverse:
                sh_t, sh_valid = trace_t(
                    scene_shadow, pre,
                    vm.where3(shadow, y, PARK_RO), vm.where3(shadow, vm.neg3(wi_d), PARK_RD), eps,
                    t_max=cap, presorted=True,
                )
                vis = ~sh_valid | (sh_t + margin >= dist)
            else:
                sh_t, sh_valid = trace_t(
                    scene, pre,
                    vm.where3(shadow, x, PARK_RO), vm.where3(shadow, wi_d, PARK_RD), eps,
                    t_max=cap,
                )
                vis = ~sh_valid | (sh_t + margin >= dist)
            if vis is not None and cull:
                vis = vis & (cos_y > 0.0)

        with span("rt.regen.shade"):
            f_d = brdf.eval_nonspecular3(mat, nrm, o3, wi_d, scene.has_phong)
            cos_x = vm.dot3(nrm, wi_d)
            if mis:
                pdf_l_sa_d = pdf_l * r2 / torch.clamp_min(cos_y, 1e-8)
                pdf_b_at = brdf.pdf3(mat, nrm, o3, wi_d)
                ok = (cos_y > 0.0) & (cos_x > 0.0) if vis is None else vis & (cos_y > 0.0) & (cos_x > 0.0)
                direct = torch.where(
                    ok[:, None],
                    light_e[None, :] * f_d * (cos_x / (pdf_l_sa_d + pdf_b_at))[:, None],
                    0.0,
                )
            elif vis is None:
                direct = light_e[None, :] * f_d * (cos_x * cos_y / (r2 * pdf_l))[:, None]
            else:
                scale = torch.where(vis, 1.0, 0.0) * cos_x * cos_y / (r2 * pdf_l)
                direct = light_e[None, :] * f_d * scale[:, None]
            if deferred:
                sh = sh + (torch.where(shadow[:, None], beta * direct, 0.0),)
            else:
                acc = acc + torch.where(nee[:, None], beta * direct, 0.0)

            # 5) Russian roulette and the bounce
            wi, pdf_b, p, beta_next, live = bounce(scene, cfg, mat, is_spec, nrm, o3, depth, valid, beta, u, tally)
            # A mirror bounce collects the next hit's emission at beta/p. Without
            # MIS a non-specular one collects none (NEE counted the light); with
            # MIS it collects at beta_next times the balance weight.
            if mis:
                emis = torch.where(is_spec[:, None], beta / p[:, None], beta_next)
                pdf_prev = torch.where(is_spec, BIG, pdf_b)
            else:
                emis = torch.where(is_spec[:, None], beta / p[:, None], 0.0)

            # 6) continue; ended paths regenerate next iteration. Every
            # component written is a new tensor, none a view of the state.
            ro = vm.where3(live, x, ro)
            rd = vm.where3(live, wi, rd)
            torch.cat(rows_of(ro, rd, beta_next, emis, acc, pdf_prev, sh), out=fs)
            torch.stack([live.to(i32), j, depth], out=ints[:SLOT])
            if permute:
                ints[SLOT].copy_(slot)

    def work(fs: torch.Tensor, ints: torch.Tensor) -> torch.Tensor:
        """Lanes with a path in flight, samples left or a pending query."""
        busy = (ints[ACTIVE] != 0) | (ints[J] < num_samples)
        return busy | (fs[c_sh + 6] > 0.0) if deferred else busy

    it = 0

    def run(fs, ints, limit: int) -> None:
        """Step until no lane has work, ``hard_cap``, or <= ``limit`` lanes work."""
        nonlocal it
        width = ints.shape[1]
        while it < hard_cap:
            with span("rt.regen.sync"):
                working = int(work(fs, ints).sum())
            count("host.syncs")
            if working <= limit:
                break
            count("regen.steps")
            count("regen.lanes_stepped", width)
            count("regen.lanes_working", working)
            if permute:
                count("regen.rows_gathered", width)
            if bg is None:
                step(it, fs, ints, rays)
            else:
                bg.step(bg.stages[width], step, it)
            it += 1

    tail_slots, tail_accs = [], []
    for w2 in tail_widths(n, cfg, bvh):
        run(fs, ints, w2)
        # Stable: working lanes first in their current order; finished
        # lanes' slots and sums leave with the tail.
        with span("rt.regen.compact"):
            order2 = torch.argsort((~work(fs, ints)).to(i32), stable=True)
            head, tail = order2[:w2], order2[w2:]
            count("regen.rows_gathered", ints.shape[1])
            tail_slots.append(ints[SLOT][tail])
            tail_accs.append(fs[ACC][:, tail])
            if bf16:
                fs = pack(*unpack(pack(*unpack(fs), narrow=True)[:, head], narrow=True))
            else:
                fs = fs[:, head]
            ints = ints[:, head]
            if bg is not None:
                st = bg.stage(fs, ints)
                fs, ints = st.fs, st.ints
    run(fs, ints, 0)
    if tally is not None and recording():
        hits, diffuse, lobe = tally.sum(dim=1).tolist()
        dead = hits - diffuse - lobe
        count("host.syncs")
        count("regen.phong_hits", hits)
        count("regen.phong_lobe", lobe)
        count("regen.phong_dead", dead)

    with span("rt.regen.scatter"):
        slot = torch.cat([ints[SLOT]] + tail_slots).to(torch.int64) - base
        acc = torch.cat([fs[ACC]] + tail_accs, dim=1)
        out = torch.empty((n, 3), dtype=f32, device=dev)
        out[slot] = acc.t()
    # Nothing that leaves the band is a graph's buffer.
    return out.view(rows, w, 4, 3), rays if bg is None else rays.clone()
