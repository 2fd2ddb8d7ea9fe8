"""Parity check on the live device: every kernel against its plain twin.

Port of ``raytracer_tpu/tools/parity.py``. The CPU tests hold the twins
against the JAX package; this tool holds the compiled CUDA kernels against
the twins on whatever card is live, on rays of a scene made with numpy from
a seed: half camera rays (coherent), half random rays from inside twice the
root box (stress), sorted by the coherence key as the engine sorts them.

- K3 (``ops/keys.py``): every key equal;
- K2 (``ops/bvh_traverse.py``) and K4 (``ops/bvh_binary.py``): the same hit
  mask, t bit-equal on at least ``T_EXACT_SHARE`` of the rays, and a
  differing triangle index only where both triangles give the same t (a
  ray through a shared edge or vertex);
- K4 against K2: the same t (both are exact searches with one t expression).

On ``--device cpu`` there is no kernel: the twins are held against each
other (K4's against K2's, and K2's through the sorting wrapper
``bvh_intersect`` against itself unsorted).

Usage:  python -m raytracer_tpu_torch.tools.parity [scenes/flying_unicorn.toml ...]
            [--n 131072] [--seed 0] [--device cuda]
Exit code 0 when every scene agrees, 1 otherwise.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch


def parity_rays(scene, cfg, n: int, seed: int):
    """n rays on the scene's device -> (ro, rd) component tuples: n // 2
    camera rays through random pixels, the rest from random points of twice
    the root box in uniform directions."""
    from raytracer_tpu_torch.models.camera import camera_rays3

    dev = scene.device
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    nc = n // 2
    z = torch.zeros(nc, device=dev)
    ro_c, rd_c = camera_rays3(
        scene, cfg.width, cfg.height, cfg.fov_scale,
        t(rng.random(nc) * cfg.width), t(rng.random(nc) * cfg.height), z, z,
        t(rng.random(nc)), t(rng.random(nc)),
    )
    lo, hi = scene.bvh_lo[0].cpu().numpy(), scene.bvh_hi[0].cpu().numpy()
    centre, ext = (lo + hi) / 2, hi - lo
    ro_r = centre + (rng.random((n - nc, 3)) - 0.5) * ext * 2.0
    v = rng.standard_normal((n - nc, 3))
    rd_r = v / np.linalg.norm(v, axis=1, keepdims=True)
    ro = tuple(torch.cat([ro_c[k].contiguous(), t(ro_r[:, k])]) for k in range(3))
    rd = tuple(torch.cat([rd_c[k], t(rd_r[:, k])]) for k in range(3))
    return ro, rd


def _agree(label: str, scene, ro, rd, got, want) -> bool:
    """``got`` and ``want`` are (t, idx) of two traversals of the same rays."""
    from raytracer_tpu_torch.ops import bvh_traverse as bt

    (t_g, i_g), (t_w, i_w) = got, want
    mask_eq = bool(((t_g < 1e30) == (t_w < 1e30)).all())
    same = (t_g == t_w).double().mean().item()
    differ = i_g != i_w
    ties = torch.equal(
        bt.leaf_t(scene, ro, rd, i_g)[differ], bt.leaf_t(scene, ro, rd, i_w)[differ]
    )
    ok = mask_eq and same >= bt.T_EXACT_SHARE and ties
    print(f"  {label}: hit masks equal {mask_eq}, t bit-equal on {same:.6%}, index differs on "
          f"{int(differ.sum())} rays (ties: {ties}) -> {'OK' if ok else 'MISMATCH'}")
    return ok


def run(scene_path: str, n: int = 1 << 17, seed: int = 0, device: str = "cuda") -> bool:
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.models.loader import load_scene
    from raytracer_tpu_torch.ops import bvh_binary as bb
    from raytracer_tpu_torch.ops import bvh_traverse as bt
    from raytracer_tpu_torch.ops import keys

    cfg = RenderConfig()
    eps = cfg.eps
    scene = load_scene(scene_path, device=device)
    if not scene.use_bvh:
        print(f"{scene.name}: no BVH (no mesh): nothing to compare")
        return True
    dev = scene.device
    ro, rd = parity_rays(scene, cfg, n, seed)
    print(f"{scene.name}: device={dev} rays={n}")

    key_twin = keys.coherence_key_twin(scene, ro, rd, eps)
    ok = True
    if dev.type == "cuda":
        n_diff = int((keys.coherence_key_cuda(scene, ro, rd, eps) != key_twin).sum())
        print(f"  K3 kernel vs twin: keys differ on {n_diff} rays -> {'OK' if n_diff == 0 else 'MISMATCH'}")
        ok &= n_diff == 0
    order = torch.argsort(key_twin, stable=True)
    ro_s = tuple(c[order] for c in ro)
    rd_s = tuple(c[order] for c in rd)
    inf = torch.full((n,), bt.INF, dtype=torch.float32, device=dev)
    none = torch.zeros(n, dtype=torch.bool, device=dev)
    args = (scene, ro_s, rd_s, inf, none, False, eps)
    k2_twin = bt.bvh_traverse_twin(*args)
    k4_twin = bb.bvh_binary_twin(*args)
    if dev.type == "cuda":
        k2, k4 = bt.bvh_traverse_cuda(*args), bb.bvh_binary_cuda(*args)
        torch.cuda.synchronize(dev)
        ok &= _agree("K2 kernel vs twin", scene, ro_s, rd_s, k2, k2_twin)
        ok &= _agree("K4 kernel vs twin", scene, ro_s, rd_s, k4, k4_twin)
        ok &= _agree("K4 kernel vs K2 kernel", scene, ro_s, rd_s, k4, k2)
    else:
        ok &= _agree("K4 twin vs K2 twin", scene, ro_s, rd_s, k4_twin, k2_twin)
        t_w, i_w = bt.bvh_intersect(scene, ro, rd, eps)  # sorts, walks, unsorts
        unsorted = bt.bvh_traverse_twin(scene, ro, rd, inf, none, False, eps)
        clipped = (unsorted[0], unsorted[1].clamp(0, scene.tri_a.shape[0] - 1))
        ok &= _agree("K2 twin sorted vs unsorted", scene, ro, rd, (t_w, i_w), clipped)
    hits = float((k2_twin[0] < 1e30).double().mean())
    print(f"  hit share {hits:.3f} -> {'OK' if ok else 'MISMATCH'}")
    return bool(ok)


def main(argv=None) -> int:
    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")
    p = argparse.ArgumentParser(prog="raytracer-tpu-torch-parity")
    p.add_argument("scenes", nargs="*", default=[os.path.join(here, "scenes", "flying_unicorn.toml")])
    p.add_argument("--n", type=int, default=1 << 17)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)
    ok = all([run(s, args.n, args.seed, args.device) for s in args.scenes])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
