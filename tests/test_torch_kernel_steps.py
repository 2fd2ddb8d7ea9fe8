"""The design-step variants of K1-K4 (``tools/kernel_steps.py``), on the
CPU: each variant's source is built from the shipped one, the register
sorting network orders the children as the shipped insertion does, and the
helpers that ``chip_smoke.py`` shares parse and draw what they should. The
variants themselves compile and run only on a CUDA card
(``python -m raytracer_tpu_torch.tools.kernel_steps``)."""

import itertools
import os

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.models.loader import load_scene
from raytracer_tpu_torch.ops import _build
from raytracer_tpu_torch.ops.intersect import scene_precompute
from raytracer_tpu_torch.tools import kernel_steps as ks

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")

# A line each variant's source must hold (and the shipped one must not).
MARK = {
    "K1_launch_bounds_1": "__launch_bounds__(MEGA_BLOCK, 1)",
    "K1_const_materials": "const float* mats = pf + lay.mat;",
    "K1_smem_table": "pf = tab_s;",
    "K2_shared_stack": "const Column<int> stk{smem + threadIdx.x};",
    "K2_sort_network": "if (q < h) stk[sp + q] = vv[q];",
    "K2_lazy_uv": "if (u >= 0.0f && v >= 0.0f && u + v <= 1.0f) {",
    "K2_padded_rows": "for (int j = 0; j < p.max_leaf; ++j) {",
    "K2_smem_nodes": "cudaFuncSetAttribute(bvh8_kernel",
    "K3_runtime_loop": "  auto kernel = key_kernel<0>;",
    "K3_two_rays": "#define KEY_RAYS 2",
    "K3_four_rays": "#define KEY_RAYS 4",
    "K3_sign_select": "const float lo = back ? t1 : t0, hi = back ? t0 : t1;",
    "K3_octant_scan": "case 0: nearest_cut<NC, 0>(tab, n_cut, ro, inv, tri_tmin, best_t, best_i); break;",
    "K3_full_unroll": "#pragma unroll\n  for (int c = 0; c < n_cut; ++c) {",
    "K4_node12": "first = (int)__ldg(nd + NODE_F4 * (node - 1) + 2).x;",
    "K4_one_node_a_turn": "    } while (false);",
    "K4_fetch_ahead": "const float4 na = __ldg(nd + NODE_F4 * ahead), nb = __ldg(nd + NODE_F4 * ahead + 1);",
    "K4_leaf_unroll_2": "#define LEAF_UNROLL 2",
    "K4_leaf_loop_rolled": "#define LEAF_UNROLL 1",
    "K4_fixed_order": "const int octant = 0;",
}


def _shipped(name: str) -> str:
    with open(os.path.join(_build.CSRC, f"{ks.EDITS[name][0]}.cu")) as fh:
        return fh.read()


@pytest.mark.parametrize("name", sorted(ks.EDITS))
def test_variant_source_is_the_shipped_one_with_its_edits(name):
    src, shipped = ks.variant_source(name), _shipped(name)
    if name.endswith("_shipped"):
        assert src == shipped
    else:
        assert MARK[name] in src and MARK[name] not in shipped
        assert "extern \"C\" int rt_" in src  # the same C interface
        assert src.count("__global__") == shipped.count("__global__")


def test_every_kernel_has_its_shipped_entry_and_its_steps():
    for kernel, n_steps in (("K1", 3), ("K2", 5), ("K3", 6), ("K4", 6)):
        assert ks.EDITS[f"{kernel}_shipped"][1] == []
        assert sum(n.startswith(kernel) for n in ks.EDITS) == n_steps + 1
    assert {ks.EDITS[n][0] for n in ks.EDITS if n.startswith("K3")} == {"coherence_key"}
    assert {ks.EDITS[n][0] for n in ks.EDITS if n.startswith("K4")} == {"bvh_binary"}


def test_fetch_ahead_variant_reloads_the_node_on_every_path():
    src = ks.variant_source("K4_fetch_ahead")
    assert "const float4 a = __ldg" not in src  # the node is carried, not loaded at the loop's top
    assert src.count("a = __ldg(nd + NODE_F4 * node);") == 1 and src.count("a = na;") == 1
    assert src.count("float4 a = __ldg(nd), b = __ldg(nd + 1);") == 1


def test_nodes12_carries_the_first_ports_fields():
    """The ``K4_node12`` variant's tables: a leaf's skip link is the next
    node and its third float4 holds ``first``; an inner node keeps its link."""
    scene = load_scene(os.path.join(SCENES, "crewmate_phong.toml"), device="cpu")
    t8 = scene.bvh_octant_nodes
    t12 = ks.nodes12_from_nodes8(t8)
    n = t8.shape[1]
    assert t12.shape == (8, n, 12) and t12.is_contiguous()
    leaf = t8[..., 7] > 0
    assert torch.equal(t12[..., [0, 1, 2, 4, 5, 6, 7]], t8[..., [0, 1, 2, 4, 5, 6, 7]])
    assert torch.equal(t12[..., 3][leaf], torch.arange(1, n + 1.0).expand(8, n)[leaf])
    assert torch.equal(t12[..., 3][~leaf], t8[..., 3][~leaf])
    assert torch.equal(t12[..., 8][leaf], t8[..., 3][leaf]) and (t12[..., 8][~leaf] == 0).all()
    assert (t12[..., 9:] == 0).all()
    # In the tree's own order they are the first port's table (which holds
    # -1 as an inner node's ``first``; no walk reads it).
    own = ks.nodes12_from_nodes8(scene.bvh_binary_nodes8[None].expand(8, n, 8))[0]
    first_port = scene.bvh_binary_nodes
    assert torch.equal(own[:, :8], first_port[:, :8])
    assert torch.equal(own[first_port[:, 7] > 0], first_port[first_port[:, 7] > 0])


def test_variant_source_refuses_a_part_it_cannot_find(monkeypatch):
    monkeypatch.setitem(ks.EDITS, "K2_missing", ("bvh8", [("no such line\n", None, "x")]))
    with pytest.raises(ValueError, match="occurs 0 times"):
        ks.variant_source("K2_missing")


def test_net8_sorts_every_zero_one_input():
    # The 0-1 principle: a comparator network that sorts every 0-1 sequence
    # sorts every sequence.
    for bits in itertools.product((0, 1), repeat=8):
        v = list(bits)
        for i, j in ks.NET8:
            if v[j] > v[i]:
                v[i], v[j] = v[j], v[i]
        assert v == sorted(bits, reverse=True)


def _insertion(keys, hits):
    """The shipped kernel's order: each hit child inserted after the entries
    of a larger or equal key."""
    out = []
    for s in range(8):
        if not hits[s]:
            continue
        q = len(out)
        while q > 0 and out[q - 1][0] < keys[s]:
            q -= 1
        out.insert(q, (keys[s], s))
    return [s for _, s in out]


def _network(keys, hits):
    """The sort_network variant's order: (key descending, slot ascending),
    misses at -inf with slots 8 + s."""
    kk = [keys[s] if hits[s] else -np.inf for s in range(8)]
    sl = [s if hits[s] else 8 + s for s in range(8)]
    for i, j in ks.NET8:
        if kk[j] > kk[i] or (kk[j] == kk[i] and sl[j] < sl[i]):
            kk[i], kk[j] = kk[j], kk[i]
            sl[i], sl[j] = sl[j], sl[i]
    return sl[: sum(hits)]


def test_sort_network_orders_children_as_the_insertion_does():
    rng = np.random.default_rng(7)
    for _ in range(3000):
        keys = rng.choice([0.5, 1.0, 1.5, 2.0], size=8) if rng.random() < 0.5 else rng.random(8)
        hits = rng.random(8) < rng.random()
        assert _network(keys.tolist(), hits.tolist()) == _insertion(keys.tolist(), hits.tolist())


def test_ptxas_lines_reads_registers_frame_and_spills():
    log = (
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_Z11bvh8_kernel10TravParamsPKfS1_' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z11bvh8_kernel10TravParamsPKfS1_\n"
        "    320 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 44 registers, used 0 barriers, 3840 bytes smem, 416 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_Z11mega_kernelILi8EEvv' for 'sm_90a'\n"
        "    32 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 64 registers, used 1 barriers, 3840 bytes cmem[0]\n"
    )
    assert ks.ptxas_lines(log) == [
        "bvh8_kernel: 44 registers, stack frame 320 B, spill stores 8 B, spill loads 4 B, static smem 3840 B",
        "mega_kernel<8>: 64 registers, stack frame 32 B, spill stores 0 B, spill loads 0 B, static smem 0 B",
    ]


def test_main_exits_nonzero_without_cuda(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ks.main([]) == 1
    assert capsys.readouterr().out == ""


def test_scene_rays_draws_the_regen_classes_on_cpu():
    cfg = RenderConfig(width=8, height=6)
    scene = load_scene(os.path.join(SCENES, "crewmate_phong.toml"), device="cpu")
    n = cfg.width * cfg.height * 4
    cam, classes = ks.scene_rays(scene, scene_precompute(scene), cfg, 64)
    assert all(c.shape == (n,) for c in cam[0] + cam[1])
    assert sorted(classes) == ["bounce", "camera", "shadow", "shadow-any-hit"]
    for ro, rd, t_init, res0, any_hit in classes.values():
        assert all(c.shape == (64,) and torch.isfinite(c).all() for c in ro + rd)
        assert t_init.shape == res0.shape == (64,)
        norm = rd[0] ** 2 + rd[1] ** 2 + rd[2] ** 2
        assert torch.allclose(norm, torch.ones(64), atol=1e-5)
    assert classes["shadow-any-hit"][4] and not classes["bounce"][4]
