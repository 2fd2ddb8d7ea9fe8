"""``bench_torch.py`` and ``__graft_entry_torch__.py`` at a small size on the
CPU: the run functions return ``bench.py``'s keys, the JSON line has
``bench.py``'s key set (read from its source, not by running it) plus
``card``, ``transport``, ``cpu_host`` and ``cpu_native``, the native CPU
baselines are measured in the run (the XLA CPU ones stay null), and without a card and without ``--device cpu`` the script exits 1 and
prints nothing. Also the server's refusal of an engine name that neither
package defines, and its start with ``engine = "fused"``.
"""

import ast
import asyncio
import json
import os
import subprocess
import sys

import pytest
import torch

import bench_torch
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.models.loader import load_scene
from tests.torch_cpu import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = os.path.join(ROOT, "scenes")
W, H = 24, 18


def _bench_py():
    with open(os.path.join(ROOT, "bench.py")) as fh:
        return ast.parse(fh.read())


def _dict_keys(node: ast.Dict) -> list[str]:
    return [k.value for k in node.keys if isinstance(k, ast.Constant)]


def _function(tree, name):
    return next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == name)


def _returned_keys(tree, name) -> set[str]:
    """Keys of the dict literals a function of bench.py returns."""
    keys = set()
    for node in ast.walk(_function(tree, name)):
        if isinstance(node, ast.Return) and isinstance(node.value, ast.Dict):
            keys |= set(_dict_keys(node.value))
    return keys


def test_configs_equal_bench_py():
    tree = _bench_py()
    assign = next(n for n in tree.body if isinstance(n, ast.Assign) and n.targets[0].id == "CONFIGS")
    assert bench_torch.CONFIGS == ast.literal_eval(assign.value)


@pytest.mark.parametrize("key,scene,spp,mis", bench_torch.CONFIGS, ids=[c[0] for c in bench_torch.CONFIGS])
def test_run_config_returns_bench_py_keys(key, scene, spp, mis):
    out = bench_torch.run_config(scene, 8, mis, device="cpu", width=W, height=H, repeats=3)
    assert set(out) == _returned_keys(_bench_py(), "run_config") | {"min", "max", "n"}
    assert out["n"] == 3 and out["min"] <= out["wall_s"] <= out["max"]
    assert out["rays"] > W * H * 8 and out["mrays_per_s"] > 0
    assert round(out["wall_s"], 4) == out["wall_s"]


def test_slow_warmup_is_timed_once(monkeypatch):
    monkeypatch.setattr(bench_torch, "SLOW_WARMUP_S", 0.0)
    out = bench_torch.run_config("cornell_box", 4, False, device="cpu", width=W, height=H, repeats=5)
    assert out["n"] == 1 and out["min"] == out["max"] == out["wall_s"]


def test_served_runs_return_bench_py_keys():
    tree = _bench_py()
    prog = bench_torch.run_progressive(device="cpu", width=W, height=H, spp=64)
    assert set(prog) == _returned_keys(tree, "run_progressive_ws")
    assert prog["passes_measured"] == 3 and prog["spp_per_pass"] == 16 and prog["target_spp"] == 64
    assert 0 < prog["first_chunk_s"] <= prog["first_image_s"] and prog["s_per_refinement_pass"] > 0
    mesh = bench_torch.run_mesh_serving(device="cpu", width=60, height=12, spp=4)
    assert set(mesh) == _returned_keys(tree, "run_mesh_serving_ws")
    # The frame streams in bands: the first chunk well before the last.
    assert 0 < mesh["first_chunk_s"] < mesh["total_s"]


def test_a_failed_run_raises(monkeypatch):
    """No run function turns a failure into null."""
    from raytracer_tpu_torch.server.app import RenderJob

    async def boom(self, *a, **kw):
        raise RuntimeError("render failed")

    monkeypatch.setattr(RenderJob, "run", boom)
    with pytest.raises(RuntimeError, match="render failed"):
        bench_torch.run_mesh_serving(device="cpu", width=60, height=12, spp=4)
    with pytest.raises(RuntimeError, match="render failed"):
        bench_torch.run_progressive(device="cpu", width=W, height=H, spp=16)


def test_json_line_has_bench_py_keys(capsys):
    assert bench_torch.main(["--device", "cpu", "--width", str(W), "--height", str(H),
                             "--spp-scale", "0.03125", "--repeats", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    doc = json.loads(lines[0])
    printed = next(n for n in ast.walk(_function(_bench_py(), "main")) if isinstance(n, ast.Dict)
                   and "metric" in _dict_keys(n))
    assert set(doc) == set(_dict_keys(printed)) | {"card", "transport", "cpu_host", "cpu_native"}
    assert doc["transport"] == "in_process" and doc["card"] == "cpu" and doc["unit"] == "Mrays/s"
    assert doc["metric"] == f"Mrays/s/chip, cornell_box {W}x{H}@8spp (NEE path)"
    # The native baselines are measured in the run, on this host; the XLA
    # CPU ones have no counterpart in the port.
    assert doc["vs_xla_cpu_same_software"] is None and doc["cpu_xla_mrays_per_s"] is None
    assert doc["baseline_impl"] == "native-cpp reference-style tracer"
    assert str(os.cpu_count()) in doc["cpu_host"]
    cpu = doc["cpu_native"]
    assert cpu["cornell_box"]["rows"] == [0, 450] and cpu["flying_unicorn"]["rows"] == [200, 230]
    assert doc["cpu_native_mrays_per_s"] == round(cpu["cornell_box"]["mrays_per_s"], 3) > 0
    assert doc["cpu_native_mesh_mrays_per_s"] == round(cpu["flying_unicorn"]["mrays_per_s"], 4) > 0
    configs = doc["configs"]
    assert doc["vs_baseline"] == round(configs["cornell_256_nee"]["mrays_per_s"] / cpu["cornell_box"]["mrays_per_s"], 1)
    assert list(configs) == [c[0] for c in bench_torch.CONFIGS] + ["progressive_1080p", "unicorn_16_serving"]
    for key, scene in (("flying_unicorn_16", "flying_unicorn"), ("crewmate_phong_16", "crewmate_phong")):
        assert configs[key]["vs_native_cpu"] == round(configs[key]["mrays_per_s"] / cpu[scene]["mrays_per_s"], 1)
    head = configs["cornell_256_nee"]
    assert (doc["value"], doc["wall_clock_to_256spp_s"], doc["rays_traced"]) == (
        head["mrays_per_s"], head["wall_s"], head["rays"])
    for key, *_ in bench_torch.CONFIGS:
        assert {"min", "max", "n", "wall_s", "rays", "mrays_per_s"} <= set(configs[key])


def test_sharding_line_times_three_forms_of_a_frame(capsys):
    """``--sharding``: the plain frame, the sharded one and the one with a
    host thread a device; both regen frames equal the plain one, and the
    megakernel's (other band seeds) agree in the mean."""
    assert bench_torch.main(["--device", "cpu", "--width", str(W), "--height", str(H),
                             "--spp-scale", "0.25", "--repeats", "1", "--sharding"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    doc = json.loads(lines[0])
    assert doc["card"] == "cpu" and doc["sharding"]["devices"] == ["cpu", "cpu"]
    for key, engine in (("cornell_256_nee", "mega"), ("flying_unicorn_16", "regen")):
        row = doc["sharding"][key]
        assert row["engine"] == engine and row["plain"]["n"] == 1 and row["plain"]["wall_s"] > 0
        for form in ("one_host_thread", "thread_per_device"):
            assert row[form]["wall_s"] > 0
            assert row[form]["equal"] == (engine == "regen") and abs(row[form]["mean_diff"]) < 3.0


def test_without_cuda_the_script_exits_1_and_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "bench_torch.py")], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 1 and out.stdout == "" and "cuda" in out.stderr.lower()


def test_entry_runs_on_the_cpu():
    import __graft_entry_torch__ as entry

    fn, args = entry.entry(device="cpu")
    sums, rays = fn(*args)
    assert sums.shape == (8, 64, 4, 3) and torch.isfinite(sums).all() and sums.mean() > 0.05
    assert int(rays) >= 8 * 64 * 4 * 2
    again, _ = fn(*args)
    assert torch.equal(sums, again)


# --- engine names -------------------------------------------------------------------


def test_server_main_refuses_an_engine_the_port_lacks(tmp_path, capsys, monkeypatch):
    """A config engine that neither package defines is refused at start-up;
    ``engine = "fused"`` gets as far as serving."""
    from raytracer_tpu_torch.server import main as server_main

    (tmp_path / "warp.toml").write_text('engine = "warp"\n')
    args = [SCENES, "--config", str(tmp_path / "warp.toml"), "--device", "cpu", "--no-warmup"]
    assert server_main.main(args) == 1
    err = capsys.readouterr().err
    assert "'warp'" in err and all(e in err for e in ("mega", "regen", "fused", "simple"))

    served = []

    async def serve_forever(self, port):
        served.append((self.base_cfg.engine, sorted(self.scenes)))

    monkeypatch.setattr(server_main.Server, "serve_forever", serve_forever)
    (tmp_path / "fused.toml").write_text('engine = "fused"\n')
    args = [SCENES, "--config", str(tmp_path / "fused.toml"), "--device", "cpu", "--no-warmup",
            "--scenes", "cornell_box"]
    assert server_main.main(args) == 0
    assert served == [("fused", ["cornell_box"])]


def test_server_renders_the_simple_engine():
    """``engine = "simple"`` serves: a frame through ``RenderJob.run``."""
    from raytracer_tpu_torch.server import wire
    from raytracer_tpu_torch.server.app import RenderJob, Server

    scene = load_scene(os.path.join(SCENES, "cornell_box.toml"), device="cpu")
    srv = Server({"cornell_box": scene}, cfg=RenderConfig(engine="simple"), width=60, height=12, device="cpu")
    srv.warmup(block=True)
    renderer = srv.renderer_for("cornell_box", 60, 12)
    assert renderer.engine == "simple"
    px = []

    async def send(raw):
        px.extend(rgb.shape[0] for *_, rgb in wire.parse_chunks(raw))

    job = RenderJob(send=send)
    job.mark_running()
    assert asyncio.run(job.run(renderer, 8)) is False
    assert sum(px) == 60 * 12 and job.stats.rays > 60 * 12 * 8


def test_a_renderer_that_cannot_be_built_closes_the_connection(caplog):
    """A request whose renderer cannot be built is logged and the connection
    closed; nothing escapes the handler."""
    from raytracer_tpu_torch.server.app import Server

    scene = load_scene(os.path.join(SCENES, "cornell_box.toml"), device="cpu")
    srv = Server({"cornell_box": scene}, cfg=RenderConfig(engine="warp"), device="cpu")

    class Socket:
        sent: list = []

        def __aiter__(self):
            async def messages():
                yield json.dumps({"type": "render", "scene": "cornell_box", "spp": 4})
                yield json.dumps({"type": "render", "scene": "cornell_box", "spp": 4})

            return messages()

        async def send(self, msg):
            self.sent.append(msg)

    sock = Socket()
    with caplog.at_level("ERROR", logger="raytracer_tpu_torch.server"):
        asyncio.run(srv.handle_connection(sock))  # returns; does not raise
    assert not sock.sent and not srv.connections
    errors = [r.getMessage() for r in caplog.records if "no renderer" in r.getMessage()]
    assert len(errors) == 1 and "not one of" in errors[0]  # the loop ended at the first request
