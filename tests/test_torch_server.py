"""The port's WebSocket server end to end on localhost, rendering on the CPU
(the kernels' twins), held against the JAX server for the same requests;
a served flying_unicorn frame; plus the port's two command-line entry
points."""

import asyncio
import json
import os
import threading

import numpy as np
import pytest

from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu.models.loader import load_scene as jax_load_scene
from raytracer_tpu.server.app import Server as JaxServer
from raytracer_tpu.server.wire import parse_chunk
from raytracer_tpu_torch.models.loader import load_all_scenes
from raytracer_tpu_torch.server.app import Server
from tests.torch_cpu import jax_cfg, one_torch_thread  # noqa: F401  (autouse)

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")
NAMES = ("cornell_box", "cubes")
# 150 px rows split into 60+60+30-pixel chunks; the small lane budget cuts
# the frame into 9 bands of 5 rows, so cancellation has bands to skip.
W, H = 150, 45
CFG = RenderConfig(rays_per_pass=1 << 11)


def _serve(srv):
    """Run ``srv`` on an ephemeral localhost port in a thread; yields the port."""
    loop = asyncio.new_event_loop()
    holder, started = {}, threading.Event()

    async def boot():
        holder["stop"] = asyncio.Event()
        ws = await srv.serve(port=0, host="127.0.0.1")
        holder["port"] = ws.sockets[0].getsockname()[1]
        started.set()
        await holder["stop"].wait()
        ws.close()
        await ws.wait_closed()
        # Renders stopped by their closed connections end at their next band.
        rest = asyncio.all_tasks() - {asyncio.current_task()}
        await asyncio.gather(*rest, return_exceptions=True)

    t = threading.Thread(target=lambda: loop.run_until_complete(boot()), daemon=True)
    t.start()
    assert started.wait(60)
    yield holder["port"]
    loop.call_soon_threadsafe(holder["stop"].set)
    t.join(30)
    assert not t.is_alive()


@pytest.fixture(scope="module")
def port_server():
    srv = Server(load_all_scenes(SCENES, device="cpu"), cfg=CFG, width=W, height=H, device="cpu")
    yield from _serve(srv)


@pytest.fixture(scope="module")
def jax_server():
    scenes = {n: jax_load_scene(os.path.join(SCENES, f"{n}.toml")) for n in NAMES}
    yield from _serve(JaxServer(scenes, cfg=jax_cfg(CFG), width=W, height=H, sharded=False))


async def _frame(port, msg, w=W, h=H, frames=1, timeout=120):
    """Send one render request; collect ``frames`` frames' (x, y, n) chunk
    headers and the last pixels of every chunk."""
    import websockets

    got = np.full((h, w, 3), -1, np.int32)
    headers = []
    async with websockets.connect(f"ws://127.0.0.1:{port}") as ws:
        await ws.send(json.dumps(msg))
        while sum(c[2] for c in headers) < frames * w * h:
            raw = await asyncio.wait_for(ws.recv(), timeout)
            assert isinstance(raw, (bytes, bytearray))
            t, x, y, rgb = parse_chunk(raw)
            assert t == 0 and x + rgb.shape[0] <= w and 0 <= y < h
            headers.append((x, y, rgb.shape[0]))
            got[y, x : x + rgb.shape[0]] = rgb
    return headers, got


@pytest.mark.parametrize("name", NAMES)
def test_full_frame_in_the_jax_servers_order(port_server, jax_server, name):
    msg = {"type": "render", "scene": name, "spp": 8}
    headers, img = asyncio.run(_frame(port_server, msg))
    jax_headers, jax_img = asyncio.run(_frame(jax_server, msg))
    assert headers == jax_headers
    assert len(set(headers)) == len(headers) == H * 3  # every chunk exactly once
    assert (img >= 0).all()
    assert img[:10].mean() > img[-10:].mean()  # the ceiling light is at the top
    assert abs(img.mean() - jax_img.mean()) < 6.0


@pytest.mark.parametrize("name", NAMES)
def test_progressive_restreams(port_server, name):
    # spp 16 = 4 samples per subpixel = 4 one-sample sweeps of a 90x12
    # frame (the request's own size), 2 chunks per row.
    msg = {"type": "render", "scene": name, "spp": 16, "progressive": True,
           "width": 90, "height": 12}
    headers, img = asyncio.run(_frame(port_server, msg, w=90, h=12, frames=4))
    assert len(headers) == 4 * 12 * 2
    assert sorted(headers) == sorted(headers[: 12 * 2] * 4)
    assert (img >= 0).all()


def test_stop_cancels_and_second_render_works(port_server):
    import websockets

    async def go():
        async with websockets.connect(f"ws://127.0.0.1:{port_server}") as ws:
            await ws.send(json.dumps({"type": "render", "scene": "cornell_box", "spp": 64}))
            for _ in range(3):
                await asyncio.wait_for(ws.recv(), 120)
            await ws.send(json.dumps({"type": "stop_rendering"}))
            drained = 0
            try:
                while True:
                    await asyncio.wait_for(ws.recv(), 3)
                    drained += 1
            except asyncio.TimeoutError:
                pass
            assert drained < H * 3 // 2  # far fewer than a full frame
            await ws.send(json.dumps({"type": "render", "scene": "cubes", "spp": 4}))
            seen = 0
            while seen < W * H:
                seen += parse_chunk(await asyncio.wait_for(ws.recv(), 120))[3].shape[0]
            assert seen == W * H

    asyncio.run(go())


def test_unknown_scene_closes_connection(port_server):
    import websockets

    async def go():
        async with websockets.connect(f"ws://127.0.0.1:{port_server}") as ws:
            await ws.send(json.dumps({"type": "render", "scene": "no_such_scene", "spp": 4}))
            with pytest.raises(websockets.exceptions.ConnectionClosed):
                while True:
                    await asyncio.wait_for(ws.recv(), 10)

    asyncio.run(go())


def test_server_main_fails_on_a_bvh_scene(capsys, tmp_path):
    """A mesh scene whose OBJ is missing fails the start-up load (exit 1)."""
    from raytracer_tpu_torch.server.main import main

    doc = open(os.path.join(SCENES, "flying_unicorn.toml")).read()
    (tmp_path / "flying_unicorn.toml").write_text(doc)
    assert main([str(tmp_path), "--scenes", "flying_unicorn", "--device", "cpu"]) == 1
    assert "flying-unicorn.obj" in capsys.readouterr().err


def test_served_unicorn_covers_every_pixel_once(port_server):
    # A 60x12 frame: one 60-pixel chunk a row, delivered in 4 bands of 3
    # rows (plan_delivery), each pixel exactly once.
    msg = {"type": "render", "scene": "flying_unicorn", "spp": 4, "width": 60, "height": 12}
    headers, img = asyncio.run(_frame(port_server, msg, w=60, h=12))
    assert sorted(headers) == sorted((0, y, 60) for y in range(12))
    assert (img >= 0).all() and img.mean() > 20


def test_render_cli_writes_png(tmp_path):
    from raytracer_tpu_torch.tools.render import main
    from raytracer_tpu_torch.utils.png import read_png

    out = str(tmp_path / "cornell.png")
    assert main([os.path.join(SCENES, "cornell_box.toml"), "--spp", "8", "--width", "24",
                 "--height", "18", "--device", "cpu", "--out", out]) == 0
    img = read_png(out)
    assert img.shape == (18, 24, 3) and img.mean() > 20
    from PIL import Image

    np.testing.assert_array_equal(np.asarray(Image.open(out).convert("RGB")), img)
