"""The served cells' load generator: a child process of the run, so that its
decoding does not share the server's interpreter.

    python3 loadgen.py PORT  (a JSON job on standard input)

The job gives the scene, the request kinds (each a render request of a
stock client), the due times and kinds of this generator's share of the
open loop, its number of connections and the rows to report. The
generator opens the connections, renders one request of each kind if it
is the first generator (the warm-up), writes ``ready`` and waits for
``go`` on standard input. Then each request, when it is due, takes an
idle connection (or waits for one: its time still counts from when it was
due), sends its render request, and assembles the image from the binary
pixel chunks (batched messages hold several chunks). A connection is idle
again once the request's ``render_stats`` message has come, which the
server sends after the last pixel when the request asks for it.

It writes one JSON line: per request its kind, due time, the times of its
first pixel message and of the message that completed its last pixel (or
null), an image digest, its pixels on the reported rows, and how late it
was sent (seconds after due: the wait for a free connection and the
generator's own delay); and the generator's CPU seconds in the window.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import json
import struct
import sys
import time

import numpy as np

HEADER = struct.Struct("<BBHH")


def decode_into(buf: bytes, img: np.ndarray) -> int:
    """Write every RenderedPixels chunk of ``buf`` into ``img`` (row 0 at the
    top) -> pixels written."""
    off, end, n_px = 0, len(buf), 0
    while off + HEADER.size <= end:
        kind, n, x, y = HEADER.unpack_from(buf, off)
        off += HEADER.size
        if kind != 0:
            raise ValueError(f"unexpected message type {kind}")
        img[y, x:x + n] = np.frombuffer(buf, np.uint8, 3 * n, off).reshape(n, 3)
        off += 3 * n
        n_px += n
    return n_px


async def one_request(ws, req: dict, width: int, height: int, rows: list[int], rec: dict) -> None:
    img = np.zeros((height, width, 3), np.uint8)
    need, got, stats = width * height, 0, False
    await ws.send(json.dumps(req))
    while got < need or not stats:
        msg = await ws.recv()
        if isinstance(msg, str):
            stats = stats or json.loads(msg).get("type") == "render_stats"
            continue
        if rec["first"] is None:
            rec["first"] = time.perf_counter()
        got += decode_into(msg, img)
        if got >= need and rec["done"] is None:
            rec["done"] = time.perf_counter()
    rec["digest"] = hashlib.blake2b(img.tobytes(), digest_size=16).hexdigest()
    rec["rows"] = base64.b64encode(np.ascontiguousarray(img[[height - 1 - r for r in rows]]).tobytes()).decode()


async def main(port: int, job: dict) -> dict:
    import websockets

    url = f"ws://127.0.0.1:{port}"
    w, h, rows = job["width"], job["height"], job["rows"]
    conns = [await websockets.connect(url, max_size=None, ping_interval=None) for _ in range(job["connections"])]
    idle: asyncio.Queue = asyncio.Queue()
    for c in conns:
        idle.put_nowait(c)
    kinds = job["kinds"]
    for name in sorted(kinds) if job["warmup"] else ():  # warm-up: one request of each kind
        rec = {"first": None, "done": None}
        await asyncio.wait_for(one_request(conns[0], {**kinds[name], "scene": job["scene"]}, w, h, rows, rec),
                               job["wait_after_s"])
    sys.stdout.write("ready\n")
    sys.stdout.flush()
    line = await asyncio.get_running_loop().run_in_executor(None, sys.stdin.readline)
    if line.strip() != "go":
        raise RuntimeError(f"expected go, got {line!r}")
    t_go = time.perf_counter()
    cpu0 = time.process_time()
    recs = [{"kind": k, "due": d, "first": None, "done": None, "late": None} for d, k in zip(job["due"], job["order"])]

    async def fire(rec):
        await asyncio.sleep(max(0.0, t_go + rec["due"] - time.perf_counter()))
        ws = await idle.get()
        rec["late"] = time.perf_counter() - t_go - rec["due"]
        try:
            await one_request(ws, {**kinds[rec["kind"]], "scene": job["scene"]}, w, h, rows, rec)
        finally:
            idle.put_nowait(ws)

    tasks = [asyncio.ensure_future(fire(r)) for r in recs]
    deadline = t_go + job["seconds"] + job["wait_after_s"]
    done, pending = await asyncio.wait(tasks, timeout=max(0.0, deadline - time.perf_counter()))
    for t in pending:
        t.cancel()
    await asyncio.gather(*pending, return_exceptions=True)
    errors = [str(t.exception()) for t in done if t.exception() is not None]
    for c in conns:
        await c.close()
    for r in recs:
        for k in ("first", "done"):
            if r[k] is not None:
                r[k] -= t_go
    return {"requests": recs, "errors": errors[:5], "cpu_s": time.process_time() - cpu0}


if __name__ == "__main__":
    job = json.loads(sys.stdin.readline())
    out = asyncio.run(main(int(sys.argv[1]), job))
    sys.stdout.write(json.dumps(out) + "\n")
    sys.stdout.flush()
