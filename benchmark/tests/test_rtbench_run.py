"""Whole runs on the CPU at a tiny size (``--device cpu``): the result
line's shape, and ``correct`` coming out false when the timed path is
broken underneath: half the samples left out (the mean taken over the
rest), an answer altered where it is produced, half of the bands left out,
one card's part left out, the exchange between cards left out, and the
wire's row labels broken (the faults of ``rtbench/faults.py``)."""

import json

import pytest
import torch

import run as runmod
from rtbench import faults

TINY = ["--device", "cpu", "--width", "24", "--height", "18"]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    yield
    torch.set_num_threads(n)


def result(capsys, workload, seconds="0.5", trace="0", extra=()):
    rc = runmod.main(["--workload", workload, "--seed", str(2**31 + 99), "--seconds", seconds,
                      "--trace", trace, *TINY, *extra])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


def test_result_line_shape(capsys):
    r = result(capsys, "cornell256.offline")
    assert list(r)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(r)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == {"setup_s", "frame_s"}
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert r["checks"]["pixels_off_pct"]["value"] == 0.0
    assert r["checks"]["frames_unequal"] == {"value": 0, "limit": 0}
    assert r["device"]["platform"] == "cpu"


def test_half_the_samples_left_out(capsys):
    with faults.planted("half_the_samples"):
        assert result(capsys, "cornell256.offline")["correct"] is False


def test_an_answer_altered_where_produced(capsys):
    with faults.planted("answer_altered"):
        assert result(capsys, "cornell256.offline")["correct"] is False


def four_devices(monkeypatch):
    from raytracer_tpu_torch.render import renderer

    monkeypatch.setattr(renderer, "shard_devices", lambda device="cpu": [torch.device("cpu")] * 4)


def test_four_devices_correct_and_the_exchange_left_out(capsys, monkeypatch):
    four_devices(monkeypatch)
    assert result(capsys, "cornell256.offline.x4")["correct"] is True
    with faults.planted("exchange_left_out"):
        assert result(capsys, "cornell256.offline.x4")["correct"] is False


@pytest.mark.parametrize("workload", ["cornell256.offline", "cornell256.offline.x4"])
def test_half_the_bands_left_out(capsys, monkeypatch, workload):
    if workload.endswith(".x4"):
        four_devices(monkeypatch)
    with faults.planted("half_the_bands"):
        r = result(capsys, workload)
    assert r["correct"] is False
    assert r["checks"]["pixels_off_pct"]["value"] > r["checks"]["pixels_off_pct"]["limit"]


def test_one_card_left_out(capsys, monkeypatch):
    four_devices(monkeypatch)
    with faults.planted("one_card_left_out"):
        r = result(capsys, "cornell256.offline.x4")
    assert r["correct"] is False
    assert r["checks"]["pixels_off_pct"]["value"] > r["checks"]["pixels_off_pct"]["limit"]


def test_traced_run_needs_a_card(capsys):
    """Without a card there is no device slice to read: the traced run
    refuses before it profiles, rather than report a device metric from the
    CPU."""
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        result(capsys, "cornell256.offline", trace="1")


def served_cell(monkeypatch):
    """A served cell added by data alone: an entry and its two tails (the
    benchmark holds none yet: PERF.md), at a rate the CPU keeps up with."""
    from rtbench import spec

    sp = spec.load()
    sp["workloads"].append({"name": "cornell.served", "config": "cornell_600x450",
                            "traffic": "stock_clients_r1.2", "chips": 1, "why": "served"})
    for name in ("first_chunk_p95_s", "image_p95_s"):
        sp["end_to_end"].append({"name": name, "unit": "s", "better": "lower", "bound": 0.25,
                                 "source": "host_clock", "workloads": ["cornell.served"]})
    monkeypatch.setattr(spec, "load", lambda root=spec.ROOT: sp)
    slow = dict(spec.traffic("stock_clients_r1.2"), rate=1.0, connections=2, generators=2)
    monkeypatch.setattr(spec, "traffic", lambda name, bench_dir=spec.BENCH_DIR: slow)


def test_served_wire_labels_broken(capsys, monkeypatch):
    served_cell(monkeypatch)
    good = result(capsys, "cornell.served", seconds="2")
    assert good["correct"] is True and good["attempted"] == 2
    assert set(good["metrics"]) == {"setup_s", "first_chunk_p95_s", "image_p95_s"}
    from raytracer_tpu_torch.server import wire

    orig_row, orig_batch = wire.pack_row, wire.pack_rows_batched
    monkeypatch.setattr(wire, "pack_row", lambda y, rgb, ppm=60: orig_row(min(y + 1, 17), rgb, ppm))
    monkeypatch.setattr(wire, "pack_rows_batched", lambda y, rgb, ppm=60: orig_batch(min(y + 1, 17), rgb, ppm))
    bad = result(capsys, "cornell.served", seconds="2")
    assert bad["correct"] is False
