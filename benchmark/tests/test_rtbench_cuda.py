"""On the card, at the cells' own sizes: the control and every fault the
cell can have (``rtbench/faults.py``) fail the limit on three seeds, and
the program passes it. ``python -m pytest benchmark/tests -m cuda -q``;
each test skips without a card."""

import pytest

from rtbench import calibrate, spec


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["cornell256.offline", "unicorn16.offline", "cornell256.offline.x4"])
def test_control_and_faults_fail_program_passes(workload):
    import torch

    sp = spec.load()
    cards = spec.cell(sp, workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < cards:
        pytest.skip(f"needs {cards} CUDA card(s)")
    config = spec.config(sp, spec.cell(sp, workload)["config"])
    limit = config["check"]["pixels_off_pct"]
    r = calibrate.readings(workload, [7001, 7002], [7101, 7102, 7103], with_faults=True)
    assert all(v <= limit for _s, v, _t in r["program"])
    assert all(v > limit for _s, v in r["control"])
    assert set(r["faults"]) == set(calibrate.cell_faults(config))
    assert all(v > limit for readings in r["faults"].values() for _s, v in readings)
