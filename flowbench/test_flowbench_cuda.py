"""Card tests of the benchmark, at sizes a test run holds (they skip where
there is no CUDA card):

    python -m pytest --noconftest -q flowbench/test_flowbench_cuda.py

The program passes a cell's limits on every seed, and the control (the
reference put in the program's place, in CONTROL_DTYPE) does not, both by
the verdict that decides a run's `correct`; the TF32 control (the program
with TF32 on) runs through the same check; and a traced run through the
harness on the card reads its metrics.
"""
import math

import pytest
import torch

from flowbench import calibrate, harness
from flowbench.reference.check import CONTROL_DTYPE, Reference, verdict

SIZES = {"karman": {"n_refine": 3}, "cavity3d": {"n": 24}}


def small(name):
    cell, cfg = harness.load_cell(name)
    cfg.update(SIZES[cfg["problem"]])
    return cell, cfg


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["karman-10m-bench", "cavity3d-n96-bench"])
def test_program_passes_and_the_controls_fail(name, card):
    cell, cfg = small(name)
    sut = harness.build(cell, cfg, card)
    ref = Reference(cfg, card)
    assert ref.attach(sut["dof_points"])
    settings = calibrate.control_settings(cell)
    limits = cell["limits"]
    for seed in (2**31 + 5, 2**31 + 6, 2**31 + 7):
        U0, steps, _ = calibrate.run_seed(sut, cell, cfg, seed, 2.0, torch.cuda.synchronize)
        checks = ref.judge(U0, seed, *steps, settings)
        assert verdict(checks, limits), checks
        control = [ref.control_step(st["U0"], st["P0"], st["dt"], settings) for st in steps]
        checks = ref.judge(U0.to(CONTROL_DTYPE), seed, *control, settings)
        assert not verdict(checks, limits), checks
        # TF32, the program's own rung, moves what runs through its matmuls
        # (the Karman correction); the check holds it to the same limits
        with calibrate.tf32():
            U0, steps, _ = calibrate.run_seed(sut, cell, cfg, seed, 2.0, torch.cuda.synchronize)
        checks = ref.judge(U0, seed, *steps, settings)
        assert all(math.isfinite(v) for v in checks.values()), checks


@pytest.mark.cuda
def test_a_traced_run_reads_its_metrics(card):
    cell, cfg = small("cavity3d-n96-bench")
    result = harness.run_cell("cavity3d-n96-bench", cell, cfg, 11, 2.0, 1, card)
    assert result["correct"] is True
    assert result["device"]["busy_s"] > 0
    for name in ("launches_per_step", "k1_roofline", "device_idle_pct",
                 "pressure_ms_per_step"):
        assert name in result["metrics"], result["metrics"]
    assert 0 < result["metrics"]["k1_roofline"]["value"] <= 100
