"""On the card: a tiny cell through the CUDA kernels, and the trace's
readers.  Skips without a card (decided inside the test)."""

import pytest
import torch

from conftest import BENCH, DATA

import harness

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's CUDA kernels have no CPU mode")


@pytest.mark.parametrize("cell,metrics", [
    ("tiny-dense.cold", ["patch_roofline_pct", "idle_pct", "cold_pct"]),
    ("tiny-ssm.warm", ["ssd_scan_roofline_pct", "idle_pct", "exec_ms.p50"]),
    ("tiny-hybrid.warm", ["flash_roofline_pct", "ssd_scan_roofline_pct", "fwd_mfu_pct"]),
])
def test_a_tiny_cell_on_the_card_is_correct_and_traced(card, cell, metrics):
    out = harness.run_cell(cell, 31, 1.0, True, device="cuda", base=DATA,
                           metrics_base=BENCH, per_layer=metrics)
    assert out["correct"], out["checks"]
    assert out["busy_s"] > 0 and out["window_s"] > 0
    assert set(out["per_layer"]) == set(metrics), out["per_layer"]
