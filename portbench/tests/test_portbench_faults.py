"""A whole run on the CPU (the program's plain kernels; the harness's look
for a card skipped) comes out correct, and with the timed path broken
underneath comes out not correct, once for each fault a mapping cell can
have: a step that hands back its old state, half of each batch left out,
an answer altered where it is produced.  (The exchange between chips does
not exist in a one-chip cell.)"""

import sys

import pytest

import control
from yardstick import cell


def run(tiny_ont, cache_root, seed):
    cfg, mix = tiny_ont
    result, checks = cell.run_cell(
        cfg, mix, seed=seed, seconds=0.5, trace=False, device="cpu",
        cache_root=cache_root, gen_workers=1)
    assert result["attempted"] >= 4
    return result, checks


def test_sound_run_is_correct(tiny_ont, cache_root):
    result, checks = run(tiny_ont, cache_root, 2**31 + 11)
    assert result["correct"], checks
    assert set(result["metrics"]) == {"map_mbps", "peak_rss_gb", "setup_s"}
    assert cell.forbidden_modules() == []


@pytest.mark.parametrize("fault", ["stale", "half", "altered"],
                         ids=["state_unchanged", "half_batch", "answer_altered"])
def test_fault_is_not_correct(tiny_ont, cache_root, fault):
    undo = control.plant_fault(fault)
    try:
        result, checks = run(tiny_ont, cache_root, 2**31 + 12)
    finally:
        undo()
    assert not result["correct"], checks


def test_forbidden_modules_compare_whole_names(monkeypatch):
    assert "vacmap_tpu_torch" in sys.modules
    assert cell.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "vacmap_tpu.ops", object())
    assert cell.forbidden_modules() == ["vacmap_tpu"]
