"""The control comes out not correct: the plain reference put in the
program's place and computed in TF32, the precision just below the
configurations' float32 with TF32 off, fails at least one of the cell's
limits on every seed. On the CPU at the rehearsal size (TF32 emulated by
rounding); on the card at the cell's own size."""

import pytest

from benchmark.control import readings
from benchmark.lib.check import judge, limits
from benchmark.lib.spec import ROOT


@pytest.mark.parametrize("workload", ["e2vid.ecd_std", "e2vid.stream4"])
def test_control_fails_at_the_rehearsal_size(tmp_path, monkeypatch,
                                             spec_for, workload):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    values = readings(workload, 3, rehearse=True, spec=spec_for(workload))
    correct, _ = judge(values, limits(ROOT, workload))
    assert not correct, values


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["e2vid.ecd_std", "firenet_plus.ecd_std",
                                      "e2vid.ecd_k15k", "e2vid.stream4"])
def test_control_fails_on_the_card(card, tmp_path, monkeypatch, spec_for,
                                   workload):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    for seed in (1, 2, 3):
        values = readings(workload, seed, rehearse=False,
                          spec=spec_for(workload))
        correct, _ = judge(values, limits(ROOT, workload))
        assert not correct, (seed, values)
