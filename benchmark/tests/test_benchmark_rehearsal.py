"""The plain reference agrees with the program on the CPU at the mixes'
tiny rehearsal sizes, through the whole run: ``evaluate`` on both
configurations and ``ReconEngine.push``; the result line keeps to the
contract and holds no device metric."""

import pytest

CELLS = ["e2vid.ecd_std", "firenet_plus.ecd_std", "e2vid.stream4",
         "e2vid.ecd_k15k"]


@pytest.mark.parametrize("workload", CELLS)
def test_reference_agrees_with_the_program(rehearse, workload):
    out, rc = rehearse(workload, seed=2 ** 31 + 3, seconds=0.5)
    assert rc == 0
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    checks = {k: v["value"] for k, v in out["checks"].items()}
    assert checks["missing"] == 0 and out["failed"] == 0
    assert out["attempted"] > 0
    assert checks.get("px_share", 0) < 0.01
    for metric in ("mse", "ssim", "lpips"):
        assert checks.get(f"{metric}_gap", 0) < 1e-4
    assert "setup_s" in out["metrics"]
    assert out["device"]["platform"] == "cpu"


def test_traced_rehearsal_has_no_device_metric(rehearse):
    out, rc = rehearse("e2vid.ecd_std", seconds=0.0, trace=1)
    assert rc == 0
    assert set(out["metrics"]) == {"loop_ms_per_frame.eval"}
    assert "busy_s" not in out["device"] and "breakdown" not in out


def test_no_card_no_result(tmp_path, monkeypatch, capsys):
    import torch

    from benchmark import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    rc = run.main(["--workload", "e2vid.ecd_std", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""
