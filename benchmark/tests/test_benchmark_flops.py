"""The benchmark's FLOPs a window equal the program's count
(``utils/mfu.py:count_flops``)."""

import torch

from benchmark.lib.peaks import flops_per_window
from benchmark.lib.spec import ROOT, Spec, read_json


def test_e2vid_flops_match_the_program():
    from evreal_tpu_torch.models import build_model
    from evreal_tpu_torch.utils.mfu import count_flops

    cfg = Spec().cell("e2vid.ecd_std")[2]
    ours = flops_per_window(cfg, 180, 240)
    model = build_model("E2VIDRecurrent", dict(cfg["kwargs"],
                                               final_activation="sigmoid"))
    x = torch.zeros((1, 5, 184, 240))
    state = model.init_state(1, 184, 240)
    theirs = count_flops(lambda m, v, s: m(v, s), model, x, state)
    assert ours == theirs
    assert abs(ours / 1e9 - 40.10) < 0.01


def test_firenet_flops_match_the_program():
    from evreal_tpu_torch.models import build_model
    from evreal_tpu_torch.utils.mfu import count_flops

    cfg = read_json(ROOT / "benchmark/configs/firenet_plus.json")
    model = build_model("FireNet", cfg["kwargs"])
    x = torch.zeros((1, 5, 180, 240))
    theirs = count_flops(lambda m, v, s: m(v, s), model, x,
                         model.init_state(1, 180, 240))
    assert flops_per_window(cfg, 180, 240) == theirs
