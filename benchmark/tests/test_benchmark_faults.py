"""A run whose timed path is broken underneath comes out ``correct:
false``: each fault the cells can have, planted in the program, through
the whole run at the rehearsal size (the chip check skipped), and on the
card at the cells' own size (``-m cuda``). A recurrent step that returns
its state unchanged; half of a lockstep group's lanes left out, their
frames taken from the rest; a frame or a score altered where it is
produced: on the eval path one whole frame a pass, eight grey levels
off."""

import pytest
import torch


def stale_state(monkeypatch, cls):
    orig = cls.forward

    def forward(self, voxel, state):
        out, _ = orig(self, voxel, state)
        return out, state

    monkeypatch.setattr(cls, "forward", forward)


def half_lanes(monkeypatch):
    from evreal_tpu_torch.harness.batched import BatchedRunner

    orig = BatchedRunner.run

    def run(self, state, bufs, valid_t):
        state, imgs, clipped = orig(self, state, bufs, valid_t)
        half = (clipped.shape[0] + 1) // 2
        clipped = clipped.clone()
        clipped[half:] = clipped[:clipped.shape[0] - half]
        return state, imgs, clipped

    monkeypatch.setattr(BatchedRunner, "run", run)


def altered_frame(monkeypatch, module):
    orig = module.quantize_u8

    def quantize(clipped):
        out = orig(clipped).clone()
        frames = out.view(-1, out.shape[-2] * out.shape[-1])
        # a quarter of a frame; not lane 0's first, an empty window's
        # flat frame, which the check holds only to being present
        frame = frames[min(1, len(frames) - 1)]
        frame[: frame.numel() // 4] ^= 0x10
        return out

    monkeypatch.setattr(module, "quantize_u8", quantize)


def one_frame(monkeypatch):
    """Every pixel of one frame a pass (lane 0's second window) off by
    eight grey levels."""
    from evreal_tpu_torch.harness import batched, runner

    calls = [0]
    orig_q, orig_eval = batched.quantize_u8, runner.evaluate

    def quantize(clipped):
        out = orig_q(clipped)
        calls[0] += 1
        if calls[0] == 1:
            out = out.clone()
            out.view(-1, out.shape[-2] * out.shape[-1])[1] ^= 0x08
        return out

    def evaluate(*a, **k):
        calls[0] = 0
        return orig_eval(*a, **k)

    monkeypatch.setattr(batched, "quantize_u8", quantize)
    monkeypatch.setattr(runner, "evaluate", evaluate)


def altered_score(monkeypatch):
    from evreal_tpu_torch.harness.runner import MethodRunner

    orig = MethodRunner.metric_scores

    def scores(self, *a, **k):
        out = orig(self, *a, **k)
        return {n: (v * 1.01 if n == "ssim" else v) for n, v in out.items()}

    monkeypatch.setattr(MethodRunner, "metric_scores", scores)


def plant(monkeypatch, fault, workload):
    from evreal_tpu_torch import serve
    from evreal_tpu_torch.harness import batched
    from evreal_tpu_torch.models.firenet import FireNet
    from evreal_tpu_torch.models.unet import E2VIDRecurrent

    if fault == "stale_state":
        stale_state(monkeypatch, FireNet if workload.startswith("firenet")
                    else E2VIDRecurrent)
    elif fault == "half_lanes":
        half_lanes(monkeypatch)
    elif fault == "altered_frame":
        altered_frame(monkeypatch, serve if "stream" in workload else batched)
    elif fault == "one_frame":
        one_frame(monkeypatch)
    elif fault == "altered_score":
        altered_score(monkeypatch)


FAULTS = [("e2vid.ecd_std", "stale_state"), ("e2vid.ecd_std", "half_lanes"),
          ("e2vid.ecd_std", "altered_frame"), ("e2vid.ecd_std", "one_frame"),
          ("firenet_plus.ecd_std", "stale_state"),
          ("firenet_plus.ecd_std", "half_lanes"),
          ("firenet_plus.ecd_std", "altered_frame"),
          ("e2vid.ecd_k15k", "stale_state"), ("e2vid.ecd_k15k", "half_lanes"),
          ("e2vid.ecd_k15k", "altered_score"),
          ("e2vid.stream4", "stale_state"), ("e2vid.stream4", "altered_frame")]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_fault_is_not_correct(rehearse, monkeypatch, workload, fault):
    plant(monkeypatch, fault, workload)
    # a stream's pushes follow the clock: a second holds ten of them
    out, rc = rehearse(workload, seed=5,
                       seconds=1.0 if "stream" in workload else 0.0)
    assert rc == 0
    assert out["correct"] is False, out["checks"]


# at the cells' own size: one timed pass each, compared whole
CARD_FAULTS = [("e2vid.ecd_std", "one_frame"), ("e2vid.ecd_std", "stale_state"),
               ("e2vid.ecd_std", "half_lanes"),
               ("e2vid.ecd_k15k", "altered_score")]


@pytest.mark.cuda
@pytest.mark.parametrize("workload,fault", CARD_FAULTS)
def test_fault_is_not_correct_on_the_card(card, rehearse, monkeypatch,
                                          workload, fault):
    plant(monkeypatch, fault, workload)
    out, rc = rehearse(workload, seed=7, seconds=0.0, on_card=True)
    assert rc == 0
    print(workload, fault, out["checks"])
    assert out["correct"] is False, out["checks"]


def test_sound_run_is_correct(rehearse):
    out, rc = rehearse("e2vid.ecd_std", seed=5, seconds=0.0)
    assert rc == 0 and out["correct"] is True, out["checks"]
    assert torch.get_default_dtype() == torch.float32
