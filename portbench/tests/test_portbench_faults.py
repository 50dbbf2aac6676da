"""A run past the look for a chip, with the timed path broken underneath,
comes out not ``correct``: for each fault a cell can have (one card: no
exchange between chips to leave out)."""

import pytest
import torch

from portbench import harness
from portbench.tests import tiny
from portbench.tests.tiny import SERVING, TRAINING


def _line(name, seconds=1.0):
    cell = tiny.cell(name)
    run = tiny.run(cell, seconds=seconds)
    return harness.report(cell, run, False, {"platform": "cpu"}), run


def _swap_one_answer(lift):
    def broken(model, frames, kp2d, crop):
        out = lift(model, frames, kp2d, crop).clone()
        out[0] = out[1]
        return out
    return broken


def _half_the_batch(lift):
    def broken(model, frames, kp2d, crop):
        h = frames.shape[0] // 2
        out = lift(model, frames[:h], kp2d[:h], crop[:h])
        return torch.cat([out, out])
    return broken


@pytest.mark.parametrize("name", SERVING)
def test_sound_serving_run_is_correct(name):
    line, _ = _line(name)
    assert line["correct"] and line["failed"] == 0


@pytest.mark.parametrize("fault", [_swap_one_answer, _half_the_batch])
@pytest.mark.parametrize("name", SERVING)
def test_serving_fault_is_not_correct(name, fault, monkeypatch):
    from contextaware_poseformer_tpu_torch import serve

    monkeypatch.setattr(serve, "lift", fault(serve.lift))
    line, _ = _line(name)
    assert not line["correct"]
    c = line["compared"]["pose_gap_int8_units"]
    assert c["value"] > 2 * c["limit"]


@pytest.mark.parametrize("name", TRAINING)
def test_training_step_that_keeps_its_state_is_not_correct(name,
                                                          monkeypatch):
    from contextaware_poseformer_tpu_torch.train import steps

    monkeypatch.setattr(steps.Optimizer, "step",
                        lambda self, step, finite=None: None)
    line, _ = _line(name, seconds=0.0)
    assert not line["correct"]
    assert line["compared"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", TRAINING)
def test_training_loss_over_half_the_batch_is_not_correct(name,
                                                          monkeypatch):
    from contextaware_poseformer_tpu_torch.train import losses

    full = losses.LOSSES["MPJPE"]
    monkeypatch.setitem(losses.LOSSES, "MPJPE", lambda p, g: full(
        p[:p.shape[0] // 2], g[:g.shape[0] // 2]))
    line, _ = _line(name, seconds=0.0)
    assert not line["correct"]
    c = line["compared"]["loss_gap"]
    assert c["value"] > 100 * c["limit"]
