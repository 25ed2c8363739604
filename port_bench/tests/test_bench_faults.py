"""A run with the timed path broken underneath comes out not correct.

Each case drives the whole of a run (set-up, window, release, check, result
line) on the CPU at a tiny size, past the harness's look for a card, with
the program in float32 so that only the planted fault can fail the check,
and the cell's own limits.  The sound run comes out correct."""

import io
import json

import numpy as np
import pytest
import torch

from port_bench.core import runner
from port_bench.tests.conftest import tiny_serve, tiny_train

SEED = 2 ** 31 + 77


def _run(cell: str, tiny: dict, trace: bool = False) -> dict:
    out = io.StringIO()
    rc = runner.run(cell, SEED, 0.5, trace, device=torch.device("cpu"), overrides=tiny,
                    out=out)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _f32(tiny: dict, key: str) -> dict:
    from port_bench.core import spec

    dtypes = dict(spec.cell(spec.benchmark(), "res10-serve-b8")["config"]["dtypes"])
    dtypes[key] = "float32"
    return {**tiny, "config": {**tiny["config"], "dtypes": dtypes}}


SERVE = _f32(tiny_serve(), "serve_params")
TRAIN = _f32(tiny_train(), "train_compute")


def test_sound_serving_run_is_correct():
    line = _run("res10-serve-b8", SERVE)
    assert line["correct"] is True
    assert list(line)[-1] == "check"
    assert set(line["metrics"]) == {"serve_img_s", "serve_p95_ms", "setup_s"}


def test_sound_training_run_is_correct():
    line = _run("res10-train-b32", TRAIN)
    assert line["correct"] is True
    assert set(line["metrics"]) == {"train_img_s", "setup_s"}


def test_traced_run_reports_per_layer_metrics_and_the_window():
    line = _run("res10-serve-b8", SERVE, trace=True)
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "serve_img_s" not in line["metrics"]


def _altered(real):
    def frame_detections(*args, **kw):
        dets = real(*args, **kw)
        bad = dets[0].copy()
        bad[:, :4] += 50.0
        bad[:, 5] = (bad[:, 5] + 1) % 13
        return [bad] + dets[1:]
    return frame_detections


def _half_batch_served(real):
    def predictor(model):
        dev, head, predict = real(model)

        def half(x):
            p = predict(x[: x.shape[0] // 2])
            return torch.cat([p, p])
        return dev, head, half
    return predictor


@pytest.mark.parametrize("fault", ["altered_answer", "half_batch"])
def test_serving_fault_is_not_correct(monkeypatch, fault):
    import ecs_yolo_tpu_torch.detect as D

    if fault == "altered_answer":
        monkeypatch.setattr(D, "frame_detections", _altered(D.frame_detections))
    else:
        monkeypatch.setattr(D, "predictor", _half_batch_served(D.predictor))
    assert _run("res10-serve-b8", SERVE)["correct"] is False


def _unchanged(real):
    def make_train_step(*args, **kw):
        def step(state, *batch):
            return state, {"loss": torch.zeros(()), "items": torch.zeros(3),
                           "applied": None, "boundary": False}
        return step
    return make_train_step


def _half_batch_trained(real):
    def make_train_step(*args, **kw):
        step = real(*args, **kw)
        return lambda state, *batch: step(state, *(b[: b.shape[0] // 2] for b in batch))
    return make_train_step


def _momentum_dropped(real):
    def build_optimizer(*args, **kw):
        tx = real(*args, **kw)
        tx.mom_fn = lambda count: torch.zeros((), device=count.device)
        return tx
    return build_optimizer


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "momentum_dropped"])
def test_training_fault_is_not_correct(monkeypatch, fault):
    import ecs_yolo_tpu_torch.train.optim as OP
    import ecs_yolo_tpu_torch.train.trainer as TR

    if fault == "momentum_dropped":     # the second apply's buffer matters
        monkeypatch.setattr(OP, "build_optimizer", _momentum_dropped(OP.build_optimizer))
    else:
        plant = _unchanged if fault == "state_unchanged" else _half_batch_trained
        monkeypatch.setattr(TR, "make_train_step", plant(TR.make_train_step))
    assert _run("res10-train-b32", TRAIN)["correct"] is False


def test_detections_gap_reads_a_moved_box():
    from port_bench.core import compare

    want = np.array([[10, 10, 50, 50, 0.9, 3], [100, 100, 150, 140, 0.8, 1]], float)
    assert compare.det_gap([want.copy()], [want]) == 0.0
    moved = want.copy()
    moved[1, :4] += 60
    assert compare.det_gap([moved], [want]) == 0.5
    assert compare.det_gap([None], [want]) == float("inf")
