"""A run with the timed path broken underneath comes out not correct, and a
sound one correct: each cell at a small size on the CPU (the harness's look
for a card skipped), once for each fault the cell can have:
- a step that returns its state unchanged;
- half of the batch left out, the mean taken over the rest;
- for the finetune cell, an answer (a prediction of an eval pass, or a host
  metric) altered where it is made.
One card holds each cell, so no exchange between cards can be left out."""

import importlib
import time

import pytest
import torch

from portbench import harness

CELLS = [w["name"] for w in harness.load_manifest()["workloads"]]


def run(cell, small_cell):
    cfg, traffic = small_cell(cell)
    torch.set_num_threads(2)
    return harness.run_cell(cell, 21, 0.3, False, torch.device("cpu"), time.perf_counter(),
                            cfg=cfg, traffic=traffic)


def train_step(cell, small_cell):
    """(module, name) of the program's function that one step of the cell's
    loop runs, as the loop's ``TRAIN_STEP`` names it."""
    module_name, fn_name = harness.loop_module(small_cell(cell)[1]["loop"]).TRAIN_STEP
    return importlib.import_module(module_name), fn_name


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell, small_cell):
    result = run(cell, small_cell)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_step_that_leaves_the_state_unchanged_is_caught(cell, small_cell, monkeypatch):
    module, fn_name = train_step(cell, small_cell)
    step = getattr(module, fn_name)

    def unchanged(state, *a, **kw):
        # forward and backward as ever, and no update
        state.optimizer.step = lambda *_, **__: None
        try:
            return step(state, *a, **kw)
        finally:
            del state.optimizer.step

    monkeypatch.setattr(module, fn_name, unchanged)
    result = run(cell, small_cell)
    assert not result["correct"]
    change = [c["value"] for name, c in result["checks"].items() if "change" in name]
    assert change and change == [pytest.approx(1.0, abs=1e-6)] * len(change)


@pytest.mark.parametrize("cell", CELLS)
def test_half_the_batch_left_out_is_caught(cell, small_cell, monkeypatch):
    module, _ = train_step(cell, small_cell)
    bce = module.bce_with_logits

    def half(logits, targets, row_mask=None, group=None):
        keep = torch.ones(logits.shape[0], dtype=torch.bool, device=logits.device)
        if row_mask is not None:
            keep &= row_mask.bool()
        rows = torch.nonzero(keep).flatten()
        keep[rows[len(rows) // 2:]] = False
        return bce(logits, targets, keep, group)

    monkeypatch.setattr(module, "bce_with_logits", half)
    result = run(cell, small_cell)
    assert not result["correct"]


def test_an_altered_metric_is_caught(small_cell, monkeypatch):
    from chromegcn_tpu_torch.train import runner

    compute = runner.compute_metrics

    def altered(*a, **kw):
        out = compute(*a, **kw)
        out["meanAUPR"] += 1e-6
        return out

    monkeypatch.setattr(runner, "compute_metrics", altered)
    result = run("gcn_finetune_rule_epoch", small_cell)
    assert not result["correct"]
    assert result["checks"]["metrics_gap"]["value"] == pytest.approx(1e-6, rel=1e-3)


def test_an_altered_prediction_is_caught(small_cell, monkeypatch):
    from chromegcn_tpu_torch.train import finetune

    evaluate = finetune.chrome_eval_step

    def altered(*a, **kw):
        loss, probs = evaluate(*a, **kw)
        probs = probs.clone()
        probs[0, 0] += 1e-3
        return loss, probs

    monkeypatch.setattr(finetune, "chrome_eval_step", altered)
    result = run("gcn_finetune_rule_epoch", small_cell)
    assert not result["correct"]
    assert result["checks"]["pred_gap"]["value"] == pytest.approx(1e-3, rel=1e-2)
