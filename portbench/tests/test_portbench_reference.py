"""The plain references against the port's CPU path at small sizes."""

import numpy as np
import pytest
import torch

from portbench import harness
from portbench import traffic as gen_traffic
from portbench.loops import common
from portbench.reference import expecto, train
from portbench.reference import metrics as ref_metrics

CPU = torch.device("cpu")


@pytest.mark.parametrize("rate", [0.05, 0.5])
def test_host_metrics_match_the_ports(rate):
    from chromegcn_tpu_torch.utils.evals import compute_metrics

    rng = np.random.default_rng(5)
    targets = (rng.random((700, 40)) < rate).astype(np.float32)
    targets[:, 3] = 0.0  # a label with no positive: the degenerate PR curve
    targets[:, 4] = 1.0  # and one with no negative: no AUROC
    # rounded scores, so that many tie
    preds = np.round(rng.random((700, 40)).astype(np.float32) * 50) / 50
    ours = compute_metrics(preds, targets, 0.3)
    ref = ref_metrics.metrics(preds, targets)
    for key in ref_metrics.COMPARED:
        assert ours[key] == pytest.approx(ref[key], abs=1e-12), key
    assert ref_metrics.gap(ours, preds, targets) < 1e-12
    assert ref_metrics.gap(ours, preds, targets, np.float32) > 1e-12


@pytest.mark.parametrize("cell", ["gcn_chr1_step", "expecto_step"])
def test_first_step_follows_the_reference(cell, small_cell):
    """The program's first steps in float32 against the float64 reference:
    the first step's loss and every leaf's first gradient agree to float32
    rounding."""
    cfg, traffic = small_cell(cell)
    session = harness.session_for(cfg, traffic, 12345, CPU)
    session.setup()
    session.free()
    ref = session.reference(torch.float64)
    assert session.program["losses"][0] == pytest.approx(ref["losses"][0], rel=1e-6)
    for name, value in ref["grad1"].items():
        assert session.program["grad1"][name] == pytest.approx(value, rel=1e-3, abs=1e-6), name


def test_gcn_three_steps_follow_the_reference(small_cell):
    cfg, traffic = small_cell("gcn_chr1_step")
    session = harness.session_for(cfg, traffic, 99, CPU)
    session.setup()
    session.free()
    gaps = train.gaps(session.program, session.reference(torch.float64))
    assert max(gaps.values()) < 1e-4, gaps


def test_expecto_logits_match_the_ports_model_in_float64(small_cell):
    """The same weights and dropout generator through the port's
    NonStrandSpecific(Expecto) and the reference, both in float64."""
    from chromegcn_tpu_torch.data.constants import SRC_VOCAB
    from chromegcn_tpu_torch.models.strand import NonStrandSpecific
    from chromegcn_tpu_torch.models.window import make_window_model
    from chromegcn_tpu_torch.ops.seq import complement_permutation

    cfg, _ = small_cell("expecto_step")
    model = NonStrandSpecific(make_window_model("expecto", cfg["n_targets"], cfg["seq_length"],
                                                cfg["d_model"]))
    draw = torch.Generator().manual_seed(4)
    weights = common.make_weights(expecto.param_specs(cfg), draw, CPU)
    common.load_weights(model, weights, "model.")
    model.double().train()
    tokens = torch.randint(0, 4, (3, cfg["seq_length"]), generator=draw, dtype=torch.int32)
    comp = torch.as_tensor(complement_permutation(SRC_VOCAB))
    _, _, ours = model(tokens, comp, generator=torch.Generator().manual_seed(8))
    w = {k: v.double() for k, v in weights.items()}
    ref = expecto.logits(cfg, w, tokens, torch.Generator().manual_seed(8))
    torch.testing.assert_close(ours, ref, rtol=1e-10, atol=1e-12)


def test_traffic_is_the_same_from_the_same_seed():
    a = gen_traffic.node_inputs(50, 64, 8, 5, 0.3, 2, torch.Generator().manual_seed(3), CPU)
    b = gen_traffic.node_inputs(50, 64, 8, 5, 0.3, 2, torch.Generator().manual_seed(3), CPU)
    for x, y in zip(a, b):
        for k in x:
            assert torch.equal(x[k], y[k])
    assert not torch.equal(a[0]["x_f"], a[1]["x_f"])
    assert not a[0]["x_f"][50:].any() and not a[0]["targets"][50:].any()


@pytest.mark.parametrize("scale", [1.0, 16.0])
def test_the_label_rule_gives_the_rate_and_follows_the_features(scale):
    """Every seed draws labels at the configuration's rate and of the same
    strength: only the rule's direction and the draws change."""
    b = gen_traffic.rule_offset(0.05, scale)
    z = torch.randn(400_000, generator=torch.Generator().manual_seed(1), dtype=torch.float64)
    assert float(torch.sigmoid(scale * z + b).mean()) == pytest.approx(0.05, abs=1e-3)
    rates, hits = [], []
    for seed in (7, 8):
        gen = torch.Generator().manual_seed(seed)
        rule = gen_traffic.LabelRule(32, 200, 0.05, scale, gen, CPU)
        x = torch.randn(2, 4000, 32, generator=gen)
        y = rule.targets(x[0], x[1], gen)
        assert set(y.unique().tolist()) <= {0.0, 1.0}
        z = (x[0] + x[1]) @ rule.u
        assert float(z.std()) == pytest.approx(1.0, abs=0.05)
        rates.append(float(y.mean()))
        # the positives lie where the projection is high
        hits.append(float(z[y == 1].mean() - z[y == 0].mean()))
    assert rates == pytest.approx([0.05, 0.05], abs=0.003)
    assert min(hits) > 0.5 and abs(hits[0] - hits[1]) < 0.1 * max(hits)
