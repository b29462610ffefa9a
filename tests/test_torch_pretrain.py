"""The port's pretrain stage (train/pretrain, the warm start in
train/finetune) against the JAX package's, on the CPU: three optimizer
steps with a padded tail batch, an eval epoch's predictions and grouped
features, and the GCN head's warm start; and B1's wrapper at any width."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chromegcn_tpu.data import loader as jloader
from chromegcn_tpu.models.chrome import make_chrome_model as jax_make_chrome_model
from chromegcn_tpu.train import finetune as jft
from chromegcn_tpu.train import pretrain as jpt
from chromegcn_tpu.train.optim import make_optimizer as jax_make_optimizer
from chromegcn_tpu_torch.data import constants as tconstants
from chromegcn_tpu_torch.data import loader as tloader
from chromegcn_tpu_torch.data.synthetic import make_hic_edges, make_window_dataset
from chromegcn_tpu_torch.models.chrome import make_chrome_model
from chromegcn_tpu_torch.ops import gcn_fused as tfused
from chromegcn_tpu_torch.ops import sparse as tsp
from chromegcn_tpu_torch.ops import spmm_bsr as tbsr
from chromegcn_tpu_torch.ops.seq import complement_permutation
from chromegcn_tpu_torch.train import finetune as tft
from chromegcn_tpu_torch.train import pretrain as tpt
from chromegcn_tpu_torch.utils.convert import chromegcn_state_dict, window_state_dict
from test_torch_window import (  # noqa: F401 (jax_no_dropout is a fixture)
    NTARGETS, SEQ, jax_no_dropout, jax_window_state, no_dropout, port_model,
)

CPU = "cpu"
D = 16  # d_model


def _comp():
    return complement_permutation(tconstants.SRC_VOCAB)


def _dataset(n_per_chrom, seed=0):
    return make_window_dataset(n_per_chrom, n_targets=NTARGETS, seq_length=SEQ, seed=seed)


def _jax_dataset(ds):
    return jloader.WindowDataset(ds.tokens, ds.targets, ds.chroms, ds.starts,
                                 ds.src_vocab, ds.tgt_vocab)


def _close_to_scale(got, want, what, rel=1e-4):
    """max |got - want| within ``rel`` of want's largest magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-12)
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"{what}: max abs err {err:.3e} > {rel} x scale {scale:.3e}"


def _jax_moments(opt_state, optim):
    """JAX's optimizer moments as parameter trees: Adam's (mu, nu), or SGD's
    momentum trace (train/optim.py's optax chains)."""
    inner = opt_state.inner_state
    if optim == "adam":
        return {"exp_avg": inner[0].mu, "exp_avg_sq": inner[0].nu}
    return {"momentum_buffer": inner[1].trace}


@pytest.mark.parametrize("name,optim,lr", [("expecto", "adam", 1e-3), ("deepsea", "sgd", 0.05)])
def test_three_train_steps_match_jax(name, optim, lr, jax_no_dropout):
    """Three steps from the same weights, dropout out on both sides; the
    last batch holds 2 windows and 2 copies of row 0, which enter the
    BatchNorm statistics but not the loss. After each step the loss, the
    probabilities, the running stats and every parameter agree to 1e-4 of
    their scale, and the optimizer's moments to 1e-3: a pre-activation
    within rounding of 0 can fall on the other side of a ReLU in one
    framework, which moves a few hundred of a conv's gradients by a few
    1e-4 of their scale (the other elements agree to ~1e-5).

    Adam's parameters are held to that plus what the two sides' moments
    explain through optax's update, lr m^ / (sqrt(v^) + eps):
    that ratio is ill-conditioned where a weight's gradients are at rounding
    level (at step 1 it is +-1 whatever their size), so 1e-4 of the moments'
    scale can move such a weight by up to 2 lr. The bound still holds the
    port's update to optax's formula. Each step starts from JAX's weights of
    the step before, so such a weight does not carry into the next step's
    gradients; the optimizer state and the running stats stay each side's
    own."""
    jmodel, params, stats = jax_window_state(name, seed=5)
    jstate = jpt.WindowTrainState.create(
        apply_fn=jpt.NonStrandSpecific(model=jmodel).apply, params=jax.tree_util.tree_map(
            jnp.asarray, params), batch_stats=jax.tree_util.tree_map(jnp.asarray, stats),
        tx=jax_make_optimizer(optim, lr))
    model = port_model(name, params, stats, d_model=D)
    state = tpt.WindowTrainState(model=no_dropout(model),
                                 optimizer=tpt.make_optimizer(optim, lr, model.parameters()))
    names = [k for k, _ in state.model.named_parameters()]
    comp = _comp()
    batches = list(tloader.iterate_batches(_dataset({"chr1": 6, "chr2": 4}), 4))
    assert batches[-1].row_mask.tolist() == [True, True, False, False]
    for i, b in enumerate(batches):
        with torch.no_grad():
            start = window_state_dict(jax.device_get(jstate.params),
                                      jax.device_get(jstate.batch_stats))
            for key, p in state.model.named_parameters():
                p.copy_(start[key])
        jstate, jloss, jprobs = jpt.window_train_step(
            jstate, jnp.asarray(b.tokens), jnp.asarray(b.targets), jnp.asarray(b.row_mask),
            jnp.asarray(comp), jax.random.PRNGKey(i))
        state, loss, probs = tpt.window_train_step(
            state, b.tokens, b.targets, b.row_mask, torch.as_tensor(comp), device=CPU)
        _close_to_scale(loss.item(), float(jloss), f"step {i} loss")
        _close_to_scale(probs.numpy(), np.asarray(jprobs), f"step {i} probs")
        stats_now = jax.device_get(jstate.batch_stats)
        ref = window_state_dict(jax.device_get(jstate.params), stats_now)
        moments = {kind: window_state_dict(jax.device_get(tree), stats_now)
                   for kind, tree in _jax_moments(jstate.opt_state, optim).items()}
        opt_state = state.optimizer.state_dict()["state"]
        for key, value in state.model.state_dict().items():
            if key.endswith("num_batches_tracked"):
                continue
            got, want = value.numpy(), ref[key].numpy()
            if key not in names:  # a running stat
                _close_to_scale(got, want, f"step {i} {key}")
                continue
            for kind, tree in moments.items():
                _close_to_scale(opt_state[names.index(key)][kind].numpy(), tree[key].numpy(),
                                f"step {i} {key} {kind}", rel=1e-3)
            err = np.abs(got.astype(np.float64) - want)
            allowed = 1e-4 * np.abs(want).max()
            if optim == "adam":
                def ratio(m, v, t=i + 1):
                    m, v = np.asarray(m, np.float64), np.asarray(v, np.float64)
                    return (m / (1 - 0.9 ** t)) / (np.sqrt(v / (1 - 0.98 ** t)) + 1e-8)

                ours = opt_state[names.index(key)]
                allowed = allowed + lr * 1.001 * np.abs(
                    ratio(ours["exp_avg"], ours["exp_avg_sq"])
                    - ratio(moments["exp_avg"][key], moments["exp_avg_sq"][key]))
            assert (err <= allowed).all(), f"step {i} {key}: max abs err {err.max():.3e}"
    assert state.step == 3


def test_run_window_epoch_matches_jax(monkeypatch):
    """An eval epoch with collect_features over two chromosomes and a padded
    tail, drained every 2 batches: predictions, targets, the summed loss and
    the features grouped by chromosome, in dataset order."""
    monkeypatch.setattr(tpt, "DRAIN_EVERY", 2)
    jmodel, params, stats = jax_window_state("expecto", seed=6)
    ds = _dataset({"chr5": 9, "chr3": 8}, seed=1)
    jstate = jpt.WindowTrainState.create(
        apply_fn=jpt.NonStrandSpecific(model=jmodel).apply,
        params=jax.tree_util.tree_map(jnp.asarray, params),
        batch_stats=jax.tree_util.tree_map(jnp.asarray, stats), tx=jax_make_optimizer("adam", 1e-3))
    _, jpreds, jtargs, jloss, jfeats = jpt.run_window_epoch(
        jstate, _jax_dataset(ds), jnp.asarray(_comp()), 4, train=False, collect_features=True)
    state = tpt.WindowTrainState(model=port_model("expecto", params, stats, d_model=D),
                                 optimizer=None)
    _, preds, targs, loss, feats = tpt.run_window_epoch(
        state, ds, torch.as_tensor(_comp()), 4, train=False, collect_features=True, device=CPU)
    np.testing.assert_allclose(preds, jpreds, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(targs, jtargs)
    assert loss == pytest.approx(jloss, rel=1e-5)
    assert list(feats) == list(jfeats) == ["chr5", "chr3"]
    for chrom, cf in jfeats.items():
        for field in ("forward", "backward"):
            np.testing.assert_allclose(getattr(feats[chrom], field), getattr(cf, field),
                                       rtol=1e-4, atol=1e-4, err_msg=f"{chrom} {field}")
        np.testing.assert_array_equal(feats[chrom].target, cf.target)
        np.testing.assert_array_equal(feats[chrom].starts, cf.starts)
    regrouped = tpt.group_features_by_chrom(
        ds, np.concatenate([feats[c].forward for c in feats]),
        np.concatenate([feats[c].backward for c in feats]))
    assert all(np.array_equal(regrouped[c].forward, feats[c].forward) for c in feats)
    with pytest.raises(ValueError, match="eval pass"):
        tpt.run_window_epoch(state, ds, torch.as_tensor(_comp()), 4, train=True,
                             collect_features=True, device=CPU)


def _jax_chrome_state():
    jmodel = jax_make_chrome_model("gcn", nclass=NTARGETS, dropout=0.0, nfeat=D,
                                   spmm_impl="xla")
    return jft.create_chrome_state(jmodel, jax_make_optimizer("sgd", 0.1),
                                   jax.random.PRNGKey(1), nfeat=D)


def test_warm_start_head_matches_jax():
    """The GCN's out and batch_norm from Expecto's classifier and head_bn
    (running stats included), as the JAX package copies them."""
    _, wparams, wstats = jax_window_state("expecto", seed=7)
    jstate = _jax_chrome_state()
    cparams, cstats = jft.warm_start_head_from_window(
        jstate.params, jstate.batch_stats, wparams, wstats)
    model = make_chrome_model("gcn", nclass=NTARGETS, nfeat=D)
    model.load_state_dict(chromegcn_state_dict(jax.device_get(jstate.params),
                                               jax.device_get(jstate.batch_stats)))
    tft.warm_start_head_from_window(model, window_state_dict(wparams, wstats))
    ref = chromegcn_state_dict(jax.device_get(cparams), jax.device_get(cstats))
    for key, value in model.state_dict().items():
        torch.testing.assert_close(value, ref[key], rtol=0, atol=0, msg=key)
    inner = {k[len("model."):]: v for k, v in window_state_dict(wparams, wstats).items()}
    torch.testing.assert_close(model.out.weight, inner["classifier.weight"])
    torch.testing.assert_close(model.batch_norm.running_var, inner["head_bn.running_var"])


@pytest.mark.parametrize("name", ["deepsea", "danq"])
def test_warm_start_needs_expecto(name):
    """DeepSEA has no head_bn and DanQ neither a classifier nor a head_bn:
    the JAX package stops with a KeyError there, and so does the port,
    saying why, before it changes the GCN."""
    _, wparams, wstats = jax_window_state(name, seed=8)
    jstate = _jax_chrome_state()
    with pytest.raises(KeyError):
        jft.warm_start_head_from_window(jax.device_get(jstate.params),
                                        jax.device_get(jstate.batch_stats), wparams, wstats)
    model = make_chrome_model("gcn", nclass=NTARGETS, nfeat=D)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(KeyError, match="only Expecto"):
        tft.warm_start_head_from_window(model, window_state_dict(wparams, wstats))
    for key, value in model.state_dict().items():
        assert torch.equal(value, before[key]), key


@pytest.mark.parametrize("d", [1850, 925, 6, 1])
def test_bsr_matmul_takes_any_width(d):
    """B1's wrapper checks pass at a width that is not a multiple of 4 (the
    kernel takes float2s or scalars there; it runs only on the card), the
    plain version computes it, and the fused kernels' rule still refuses it,
    so a model of that width takes the unfused path."""
    rng = np.random.default_rng(d)
    dense = (rng.random((256, 256)) < 0.03) * rng.random((256, 256))
    graph = tsp.from_dense(dense, device=CPU)
    op = tbsr.bsr_from_graph(graph, device=CPU)
    x = torch.as_tensor(rng.normal(size=(256, d)).astype(np.float32))
    assert tbsr._check_csr(op.fwd, x) == d
    got = tbsr.bsr_matmul(op.fwd, x)
    want = (torch.as_tensor(dense) @ x.double()).float()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert tfused.fused_fits(op, d) is (d % 4 == 0 and d <= 3328)
    with pytest.raises(ValueError, match="multiple of 4"):
        tfused._check_fused_csr(op.fwd, torch.zeros((256, 2 * d + 1)), tfused.fwd_smem_bytes, "B2")


def test_odd_width_model_takes_the_unfused_path():
    """A ChromeGCN at an odd d_model (DanQ's 925 features, here 9) with
    -gcn_fused on: fused_fits says no, and the layers run through SpmmBSR."""
    s, r, v = make_hic_edges(200, 600, seed=0)
    graph = tbsr.attach_bsr(tsp.build_chrom_graph("hic", n_valid=200, n_pad=256,
                                                  hic_edges=(s, r, v), device=CPU), device=CPU)
    model = make_chrome_model("gcn", nclass=NTARGETS, nfeat=9, spmm_impl="pallas", fused="on")
    x = torch.randn(256, 9, generator=torch.Generator().manual_seed(0))
    assert not model._use_fused(x, graph)
    _, logits, _ = model(x, graph, train=False)
    assert logits.shape == (256, NTARGETS) and torch.isfinite(logits).all()
