"""The slice as a whole: chromegcn_tpu_torch's chromosome-stage train and
eval steps against the JAX package on the CPU, from the same weights on the
same graph, with dropout 0 (the two frameworks draw dropout masks
differently, so with dropout on only the mask statistics are checked)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chromegcn_tpu.data.loader import ChromFeatures as JaxChromFeatures
from chromegcn_tpu.models.chrome import ChromeGCN as JaxChromeGCN
from chromegcn_tpu.ops import sparse as jsp
from chromegcn_tpu.ops.spmm_pallas import attach_bsr as jax_attach_bsr
from chromegcn_tpu.train import finetune as jft
from chromegcn_tpu.train.optim import make_optimizer as jax_make_optimizer
from chromegcn_tpu_torch.data.loader import ChromFeatures
from chromegcn_tpu_torch.data.synthetic import make_hic_edges
from chromegcn_tpu_torch.models.chrome import _dropout, make_chrome_model
from chromegcn_tpu_torch.ops import _build
from chromegcn_tpu_torch.ops import sparse as tsp
from chromegcn_tpu_torch.ops.spmm_bsr import attach_bsr
from chromegcn_tpu_torch.train import finetune as tft
from chromegcn_tpu_torch.utils.convert import chromegcn_state_dict

CPU = "cpu"
D, NCLASS, LR = 32, 8, 0.25


def _graph_pair(n_valid, n_pad, seed, bsr=True):
    edges = make_hic_edges(n_valid, 4 * n_valid, seed=seed)
    kw = dict(n_valid=n_valid, n_pad=n_pad, hic_edges=edges)
    tg = tsp.build_chrom_graph("hic", device=CPU, **kw)
    jg = jsp.build_chrom_graph("hic", **kw)
    if bsr:
        tg, jg = attach_bsr(tg, device=CPU), jax_attach_bsr(jg)
    return tg, jg


def _states(jg, n_pad):
    """A JAX train state and the port's, holding the same weights."""
    jmodel = JaxChromeGCN(nfeat=D, nhid=D, nclass=NCLASS, dropout=0.0, layers=2)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((n_pad, D)), jg, train=False)
    jstate = jft.ChromeTrainState.create(
        apply_fn=jmodel.apply, params=variables["params"],
        batch_stats=variables["batch_stats"], tx=jax_make_optimizer("sgd", LR),
    )
    model = make_chrome_model("gcn", nclass=NCLASS, dropout=0.0, nfeat=D)
    state = tft.create_chrome_state(model, "sgd", LR, seed=0, device=CPU)
    model.load_state_dict(chromegcn_state_dict(
        jax.device_get(jstate.params), jax.device_get(jstate.batch_stats)))
    return jstate, state


def _assert_state_close(state, jstate, atol):
    ref = chromegcn_state_dict(jax.device_get(jstate.params), jax.device_get(jstate.batch_stats))
    ours = state.model.state_dict()
    assert set(ours) == set(ref)
    for name, value in ref.items():
        np.testing.assert_allclose(ours[name].numpy(), value.numpy(), rtol=atol, atol=atol,
                                   err_msg=name)


def test_three_train_steps_and_eval_match_jax():
    n_valid, n_pad = 500, 512
    tg, jg = _graph_pair(n_valid, n_pad, seed=0)
    rng = np.random.default_rng(0)
    x_f = rng.normal(size=(n_pad, D)).astype(np.float32)
    x_r = rng.normal(size=(n_pad, D)).astype(np.float32)
    targets = (rng.random((n_pad, NCLASS)) < 0.1).astype(np.float32)
    jstate, state = _states(jg, n_pad)
    key = jax.random.PRNGKey(1)

    _build.LAUNCHES.clear()
    for step in range(3):
        jstate, jloss, jprobs = jft.chrome_train_step(
            jstate, jnp.asarray(x_f), jnp.asarray(x_r), jg, jnp.asarray(targets), key)
        state, loss, probs = tft.chrome_train_step(state, x_f, x_r, tg, targets, device=CPU)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5, err_msg=f"step {step}")
        np.testing.assert_allclose(probs.numpy()[:n_valid], np.asarray(jprobs)[:n_valid],
                                   rtol=1e-5, atol=1e-5)
    # params and BatchNorm running stats after 3 SGD steps (momentum, wd)
    _assert_state_close(state, jstate, atol=1e-4)
    assert state.step == 3
    assert _build.LAUNCHES["bsr_spmm"] == 0  # CPU tensors never launch the kernel

    jloss, jprobs = jft.chrome_eval_step(
        jstate, jnp.asarray(x_f), jnp.asarray(x_r), jg, jnp.asarray(targets))
    loss, probs = tft.chrome_eval_step(state, x_f, x_r, tg, targets, device=CPU)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(probs.numpy()[:n_valid], np.asarray(jprobs)[:n_valid],
                               rtol=1e-5, atol=1e-5)


def test_run_chrome_epoch_matches_jax():
    """Two chromosomes of different sizes, one train epoch then one eval epoch."""
    sizes = {"chr1": (700, 1024), "chr2": (400, 512)}
    graphs, jgraphs, feats, jfeats = {}, {}, {}, {}
    rng = np.random.default_rng(1)
    for i, (chrom, (n_valid, n_pad)) in enumerate(sizes.items()):
        graphs[chrom], jgraphs[chrom] = _graph_pair(n_valid, n_pad, seed=10 + i, bsr=False)
        arrays = dict(
            forward=rng.normal(size=(n_valid, D)).astype(np.float32),
            backward=rng.normal(size=(n_valid, D)).astype(np.float32),
            target=(rng.random((n_valid, NCLASS)) < 0.2).astype(np.float32),
        )
        feats[chrom], jfeats[chrom] = ChromFeatures(**arrays), JaxChromFeatures(**arrays)
    jstate, state = _states(jgraphs["chr1"], 1024)
    key = jax.random.PRNGKey(2)
    for train in (True, False):
        jstate, jpreds, jtargs, jloss = jft.run_chrome_epoch(
            jstate, jfeats, jgraphs, train=train, rng=key)
        state, preds, targs, loss = tft.run_chrome_epoch(
            state, feats, graphs, train=train, device=CPU)
        assert preds.shape == jpreds.shape == (1100, NCLASS)
        np.testing.assert_array_equal(targs, jtargs)
        np.testing.assert_allclose(preds, jpreds, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    _assert_state_close(state, jstate, atol=1e-4)


def test_dropout_draws_from_the_generator():
    x = torch.ones(20000)
    a = _dropout(x, 0.2, True, torch.Generator().manual_seed(5))
    b = _dropout(x, 0.2, True, torch.Generator().manual_seed(5))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    kept = a != 0
    assert abs(kept.float().mean().item() - 0.8) < 0.02
    torch.testing.assert_close(a[kept], torch.full_like(a[kept], 1 / 0.8))
    assert _dropout(x, 0.2, False, None) is x
    assert not _dropout(x, 1.0, True, None).any()


def test_bucket_and_pad_rows_match_jax():
    for n in (1, 2047, 2048, 50_000):
        assert tft.bucket_nodes(n) == jft.bucket_nodes(n)
    a = np.arange(12, dtype=np.float32).reshape(4, 3)
    np.testing.assert_array_equal(tft.pad_rows(a, 6), jft.pad_rows(a, 6))
    assert tft.pad_rows(a, 4) is a


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_create_chrome_state_is_seeded(optimizer):
    def params(seed):
        model = make_chrome_model("gcn", nclass=NCLASS, nfeat=D)
        state = tft.create_chrome_state(model, optimizer, LR, seed=seed, device=CPU)
        return {k: v.clone() for k, v in state.model.state_dict().items()}

    p0, p0b, p1 = params(0), params(0), params(1)
    assert all(torch.equal(p0[k], p0b[k]) for k in p0)
    assert not torch.equal(p0["GC1.weight"], p1["GC1.weight"])
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
