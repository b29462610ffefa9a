"""Port parity: the gated ChromeGCN, masked BatchNorm, loss and optimizers
of chromegcn_tpu_torch against the JAX package on the CPU, with weights
carried across by chromegcn_tpu_torch.utils.convert."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chromegcn_tpu.models.chrome import ChromeGCN as JaxChromeGCN
from chromegcn_tpu.models.norm import MaskedBatchNorm as JaxMaskedBatchNorm
from chromegcn_tpu.ops import sparse as jsp
from chromegcn_tpu.ops.spmm_pallas import attach_bsr as jax_attach_bsr
from chromegcn_tpu.train import optim as joptim
from chromegcn_tpu.train.loss import bce_with_logits as jax_bce
from chromegcn_tpu.utils.parity import LAYER_ORDER
from chromegcn_tpu_torch.data.synthetic import make_hic_edges
from chromegcn_tpu_torch.models.chrome import ChromeGCN, make_chrome_model
from chromegcn_tpu_torch.models.norm import MaskedBatchNorm
from chromegcn_tpu_torch.ops import sparse as tsp
from chromegcn_tpu_torch.ops.bce_fused import bce_grad_plain
from chromegcn_tpu_torch.ops.spmm_bsr import attach_bsr
from chromegcn_tpu_torch.train import optim
from chromegcn_tpu_torch.train.loss import bce_with_logits
from chromegcn_tpu_torch.utils.convert import chromegcn_state_dict

CPU = "cpu"
N_VALID, N, D, NCLASS = 500, 512, 32, 8


def _graphs(bsr):
    edges = make_hic_edges(N_VALID, 2000, seed=0)
    kw = dict(n_valid=N_VALID, n_pad=N, hic_edges=edges)
    tg = tsp.build_chrom_graph("hic", device=CPU, **kw)
    jg = jsp.build_chrom_graph("hic", **kw)
    if bsr:
        tg, jg = attach_bsr(tg, device=CPU), jax_attach_bsr(jg)
    return tg, jg


def _jax_variables(model, x, jg, seed=0):
    """JAX init, then non-trivial biases and BatchNorm state."""
    variables = jax.device_get(model.init(jax.random.PRNGKey(seed), jnp.asarray(x), jg, train=False))
    rng = np.random.default_rng(seed + 100)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    for name in ("GC1", "GC2", "W1", "W2", "out"):
        params[name]["bias"] = rng.normal(scale=0.1, size=params[name]["bias"].shape).astype(np.float32)
    params["batch_norm"]["scale"] = rng.uniform(0.5, 1.5, D).astype(np.float32)
    params["batch_norm"]["bias"] = rng.normal(scale=0.1, size=D).astype(np.float32)
    stats = {"batch_norm": {"mean": rng.normal(scale=0.1, size=D).astype(np.float32),
                            "var": rng.uniform(0.5, 2.0, D).astype(np.float32)}}
    return params, stats


def _port_model(params, stats, impl):
    model = ChromeGCN(nfeat=D, nhid=D, nclass=NCLASS, dropout=0.0, layers=2, spmm_impl=impl)
    model.load_state_dict(chromegcn_state_dict(params, stats))
    return model


def _capture(model):
    acts, hooks = {}, []
    for name in LAYER_ORDER:
        def hook(_mod, _inp, out, name=name):
            acts[name] = out.detach().numpy()
        hooks.append(getattr(model, name).register_forward_hook(hook))
    return acts, hooks


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("train", [False, True])
def test_layer_activations_match_jax(impl, train):
    tg, jg = _graphs(bsr=impl == "pallas")
    x = np.random.default_rng(1).normal(size=(N, D)).astype(np.float32)
    jmodel = JaxChromeGCN(nfeat=D, nhid=D, nclass=NCLASS, dropout=0.0, layers=2, spmm_impl=impl)
    params, stats = _jax_variables(jmodel, x, jg)

    (_, jlogits, _), inter = jmodel.apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), jg, train=train,
        capture_intermediates=True, mutable=["intermediates", "batch_stats"],
    )
    tree = inter["intermediates"]
    ref = {name: np.asarray(tree[name]["__call__"][0]) for name in LAYER_ORDER}

    model = _port_model(params, stats, impl)
    acts, hooks = _capture(model)
    _, logits, _ = model(torch.from_numpy(x), tg, train=train)
    for h in hooks:
        h.remove()
    for name in LAYER_ORDER:
        # rows past N_VALID are padding; compare the rows a loss would read
        np.testing.assert_allclose(acts[name][:N_VALID], ref[name][:N_VALID],
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(logits.detach().numpy()[:N_VALID], np.asarray(jlogits)[:N_VALID],
                               rtol=1e-5, atol=1e-5)
    if train:  # running stats updated from the masked batch statistics
        new = inter["batch_stats"]["batch_norm"]
        np.testing.assert_allclose(model.batch_norm.running_mean.numpy(), np.asarray(new["mean"]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(model.batch_norm.running_var.numpy(), np.asarray(new["var"]),
                                   rtol=1e-5, atol=1e-6)


def test_strand_stacked_and_skip_head_match_jax():
    """The port's BSR path at width 2*D against the JAX COO path."""
    tg, _ = _graphs(bsr=True)
    _, jg = _graphs(bsr=False)
    rng = np.random.default_rng(2)
    xs = rng.normal(size=(N, 2, D)).astype(np.float32)
    jmodel = JaxChromeGCN(nfeat=D, nhid=D, nclass=NCLASS, dropout=0.0, layers=2)
    params, stats = _jax_variables(jmodel, xs[:, 0], jg)
    model = _port_model(params, stats, "auto")
    for skip_head in (False, True):
        jx, jout, (jg1, jg2) = jmodel.apply({"params": params, "batch_stats": stats},
                                            jnp.asarray(xs), jg, train=False, skip_head=skip_head)
        x, out, (g1, g2) = model(torch.from_numpy(xs), tg, train=False, skip_head=skip_head)
        for a, b in ((x, jx), (out, jout), (g1, jg1), (g2, jg2)):
            assert a.shape == b.shape
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


def test_single_layer_and_no_graph():
    model = ChromeGCN(nfeat=16, nhid=16, nclass=5, dropout=0.0, layers=1)
    assert not hasattr(model, "GC2")
    x = torch.randn(24, 16)
    _, logits, (g1, g2) = model(x, None, train=False)
    assert logits.shape == (24, 5) and g1.shape == (24, 1) and g2 is None
    gc = model.GC1
    torch.testing.assert_close(gc(x, None), x @ gc.weight + gc.bias)


def test_init_scales():
    """GC xavier-normal gain 0.02 (reference models/SubLayers.py:33); Linear
    lecun-normal as flax Dense."""
    model = make_chrome_model("gcn", nclass=919, nfeat=128)
    model.reset_parameters(torch.Generator().manual_seed(0))
    w = model.GC1.weight.detach().numpy()
    assert abs(w.std() - 0.02 * np.sqrt(2.0 / 256)) / (0.02 * np.sqrt(2.0 / 256)) < 0.1
    o = model.out.weight.detach().numpy()
    assert abs(o.std() - np.sqrt(1 / 128)) / np.sqrt(1 / 128) < 0.1
    assert np.abs(o).max() <= 2 * np.sqrt(1 / 128) / 0.87962566103423978 + 1e-6
    assert not model.GC1.bias.any() and not model.out.bias.any()


def test_unported_options_name_their_roadmap_item():
    # ChromeRNN (A12) has landed: "rnn" builds (tests/test_torch_rnn.py holds it to JAX)
    model = make_chrome_model("rnn", nclass=4, nfeat=8)
    assert type(model).__name__ == "ChromeRNN" and model.out.out_features == 4
    with pytest.raises(ValueError):
        make_chrome_model("transformer", nclass=4)


@pytest.mark.parametrize("shape,masked", [((64, 8), True), ((64, 8), False), ((32, 2, 8), True)])
def test_masked_batchnorm_matches_jax(shape, masked):
    rng = np.random.default_rng(3)
    x = rng.normal(size=shape).astype(np.float32)
    mask = None
    if masked:
        mask = np.zeros(shape[0], bool)
        mask[: shape[0] - 7] = True
        x[shape[0] - 7:] = 1e6  # garbage in padding must not leak into the stats
    bn = JaxMaskedBatchNorm()
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(x), use_running_average=False)
    jm = None if mask is None else jnp.asarray(mask)
    ref, upd = bn.apply(variables, jnp.asarray(x), use_running_average=False, mask=jm,
                        mutable=["batch_stats"])
    tbn = MaskedBatchNorm(8)
    out = tbn(torch.from_numpy(x), use_running_average=False,
              mask=None if mask is None else torch.from_numpy(mask))
    rows = slice(None) if mask is None else slice(0, shape[0] - 7)
    np.testing.assert_allclose(out.detach().numpy()[rows], np.asarray(ref)[rows], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tbn.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tbn.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-5, atol=1e-5)
    # eval mode normalizes with the running stats
    ev = tbn(torch.from_numpy(x), use_running_average=True)
    jev = bn.apply({"params": variables["params"], "batch_stats": upd["batch_stats"]},
                   jnp.asarray(x), use_running_average=True)
    np.testing.assert_allclose(ev.detach().numpy(), np.asarray(jev), rtol=1e-5, atol=1e-5)


def test_bce_with_logits_matches_jax():
    rng = np.random.default_rng(4)
    logits = (rng.normal(size=(50, 9)) * 5).astype(np.float32)
    targets = (rng.random((50, 9)) < 0.3).astype(np.float32)
    mask = rng.random(50) < 0.8
    for m in (None, mask):
        ours = bce_with_logits(torch.from_numpy(logits), torch.from_numpy(targets),
                               None if m is None else torch.from_numpy(m))
        ref = jax_bce(jnp.asarray(logits), jnp.asarray(targets), None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(float(ours), float(ref), rtol=1e-6)


@pytest.mark.parametrize("cotangent", [1.0, -2.5])
@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
def test_bce_closed_form_gradient_matches_jax(masked, cotangent):
    """The gradient the card's kernel computes, g m (sigmoid(x) - z) with g
    the mean's cotangent over (count L), written once as
    ``bce_grad_plain``, is JAX's ``jax.grad`` of the mean loss, and the
    torch formula's autograd (no logit is exactly 0, where the two differ)."""
    rng = np.random.default_rng(6)
    logits = (rng.normal(size=(50, 9)) * 5).astype(np.float32)
    targets = (rng.random((50, 9)) < 0.3).astype(np.float32)
    mask = rng.random(50) < 0.8 if masked else np.ones(50, bool)
    ref = jax.grad(lambda x: cotangent * jax_bce(x, jnp.asarray(targets),
                                                 jnp.asarray(mask) if masked else None))(
        jnp.asarray(logits))
    x, z = torch.from_numpy(logits), torch.from_numpy(targets)
    m = torch.from_numpy(mask.astype(np.float32))
    g = torch.tensor(cotangent / (mask.sum() * logits.shape[1]), dtype=torch.float32)
    closed = bce_grad_plain(x, z, m, g)
    np.testing.assert_allclose(closed.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-8)
    xg = x.clone().requires_grad_(True)
    (cotangent * bce_with_logits(xg, z, torch.from_numpy(mask) if masked else None)).backward()
    np.testing.assert_allclose(xg.grad.numpy(), closed.numpy(), rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bce_with_logits_takes_the_torch_formula_on_the_cpu(dtype):
    """On the CPU, in f32 and float64, the loss and its gradient are the
    torch formula's as it stood before the card's kernels, bit for bit, and
    no kernel is launched."""
    from chromegcn_tpu_torch.ops import _build

    rng = np.random.default_rng(7)
    logits = torch.from_numpy(rng.normal(size=(64, 919)) * 4).to(dtype)
    targets = torch.from_numpy(rng.random((64, 919)) < 0.05)
    mask = torch.from_numpy(rng.random(64) < 0.75)

    def before(x):
        z = targets.to(x.dtype)
        per_elem = x.clamp(min=0.0) - x * z + torch.log1p(torch.exp(-x.abs()))
        m = mask.to(x.dtype)[:, None]
        return (per_elem * m).sum() / (m.sum() * per_elem.shape[1]).clamp(min=1.0)

    launches = dict(_build.LAUNCHES)
    x, x_before = logits.clone().requires_grad_(True), logits.clone().requires_grad_(True)
    loss, loss_before = bce_with_logits(x, targets, mask), before(x_before)
    loss.backward()
    loss_before.backward()
    assert loss.dtype == dtype and torch.equal(loss, loss_before)
    assert torch.equal(x.grad, x_before.grad)
    assert dict(_build.LAUNCHES) == launches


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_optimizer_matches_optax(name):
    """Three updates from the same gradients give the same parameters."""
    rng = np.random.default_rng(5)
    p0 = rng.normal(size=(6, 4)).astype(np.float32)
    grads = [rng.normal(size=(6, 4)).astype(np.float32) for _ in range(3)]
    tx = joptim.make_optimizer(name, 0.1)
    jp, st = jnp.asarray(p0), None
    st = tx.init(jp)
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = optim.make_optimizer(name, 0.1, [param])
    for g in grads:
        upd, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, upd)
        param.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(param.detach().numpy(), np.asarray(jp), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        optim.make_optimizer("lamb", 0.1, [param])


def test_lr_schedule_matches_jax():
    for epoch in (0, 99, 100, 250):
        for enabled in (True, False):
            assert optim.steplr_lr(0.25, epoch, enabled) == joptim.steplr_lr(0.25, epoch, enabled)
    param = torch.nn.Parameter(torch.zeros(2))
    opt = optim.set_learning_rate(optim.make_optimizer("sgd", 0.25, [param]), 0.125)
    assert opt.param_groups[0]["lr"] == 0.125
