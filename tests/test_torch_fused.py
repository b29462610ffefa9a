"""Port parity: the fused gated layer (chromegcn_tpu_torch.ops.gcn_fused,
kernels B2/B3) and ChromeGCN(fused="on") against the JAX package's
ops/gcn_fused.py, whose Pallas kernels run in interpret mode on the CPU, on
tests/test_fused.py's world.

On the CPU the kernel wrappers take their plain versions; the CUDA kernels
are held against the same plain versions on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chromegcn_tpu.models.chrome import ChromeGCN as JaxChromeGCN
from chromegcn_tpu.ops import gcn_fused as jfused
from chromegcn_tpu.ops import sparse as jsp
from chromegcn_tpu.ops.spmm_pallas import attach_bsr as jax_attach_bsr
from chromegcn_tpu.train import finetune as jft
from chromegcn_tpu.train.optim import make_optimizer as jax_make_optimizer
from chromegcn_tpu_torch.data.synthetic import make_hic_edges
from chromegcn_tpu_torch.models.chrome import ChromeGCN
from chromegcn_tpu_torch.ops import _build
from chromegcn_tpu_torch.ops import gcn_fused as tfused
from chromegcn_tpu_torch.ops import sparse as tsp
from chromegcn_tpu_torch.ops.spmm_bsr import attach_bsr, bsr_from_graph
from chromegcn_tpu_torch.train import finetune as tft
from chromegcn_tpu_torch.utils.convert import chromegcn_state_dict

CPU = "cpu"
N_VALID, N_PAD, D, NCLASS = 200, 256, 32, 5


def _graph_pair(**attach):
    """tests/test_fused.py's graph with its BSR form, on both sides."""
    edges = make_hic_edges(N_VALID, 400, seed=3)
    kw = dict(n_valid=N_VALID, n_pad=N_PAD, hic_edges=edges)
    return (attach_bsr(tsp.build_chrom_graph("hic", device=CPU, **kw), device=CPU, **attach),
            jax_attach_bsr(jsp.build_chrom_graph("hic", **kw), **attach))


def _layer_inputs(d, w_scale, seed=0):
    """(x, w, b, u, bu) of one gated layer at width d."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N_PAD, d)).astype(np.float32)
    w = (rng.normal(size=(d, d)) * w_scale).astype(np.float32)
    b = (rng.normal(size=(d,)) * 0.1).astype(np.float32)
    u = (rng.normal(size=(d, 1)) * 0.1).astype(np.float32)
    bu = (rng.normal(size=(1,)) * 0.1).astype(np.float32)
    return x, w, b, u, bu


@pytest.fixture(scope="module")
def world():
    """tests/test_fused.py's graph and layer inputs, on both sides."""
    graphs = {dtype: _graph_pair(dtype=dtype) for dtype in ("float32", "bfloat16")}
    return graphs, _layer_inputs(D, 0.1)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_fwd_and_bwd_match_jax_kernels(world, dtype):
    """B2 and B3's plain versions against the JAX kernels they replace."""
    graphs, (x, w, b, _, _) = world
    tg, jg = graphs[dtype]
    rng = np.random.default_rng(1)
    ds = rng.normal(size=(N_PAD, D)).astype(np.float32)
    dx_dir = rng.normal(size=(N_PAD, D)).astype(np.float32)

    _build.LAUNCHES.clear()
    z = tfused.fused_fwd(tg.bsr.fwd, *_t(x, w, b))
    h, dx = tfused.fused_bwd(tg.bsr.bwd, *_t(ds, dx_dir, w))
    assert not _build.LAUNCHES  # CPU tensors never launch a kernel
    jz = jfused._fused_fwd_call(jg.bsr.fwd, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    jh, jdx = jfused._fused_bwd_call(jg.bsr.bwd, jnp.asarray(ds), jnp.asarray(dx_dir),
                                     jnp.asarray(w))
    # 1e-5: f32 sums of the same products in another order
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=1e-5, atol=1e-5)
    # padding rows (no blocks) come out as the reference's zero accumulator gives
    np.testing.assert_allclose(z.numpy()[N_PAD - 1], np.tanh(b), rtol=1e-6, atol=1e-7)


def _layer_loss(xn, z, g, r):
    r1, r2, r3 = r
    return (xn * r1).sum() + (z * r2).sum() + (g * r3).sum()


def _check_layer_against_jax(tg, jg, inputs, bf16=False):
    """The port's fused layer against JAX's, outputs and the five gradients,
    with a loss that touches x_next, z and g so every output cotangent
    flows (tests/test_fused.py:50-72)."""
    d = inputs[0].shape[1]
    rng = np.random.default_rng(2)
    r = (rng.normal(size=(N_PAD, d)).astype(np.float32),
         rng.normal(size=(N_PAD, d)).astype(np.float32),
         rng.normal(size=(N_PAD, 1)).astype(np.float32))

    params = [t.requires_grad_() for t in _t(*inputs)]
    outs = tfused.fused_gated_layer(tg.bsr, *params)
    _layer_loss(*outs, _t(*r)).backward()

    jin = [jnp.asarray(a) for a in inputs]
    jouts = jfused.fused_gated_layer(jg.bsr, *jin)
    jgrads = jax.grad(
        lambda *a: _layer_loss(*jfused.fused_gated_layer(jg.bsr, *a), r),
        argnums=(0, 1, 2, 3, 4),
    )(*jin)
    for name, ours, ref in zip(("x_next", "z", "g"), outs, jouts):
        np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    for name, p, ref in zip(("dx", "dw", "db", "du", "dbu"), params, jgrads):
        scale = float(np.abs(np.asarray(ref)).max())
        atol = 1e-5 * scale
        if bf16 and name in ("dx", "dw"):
            # B3 rounds ds to bf16. The two frameworks' f32 ds differ in the
            # last bits, so a few entries round one bf16 ulp (2^-8) apart, and
            # h = A^T ds carries that into dx and dw (measured: 2.5e-4 of
            # scale). db, du and dbu come before the rounding and stay at 1e-5.
            atol = 2.0**-8 * scale
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=atol, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_gated_layer_matches_jax(world, dtype):
    graphs, inputs = world
    _check_layer_against_jax(*graphs[dtype], inputs, bf16=dtype == "bfloat16")


@pytest.mark.parametrize("tile,d", [(256, 128), (128, 256)])
def test_operators_the_edge_form_kernels_admit_match_jax(tile, d):
    """A tile-256 operator at d 128, and d 256 on tile 128, which the
    edge-form kernels take (the block walk took neither): the fused model
    takes them, and the layer matches JAX's at the tolerances above."""
    tg, jg = _graph_pair(tile=tile)
    inputs = _layer_inputs(d, d ** -0.5, seed=d)
    assert tfused.fused_fits(tg.bsr, d)
    model = ChromeGCN(nfeat=d, nhid=d, nclass=NCLASS, fused="on")
    assert model._use_fused(torch.from_numpy(inputs[0]), tg)
    _check_layer_against_jax(tg, jg, inputs)


def _jax_model_and_params(jg, x):
    jmodel = JaxChromeGCN(nfeat=D, nhid=D, nclass=NCLASS, dropout=0.0, layers=2,
                          fused="on")
    variables = jax.device_get(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x), jg,
                                           train=False))
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    for name in ("GC1", "GC2", "W1", "W2", "out"):
        params[name]["bias"] = rng.normal(scale=0.1, size=params[name]["bias"].shape).astype(np.float32)
    stats = {"batch_norm": {"mean": rng.normal(scale=0.1, size=D).astype(np.float32),
                            "var": rng.uniform(0.5, 2.0, D).astype(np.float32)}}
    return jmodel, params, stats


def _port_model(params, stats, fused):
    model = ChromeGCN(nfeat=D, nhid=D, nclass=NCLASS, dropout=0.0, layers=2, fused=fused)
    model.load_state_dict(chromegcn_state_dict(params, stats))
    return model


def _bce(logits, targ):
    return -torch.mean(targ * torch.nn.functional.logsigmoid(logits)
                       + (1 - targ) * torch.nn.functional.logsigmoid(-logits))


def test_model_fused_matches_jax_fused(world):
    """ChromeGCN(fused='on') against the JAX model, on weights converted from
    it: outputs, gates and parameter gradients, at tests/test_fused.py:93-117's
    tolerances."""
    graphs, (x, *_) = world
    tg, jg = graphs["float32"]
    jmodel, params, stats = _jax_model_and_params(jg, x)
    targ = (np.random.default_rng(2).random((N_PAD, NCLASS)) < 0.2).astype(np.float32)

    model = _port_model(params, stats, "on")
    assert model._use_fused(torch.from_numpy(x), tg)
    _build.LAUNCHES.clear()
    xr, logits, (g1, g2) = model(torch.from_numpy(x), tg, train=False)
    _bce(logits, torch.from_numpy(targ)).backward()
    assert not _build.LAUNCHES

    variables = {"params": params, "batch_stats": stats}
    jx, jlogits, (jg1, jg2) = jmodel.apply(variables, jnp.asarray(x), jg, train=False)
    np.testing.assert_allclose(xr.detach().numpy(), np.asarray(jx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(g1.detach().numpy(), np.asarray(jg1), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(g2.detach().numpy(), np.asarray(jg2), rtol=1e-5, atol=1e-5)

    def loss(p):
        _, lg, _ = jmodel.apply({"params": p, "batch_stats": stats}, jnp.asarray(x), jg,
                                train=False)
        return -jnp.mean(targ * jax.nn.log_sigmoid(lg) + (1 - targ) * jax.nn.log_sigmoid(-lg))

    jgrads = chromegcn_state_dict(jax.device_get(jax.grad(loss)(params)), stats)
    for name, p in model.named_parameters():
        ref = jgrads[name].numpy()
        scale = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=1e-4, atol=1e-5 * scale,
                                   err_msg=name)


def test_model_fused_matches_port_unfused(world):
    """The port's fused and unfused paths on the same weights, train mode
    (batch statistics), dropout 0: outputs, gates and parameter gradients."""
    graphs, (x, *_) = world
    tg, jg = graphs["float32"]
    _, params, stats = _jax_model_and_params(jg, x)
    targ = torch.from_numpy(
        (np.random.default_rng(3).random((N_PAD, NCLASS)) < 0.2).astype(np.float32))
    results = {}
    for fused in ("on", "off"):
        model = _port_model(params, stats, fused)
        assert model._use_fused(torch.from_numpy(x), tg) == (fused == "on")
        xr, logits, gates = model(torch.from_numpy(x), tg, train=True)
        _bce(logits, targ).backward()
        results[fused] = (xr, logits, *gates, {n: p.grad for n, p in model.named_parameters()},
                          model.batch_norm.running_var.clone())
    on, off = results["on"], results["off"]
    for a, b in zip(on[:4], off[:4]):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(on[5].numpy(), off[5].numpy(), rtol=1e-5, atol=1e-6)
    for name, grad in off[4].items():
        scale = max(1.0, float(grad.abs().max()))
        np.testing.assert_allclose(on[4][name].numpy(), grad.numpy(), rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=name)


def test_three_sgd_steps_match_jax_fused(world):
    """Three train steps of the fused model against the JAX fused model from
    the same weights, dropout 0: the loss of each step, then params and
    BatchNorm running statistics."""
    graphs, _ = world
    tg, jg = graphs["float32"]
    rng = np.random.default_rng(4)
    x_f = rng.normal(size=(N_PAD, D)).astype(np.float32)
    x_r = rng.normal(size=(N_PAD, D)).astype(np.float32)
    targets = (rng.random((N_PAD, 7)) < 0.2).astype(np.float32)

    jmodel = JaxChromeGCN(nfeat=D, nhid=D, nclass=7, dropout=0.0, layers=2, fused="on")
    jstate = jft.create_chrome_state(jmodel, jax_make_optimizer("sgd", 0.25),
                                     jax.random.PRNGKey(0), nfeat=D, n_nodes=N_PAD)
    model = ChromeGCN(nfeat=D, nhid=D, nclass=7, dropout=0.0, layers=2, fused="on")
    state = tft.create_chrome_state(model, "sgd", 0.25, seed=0, device=CPU)
    model.load_state_dict(chromegcn_state_dict(jax.device_get(jstate.params),
                                               jax.device_get(jstate.batch_stats)))
    key = jax.random.PRNGKey(1)
    for step in range(3):
        key, sub = jax.random.split(key)
        jstate, jloss, _ = jft.chrome_train_step(jstate, jnp.asarray(x_f), jnp.asarray(x_r),
                                                 jg, jnp.asarray(targets), sub)
        state, loss, _ = tft.chrome_train_step(state, x_f, x_r, tg, targets, device=CPU)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5, err_msg=f"step {step}")
    ref = chromegcn_state_dict(jax.device_get(jstate.params), jax.device_get(jstate.batch_stats))
    ours = state.model.state_dict()
    for name, value in ref.items():
        np.testing.assert_allclose(ours[name].numpy(), value.numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def test_use_fused_conditions(world):
    """The reference's conditions (models/chrome.py:151-163), with the
    kernels' fused_fits in place of the VMEM budget."""
    graphs, (x, *_) = world
    tg, _ = graphs["float32"]
    xt = torch.from_numpy(x)
    model = ChromeGCN(nfeat=D, nhid=D, nclass=NCLASS, fused="on")
    assert model._use_fused(xt, tg)
    assert not ChromeGCN(nfeat=D, nhid=D, nclass=NCLASS, fused="off")._use_fused(xt, tg)
    assert not ChromeGCN(nfeat=D, nhid=D, nclass=NCLASS, fused="on",
                         spmm_impl="xla")._use_fused(xt, tg)
    assert ChromeGCN(nfeat=D, nhid=D, nclass=NCLASS, fused="on",
                     spmm_impl="pallas")._use_fused(xt, tg)
    assert not model._use_fused(xt, None)
    assert not model._use_fused(xt, tg.replace(bsr=None))
    assert not model._use_fused(xt[:, None, :].expand(N_PAD, 2, D), tg)  # strand-stacked
    assert not ChromeGCN(nfeat=D, nhid=16, nclass=NCLASS, fused="on")._use_fused(xt, tg)
    # a width the kernels do not take: past both shared-memory plans
    wide = 3332
    assert not tfused.fused_fits(tg.bsr, wide)
    xw = torch.from_numpy(np.random.default_rng(6).normal(size=(N_PAD, wide)).astype(np.float32))
    wide_model = ChromeGCN(nfeat=wide, nhid=wide, nclass=NCLASS, fused="on")
    assert not wide_model._use_fused(xw, tg)
    # ... and then the model takes the unfused path, with the same result
    unfused = ChromeGCN(nfeat=wide, nhid=wide, nclass=NCLASS, fused="off")
    unfused.load_state_dict(wide_model.state_dict())
    torch.testing.assert_close(wide_model(xw, tg, train=False)[1],
                               unfused(xw, tg, train=False)[1])
    with pytest.raises(ValueError):
        ChromeGCN(fused="auto")


def test_fused_fits_is_the_kernels_plan(world):
    """The edge-form kernels' rule: any operator with an edge form, d a
    positive multiple of 4 whose two shared-memory plans fit."""
    graphs, _ = world
    tg = graphs["float32"][0]
    op = tg.bsr
    assert tfused.fused_fits(op, 32) and tfused.fused_fits(op, 128)
    assert tfused.fused_fits(op, 256) and tfused.fused_fits(op, 3328)
    assert not tfused.fused_fits(op, 30) and not tfused.fused_fits(op, 0)
    assert not tfused.fused_fits(op, 3332)  # past both plans
    assert tfused.bwd_smem_bytes(3332) > tfused.SMEM_LIMIT < tfused.fwd_smem_bytes(3332)
    assert not tfused.fused_fits(None, 32) and not tfused.fused_fits(op.fwd, 32)
    for tile in (32, 64, 128, 256):  # the kernels read no tiles
        assert tfused.fused_fits(bsr_from_graph(tg, tile=tile, device=CPU), 128)
    # the plan csrc/gcn_fused.cu launches with (gcn_fused_smem_bytes agrees
    # on the card: chip_smoke.py): 64 rows of h, (128 + 4) floats each, and
    # two W chunks of 32 rows of (64 + 8) floats
    assert tfused.fwd_smem_bytes(128) == 4 * (64 * (128 + 4) + 2 * 32 * (64 + 8)) == 52_224
    assert tfused.fwd_smem_bytes(30) == tfused.fwd_smem_bytes(32)  # k padded to 32


def test_wrappers_take_plain_version_only_on_the_cpu(world):
    graphs, (x, w, b, _, _) = world
    m = graphs["float32"][0].bsr.fwd
    xt, wt, bt = _t(x, w, b)
    torch.testing.assert_close(tfused.fused_fwd(m, xt, wt, bt),
                               tfused.fused_fwd_plain(m, xt, wt, bt), rtol=0, atol=0)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfused.fused_fwd(m, xt.to("meta"), wt, bt)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfused.fused_bwd(m, xt.to("meta"), xt, wt)
