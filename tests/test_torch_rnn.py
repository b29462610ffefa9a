"""The port's ChromeRNN (models/chrome.py, utils/convert.py:chromernn_state_dict,
the finetune steps with ``-chrome_model rnn``) against the JAX package's, on
the CPU: forward in eval and train mode, 1 and 2 layers (and 3 in eval mode)
and ``skip_head``, from the same weights; the train step's loss and every gradient; and the bucket
dependence the reference has (the reverse direction reads the padded
suffix)."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chromegcn_tpu.models.chrome import ChromeRNN as JaxChromeRNN
from chromegcn_tpu.ops import sparse as jsp
from chromegcn_tpu.train import finetune as jft
from chromegcn_tpu.train.loss import bce_with_logits as jax_bce
from chromegcn_tpu.train.optim import make_optimizer as jax_make_optimizer
from chromegcn_tpu_torch.models.chrome import ChromeRNN, lstm_forward, make_chrome_model
from chromegcn_tpu_torch.ops import sparse as tsp
from chromegcn_tpu_torch.train import finetune as tft
from chromegcn_tpu_torch.utils.convert import chromernn_state_dict

CPU = "cpu"
N_VALID, N_PAD, D, NCLASS = 40, 64, 16, 5


@contextlib.contextmanager
def one_thread():
    """torch's CPU ops on one thread. The test workers share the cores: a
    CPU LSTM meets its threads at a barrier every time step, which stalls
    when every worker runs a full pool (the LSTMs here are tiny), and the
    convolutions slow down too."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def torch_one_thread():
    with one_thread():
        yield
# f32 recurrences of 64 steps in another order: 1e-5 of each output's scale
TOL = 1e-5


def _graphs(n_pad=N_PAD, n_valid=N_VALID):
    return (tsp.build_chrom_graph("none", n_valid=n_valid, n_pad=n_pad, device=CPU),
            jsp.build_chrom_graph("none", n_valid=n_valid, n_pad=n_pad))


def _inputs(n_pad=N_PAD, seed=1, n_valid=N_VALID):
    """(n_pad, D) features, the padded rows zero as the runner pads them."""
    x = np.zeros((n_pad, D), np.float32)
    x[:n_valid] = np.random.default_rng(seed).normal(size=(n_valid, D))
    return x


def _jax_state(layers, seed=0):
    """JAX init, then non-zero LSTM biases and head/BatchNorm state, so every
    converted tensor matters."""
    model = JaxChromeRNN(nfeat=D, nclass=NCLASS, dropout=0.0, layers=layers)
    variables = jax.device_get(model.init(jax.random.PRNGKey(seed), jnp.zeros((N_PAD, D)),
                                          None, train=False))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    rng = np.random.default_rng(seed + 100)
    for name, cell in params.items():
        if name.startswith("OptimizedLSTMCell_"):
            for gate in ("hi", "hf", "hg", "ho"):
                cell[gate]["bias"] = rng.normal(scale=0.1, size=D // 2).astype(np.float32)
    params["out"]["bias"] = rng.normal(scale=0.1, size=NCLASS).astype(np.float32)
    params["batch_norm"]["scale"] = rng.uniform(0.5, 1.5, D).astype(np.float32)
    params["batch_norm"]["bias"] = rng.normal(scale=0.1, size=D).astype(np.float32)
    stats = {"batch_norm": {"mean": rng.normal(scale=0.1, size=D).astype(np.float32),
                            "var": rng.uniform(0.5, 2.0, D).astype(np.float32)}}
    return model, params, stats


def _port_model(params, stats, layers):
    model = ChromeRNN(nfeat=D, nclass=NCLASS, dropout=0.0, layers=layers)
    model.load_state_dict(chromernn_state_dict(params, stats))
    return model


def _close(got, want, what):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= TOL * np.abs(want).max(), (what, err, np.abs(want).max())


@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("skip_head", [False, True])
def test_forward_matches_jax(layers, train, skip_head):
    """Eval and train mode (batch statistics over the valid rows, and the
    running statistics after), with and without the head."""
    jmodel, params, stats = _jax_state(layers)
    tg, jg = _graphs()
    x = _inputs()
    kwargs = dict(train=train, skip_head=skip_head)
    if train:
        ref, updates = jmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), jg,
                                    mutable=["batch_stats"], **kwargs)
    else:
        ref = jmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), jg, **kwargs)
    model = _port_model(params, stats, layers)
    with torch.no_grad():
        ours = model(torch.as_tensor(x), tg, **kwargs)
    np.testing.assert_array_equal(ours[0].numpy(), x)  # x_in comes back as it went in
    assert ours[2] == (None, None) and ref[2] == (None, None)
    assert ours[1].shape == (N_PAD, D if skip_head else NCLASS)
    _close(ours[1].numpy(), ref[1], "output")
    if train:
        bn = model.batch_norm
        _close(bn.running_mean.numpy(), updates["batch_stats"]["batch_norm"]["mean"], "mean")
        _close(bn.running_var.numpy(), updates["batch_stats"]["batch_norm"]["var"], "var")


def test_converter_direction_order():
    """The cells map fwd0, bwd0, fwd1, bwd1: the layers' ``_l0`` and
    ``_l0_reverse`` weights. Swapping a layer's two directions still gives
    finite, plausible outputs, which eval-mode parity tells apart."""
    jmodel, params, stats = _jax_state(2)
    tg, jg = _graphs()
    x = _inputs()
    ref = np.asarray(jmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), jg,
                                  train=False)[1])
    state = chromernn_state_dict(params, stats)
    assert {k for k in state if k.startswith("rnn.")} == {
        f"rnn.{i}.{w}_{s}" for i in range(2) for s in ("l0", "l0_reverse")
        for w in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")}
    swapped = dict(state)
    for key in [k for k in state if k.startswith("rnn.1.") and not k.endswith("_reverse")]:
        swapped[key], swapped[key + "_reverse"] = state[key + "_reverse"], state[key]
    model = ChromeRNN(nfeat=D, nclass=NCLASS, dropout=0.0, layers=2)
    for sd, same in ((state, True), (swapped, False)):
        model.load_state_dict(sd)
        with torch.no_grad():
            got = model(torch.as_tensor(x), tg, train=False)[1].numpy()
        assert np.isfinite(got).all()
        err = np.abs(got - ref).max()
        assert bool(err <= TOL * np.abs(ref).max()) is same, err


def test_bucket_dependence_matches_jax():
    """The reverse direction reads the zero-padded suffix before the last
    valid window, so the valid rows' outputs depend on the padding, in both
    packages alike (reference behaviour, kept): 60 windows padded to 64 and
    to 128."""
    jmodel, params, stats = _jax_state(2)
    model = _port_model(params, stats, 2)
    n_valid = 60
    outs = {}
    for n_pad in (64, 128):
        tg, jg = _graphs(n_pad, n_valid)
        x = _inputs(n_pad, n_valid=n_valid)
        ref = np.asarray(jmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                                      jg, train=False)[1])[:n_valid]
        with torch.no_grad():
            ours = model(torch.as_tensor(x), tg, train=False)[1].numpy()[:n_valid]
        _close(ours, ref, f"pad {n_pad}")
        outs[n_pad] = (ours, ref)
    for k in (0, 1):
        gap = np.abs(outs[64][k] - outs[128][k]).max()
        assert gap > 100 * TOL * np.abs(outs[64][k]).max(), ("port", "jax")[k]


def _jax_loss_and_grads(jstate, x_f, x_r, jg, targets):
    """JAX's chrome_train_step loss (train/finetune.py:107-121) and its
    gradients, dropout 0."""
    def loss_fn(params):
        variables = {"params": params, "batch_stats": jstate.batch_stats}
        (_, h_f, _), upd = jstate.apply_fn(variables, x_f, jg, train=True, skip_head=True,
                                           mutable=["batch_stats"])
        variables = {"params": params, "batch_stats": upd["batch_stats"]}
        (_, h_r, _), upd = jstate.apply_fn(variables, x_r, jg, train=True, skip_head=True,
                                           mutable=["batch_stats"])
        pred = (h_f + h_r) / 2.0 @ params["out"]["kernel"] + params["out"]["bias"]
        return jax_bce(pred, targets, jg.node_mask)

    return jax.value_and_grad(loss_fn)(jstate.params)


def test_train_step_matches_jax():
    """One chrome_train_step (two strands, SGD): the loss and every
    gradient as JAX's, then the loss and parameters after a second step
    of both packages' real steps."""
    jmodel = JaxChromeRNN(nfeat=D, nclass=NCLASS, dropout=0.0, layers=2)
    jstate = jft.create_chrome_state(jmodel, jax_make_optimizer("sgd", 0.1),
                                     jax.random.PRNGKey(0), nfeat=D)
    tg, jg = _graphs()
    x_f, x_r = _inputs(seed=2), _inputs(seed=3)
    targets = (np.random.default_rng(4).random((N_PAD, NCLASS)) < 0.3).astype(np.float32)
    ref_loss, ref_grads = _jax_loss_and_grads(jstate, jnp.asarray(x_f), jnp.asarray(x_r), jg,
                                              jnp.asarray(targets))
    state = tft.create_chrome_state(make_chrome_model("rnn", nclass=NCLASS, dropout=0.0, nfeat=D),
                                    "sgd", 0.1, device=CPU)
    state.model.load_state_dict(chromernn_state_dict(jax.device_get(jstate.params),
                                                     jax.device_get(jstate.batch_stats)))
    _, loss, probs = tft.chrome_train_step(state, x_f, x_r, tg, targets, device=CPU)
    assert abs(loss.item() - float(ref_loss)) <= 1e-6 * float(ref_loss)
    assert probs.shape == (N_PAD, NCLASS)
    grads = chromernn_state_dict(jax.device_get(ref_grads), jax.device_get(jstate.batch_stats))
    for name, p in state.model.named_parameters():
        if name.split(".")[-1].startswith("bias_hh"):
            # flax's cell has one bias per gate: the converter puts it in
            # bias_ih, and bias_hh stays zero, out of training
            assert p.grad is None and not p.requires_grad and not p.any(), name
            continue
        _close(p.grad.numpy(), grads[name].numpy(), name)

    jstate, jloss, _ = jft.chrome_train_step(jstate, jnp.asarray(x_f), jnp.asarray(x_r), jg,
                                             jnp.asarray(targets), jax.random.PRNGKey(0))
    jstate, jloss, _ = jft.chrome_train_step(jstate, jnp.asarray(x_f), jnp.asarray(x_r), jg,
                                             jnp.asarray(targets), jax.random.PRNGKey(1))
    _, loss, _ = tft.chrome_train_step(state, x_f, x_r, tg, targets, device=CPU)
    assert abs(loss.item() - float(jloss)) <= 1e-5 * float(jloss)
    after = chromernn_state_dict(jax.device_get(jstate.params), jax.device_get(jstate.batch_stats))
    ours = state.model.state_dict()
    for name, want in after.items():
        _close(ours[name].numpy(), want.numpy(), name)

    loss, probs = tft.chrome_eval_step(state, x_f, x_r, tg, targets, device=CPU)
    jloss, jprobs = jft.chrome_eval_step(jstate, jnp.asarray(x_f), jnp.asarray(x_r), jg,
                                         jnp.asarray(targets))
    assert abs(loss.item() - float(jloss)) <= 1e-5 * float(jloss)
    _close(probs.numpy(), jprobs, "eval probs")


def test_make_chrome_model_rnn_layers_and_init():
    """3 layers match JAX's in eval mode; flax's initial distributions
    (orthogonal recurrent kernels per gate, zero biases, lecun-normal head);
    on the CPU lstm_forward is the LSTM's own call."""
    jmodel, params, stats = _jax_state(3)
    tg, jg = _graphs()
    ref = jmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(_inputs()), jg,
                       train=False)[1]
    model = make_chrome_model("rnn", nclass=NCLASS, nfeat=D, layers=3, dropout=0.0)
    model.load_state_dict(chromernn_state_dict(params, stats))
    with torch.no_grad():
        _close(model(torch.as_tensor(_inputs()), tg, train=False)[1].numpy(), ref, "3 layers")
    assert isinstance(model, ChromeRNN) and len(model.rnn) == 3
    model.reset_parameters(torch.Generator().manual_seed(0))
    h = D // 2
    for lstm in model.rnn:
        assert lstm.input_size == D and lstm.hidden_size == h and lstm.bidirectional
        for name, p in lstm.named_parameters():
            if name.startswith("bias"):
                assert not p.any() and p.requires_grad == name.startswith("bias_ih")
            elif name.startswith("weight_hh"):
                for k in range(4):
                    block = p.detach()[k * h:(k + 1) * h]
                    torch.testing.assert_close(block @ block.T, torch.eye(h), atol=1e-5, rtol=0)
        x = torch.randn(1, 7, D)
        torch.testing.assert_close(lstm_forward(lstm, x), lstm(x)[0], rtol=0, atol=0)
    assert not model.out.bias.any()
    graph = tsp.build_chrom_graph("none", n_valid=N_VALID, n_pad=N_PAD, device=CPU)
    with torch.no_grad():
        out = model(torch.as_tensor(_inputs()), graph, train=False)[1]
    assert out.shape == (N_PAD, NCLASS) and torch.isfinite(out).all()
