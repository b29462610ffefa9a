"""ChromeRNN's plain reference (``portbench/reference/rnn.py``) on the CPU in
float64: its BiLSTM and its hand-written backpropagation against
``torch.nn.LSTM``, its dependence on the padded rows, and its loss and first
gradients against the port's ``ChromeRNN`` step."""

import pytest
import torch

from portbench import harness
from portbench.loops import common, rnn_step
from portbench.reference import rnn, train

CPU = torch.device("cpu")
F64 = torch.float64


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def config():
    return harness.load_json("configs", "chromernn_gm12878")


def weights(cfg, seed):
    gen = torch.Generator().manual_seed(seed)
    w = common.make_weights(rnn.param_specs(cfg), gen, CPU)
    fixed = common.make_weights(rnn.fixed_specs(cfg), gen, CPU)
    return ({k: v.to(F64).requires_grad_() for k, v in w.items()},
            {k: v.to(F64) for k, v in fixed.items()})


def torch_lstm(cfg, w, fixed, layer):
    """``nn.LSTM`` holding layer ``layer``'s weights and both biases."""
    fan_in = cfg["nfeat"] if layer == 0 else 2 * cfg["hidden"]
    lstm = torch.nn.LSTM(fan_in, cfg["hidden"], batch_first=True, bidirectional=True).to(F64)
    with torch.no_grad():
        for name, p in lstm.named_parameters():
            p.copy_((w if name.startswith(("weight", "bias_ih")) else fixed)[
                f"rnn.{layer}.{name}"])
    return lstm


@pytest.mark.parametrize("chunk", [rnn.CHUNK, 60], ids=["one_chunk", "five_chunks"])
def test_the_bilstm_is_torchs_lstm(chunk):
    """Both layers over 300 positions of two strands: the outputs, and the
    gradients of the input and every weight, equal ``nn.LSTM``'s to 1e-12
    of their scale, whether the loops run in one chunk or in five."""
    cfg = config()
    w, fixed = weights(cfg, 1)
    x = torch.randn(300, 2, cfg["nfeat"], dtype=F64, generator=torch.Generator().manual_seed(2))
    x.requires_grad_()
    probe = torch.randn(300, 2, 2 * cfg["hidden"], dtype=F64,
                        generator=torch.Generator().manual_seed(3))
    for layer in range(cfg["layers"]):
        ours = rnn.bilstm(w, fixed, layer, x, chunk)
        lstm = torch_lstm(cfg, w, fixed, layer)
        theirs = lstm(x.transpose(0, 1))[0].transpose(0, 1)
        assert (ours - theirs).abs().max() <= 1e-12 * theirs.abs().max()
        names = [f"rnn.{layer}.{n}" for n, _ in lstm.named_parameters() if "bias_hh" not in n]
        g_ours = torch.autograd.grad((ours * probe).sum(), [x] + [w[n] for n in names])
        g_theirs = torch.autograd.grad(
            (theirs * probe).sum(), [x] + [p for n, p in lstm.named_parameters()
                                           if "bias_hh" not in n])
        for name, a, b in zip(["x"] + names, g_ours, g_theirs):
            assert (a - b).abs().max() <= 1e-12 * b.abs().max(), name
        x = theirs.detach().requires_grad_()


def test_valid_outputs_change_with_the_padding():
    """The reverse direction reads the padded zero rows first, so the valid
    rows' outputs change with N_pad while the forward direction's do not,
    as the program's (``tests/test_torch_rnn.py``)."""
    cfg = config()
    w, fixed = weights(cfg, 4)
    h, n_valid = cfg["hidden"], 200
    x = torch.zeros(264, 2, cfg["nfeat"], dtype=F64)
    x[:n_valid].normal_(generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        short, long = (rnn.bilstm(w, fixed, 0, x[:n])[:n_valid] for n in (232, 264))
    assert torch.equal(short[..., :h], long[..., :h])
    assert (short[..., h:] - long[..., h:]).abs().max() > 1e-6


def test_the_first_step_is_the_ports_in_float64(small_cell):
    """The loop's small cut: the port's ``chrome_train_step`` on a float64
    ChromeRNN with the benchmark's weights, inputs and dropout generator,
    against the reference's first step: the loss and every leaf's first
    gradient to 1e-10."""
    from chromegcn_tpu_torch.models.chrome import make_chrome_model
    from chromegcn_tpu_torch.train import finetune as ft

    cfg, traffic = small_cell("chromernn_step")
    session = harness.session_for(cfg, traffic, 2 ** 31 + 11, CPU)
    session.setup()
    graph = session.graph
    session.free()
    model = make_chrome_model("rnn", nclass=cfg["nclass"], dropout=cfg["dropout"],
                              layers=cfg["layers"], nfeat=cfg["nfeat"])
    state = ft.create_chrome_state(model, "sgd", cfg["optimizer"]["lr"], device=CPU)
    model.double()
    common.load_weights(model, {k: v.double() for k, v in session.weights.items()})
    held = dict(model.named_parameters())
    with torch.no_grad():
        for name, value in session.fixed.items():
            held[name].copy_(value)
    data = {k: v.double() for k, v in session.sets[0].items()}
    gen = torch.Generator().manual_seed(session.dropout_seed)
    loss = ft.chrome_train_step(state, data["x_f"], data["x_r"], graph, data["targets"], gen,
                                device=CPU)[1]
    ours = {"losses": [float(loss)], "grad1": common.first_gradients(model, state.optimizer)}
    ref = session.reference(F64)
    assert ours["losses"][0] == pytest.approx(ref["losses"][0], rel=1e-10)
    gaps = train.leaf_gaps(ours["grad1"], ref["grad1"], sorted(ref["grad1"]))
    assert max(gaps.values()) < 1e-10, gaps


def test_the_step_flops_by_hand():
    # d 4, H 2, 3 labels, 2 layers, N_pad 10, 8 valid: a position of a
    # direction 2 x 8 x (4 + 2) = 96 in layer 1, 2 x 8 x (4 + 2) = 96 in
    # layer 2 (its input is 2H = 4); x 3 x 2 directions x 10 positions each;
    # two strands; the head 3 x 2 x 8 x 4 x 3
    cfg = {"nfeat": 4, "hidden": 2, "layers": 2, "nclass": 3, "strands": 2}
    assert rnn_step.step_flops(cfg, 10, 8) == 2 * 2 * 96 * 3 * 2 * 10 + 3 * 2 * 8 * 4 * 3
