"""``models/chrome.py:lstm_segments``: a single-layer LSTM run over its
sequence in segments, each direction's (h, c) carried from one to the next,
against the whole sequence in one call, on the CPU. On the card
``lstm_forward`` takes this route for sequences longer than cuDNN's RNN
accepts (``CUDNN_MAX_STEPS``)."""

import pytest
import torch

from chromegcn_tpu_torch.models.chrome import CUDNN_MAX_STEPS, lstm_segments


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("bidirectional", [True, False], ids=["bidirectional", "forward"])
@pytest.mark.parametrize("batch,length,most", [(1, 350, 100), (2, 300, 100), (1, 64, 64)])
def test_segments_equal_one_call(bidirectional, batch, length, most):
    gen = torch.Generator().manual_seed(length + batch)
    lstm = torch.nn.LSTM(16, 8, batch_first=True, bidirectional=bidirectional).double()
    with torch.no_grad():
        for p in lstm.parameters():
            p.normal_(0.0, 0.3, generator=gen)
    x = torch.randn(batch, length, 16, dtype=torch.float64, generator=gen, requires_grad=True)
    whole, parts = lstm(x)[0], lstm_segments(lstm, x, most)
    assert parts.shape == whole.shape
    torch.testing.assert_close(parts, whole, rtol=0, atol=1e-13)
    params = [x] + list(lstm.parameters())
    for a, b in zip(torch.autograd.grad(whole.square().sum(), params),
                    torch.autograd.grad(parts.square().sum(), params)):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-12)


def test_a_deep_lstm_is_refused():
    lstm = torch.nn.LSTM(4, 2, num_layers=2, batch_first=True)
    with pytest.raises(ValueError, match="single-layer"):
        lstm_segments(lstm, torch.zeros(1, 10, 4), 5)


def test_chr1_runs_in_segments_cudnn_takes():
    # chr1's 146,032 windows pad to 147,456 rows: more than one call takes
    assert 147_456 > CUDNN_MAX_STEPS >= 50_176
