"""Guards of the PyTorch/CUDA port: it imports nothing of JAX or of the JAX
package, and its entry points default to the card instead of carrying on
on the CPU."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from chromegcn_tpu_torch import resolve_device
from chromegcn_tpu_torch.config import Config
from chromegcn_tpu_torch.data.synthetic import make_window_dataset
from chromegcn_tpu_torch.main import main
from chromegcn_tpu_torch.models.chrome import make_chrome_model
from chromegcn_tpu_torch.models.window import make_window_model
from chromegcn_tpu_torch.ops import sparse as tsp
from chromegcn_tpu_torch.ops.seq import complement_permutation
from chromegcn_tpu_torch.ops.spmm_bsr import attach_bsr
from chromegcn_tpu_torch.train import finetune as tft
from chromegcn_tpu_torch.train import pretrain as tpt
from chromegcn_tpu_torch.train.runner import run_finetune, run_pretrain

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "sklearn", "chromegcn_tpu")
PORT_FILES = sorted((ROOT / "chromegcn_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


@pytest.fixture
def no_cuda(monkeypatch):
    """A machine without a card, whatever this one has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_the_card(no_cuda, tmp_path):
    graph = tsp.build_chrom_graph("none", n_valid=128, device="cpu")
    model = make_chrome_model("gcn", nclass=4, nfeat=8)
    x = np.zeros((128, 8), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tft.create_chrome_state(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        attach_bsr(graph)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsp.build_chrom_graph("none", n_valid=128)
    state = tft.create_chrome_state(model, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tft.chrome_train_step(state, x, x, graph, np.zeros((128, 4), np.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tft.chrome_eval_step(state, x, x, graph, np.zeros((128, 4), np.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["-load_pretrained"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_finetune(Config())

    # the window stage
    wmodel = make_window_model("deepsea", 4, seq_length=200, d_model=8)
    ds = make_window_dataset({"chr1": 3}, n_targets=4, seq_length=200)
    splits = {"train": ds, "valid": ds, "test": ds}
    comp = torch.as_tensor(complement_permutation(ds.src_vocab))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpt.create_window_state(wmodel)
    wstate = tpt.create_window_state(wmodel, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpt.run_window_epoch(wstate, ds, comp, 2, train=False)
    assert tpt.run_window_epoch(wstate, ds, comp, 2, train=False, device="cpu")[1].shape == (3, 4)
    cfg = Config(results_dir=str(tmp_path), window_model="deepsea", seq_length=200, d_model=8,
                 batch_size=2, epochs=1, pretrain=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_pretrain(cfg, splits)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["-pretrain"])
    run_pretrain(cfg, splits, device="cpu", verbose=lambda *_: None)
    assert resolve_device("cpu") == torch.device("cpu")
