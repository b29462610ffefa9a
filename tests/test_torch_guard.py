"""Guards of the PyTorch/CUDA port: it imports nothing of JAX or of the JAX
package (its parallel paths and the parallel tests' spawned ranks neither),
and its entry points default to the card instead of carrying on on the
CPU."""

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
# the port, its on-card smoke test, and the module the parallel tests'
# spawned ranks import afresh (tests/torch_parallel_workers.py)
PORT_FILES = sorted((ROOT / "chromegcn_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "torch_parallel_workers.py"]


# the one exception: t-SNE needs scikit-learn, which the function imports
# when it is called, and nothing else of the port needs
LAZY_ALLOWED = {("chromegcn_tpu_torch/analysis/saliency.py", "tsne_embeddings", "sklearn.manifold")}


def _imported_modules(path):
    """(module, the function that imports it or None) for every import."""
    tree = ast.parse(path.read_text(), filename=str(path))
    owner = {}
    for fn in ast.walk(tree):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for node in ast.walk(fn):
                owner.setdefault(node, fn.name)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from ((alias.name, owner.get(node)) for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module, owner.get(node)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    rel = str(path.relative_to(ROOT))
    bad = [m for m, fn in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN and (rel, fn, m) not in LAZY_ALLOWED]
    assert not bad, f"{path.name} imports {bad}"


def test_the_lazy_sklearn_import_is_inside_its_function():
    """The port's modules import with no scikit-learn: its one use is
    imported inside tsne_embeddings, where the guard above allows it."""
    for rel, fn, module in LAZY_ALLOWED:
        found = list(_imported_modules(ROOT / rel))
        assert (module, fn) in found and (module, None) not in found


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
