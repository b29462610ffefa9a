"""The port's window stage (data/constants, ops/seq, data/loader, artifact,
synthetic, models/window, models/strand, utils/convert) against the JAX
package's, on the CPU: the sequence ops, batches, dataset files and
synthetic worlds are equal; Expecto, DeepSEA and DanQ under
NonStrandSpecific agree with JAX in eval and train mode from the same
weights (carried over by ``window_state_dict``); the initial weights follow
flax's distributions."""

import functools

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chromegcn_tpu.data import artifact as jartifact
from chromegcn_tpu.data import constants as jconstants
from chromegcn_tpu.data import loader as jloader
from chromegcn_tpu.data import synthetic as jsynthetic
from chromegcn_tpu.models.strand import NonStrandSpecific as JaxNonStrandSpecific
from chromegcn_tpu.models.window import make_window_model as jax_make_window_model
from chromegcn_tpu.ops import seq as jseq
from chromegcn_tpu.train.optim import make_optimizer as jax_make_optimizer
from chromegcn_tpu.train.pretrain import create_window_state as jax_create_window_state
from chromegcn_tpu_torch.data import artifact as tartifact
from chromegcn_tpu_torch.data import constants as tconstants
from chromegcn_tpu_torch.data import loader as tloader
from chromegcn_tpu_torch.data import synthetic as tsynthetic
from chromegcn_tpu_torch.models.strand import NonStrandSpecific
from chromegcn_tpu_torch.models.window import make_window_model
from chromegcn_tpu_torch.ops import seq as tseq
from chromegcn_tpu_torch.utils.convert import window_state_dict

SEQ, NTARGETS = 400, 7
MODELS = ("expecto", "deepsea", "danq")
# the JAX golden tests' tolerance (tests/test_window_models.py:104): f32
# sums of ~10^4 products each, in another order
TOL = dict(rtol=1e-4, atol=1e-4)
VOCABS = {
    "canonical": dict(tconstants.SRC_VOCAB),
    "frequency_ordered": {"t": 0, "a": 1, "g": 2, "c": 3, "n": 4},  # the reference's kind
}


def test_constants_match_jax():
    for name in ("SRC_VOCAB", "SRC_VOCAB_SIZE", "COMPLEMENT", "VALID_CHROMS", "TEST_CHROMS",
                 "ALL_CHROMS", "TRAIN_CHROMS", "WINDOW_SIZE", "EXTENDED_WINDOW_SIZE"):
        assert getattr(tconstants, name) == getattr(jconstants, name), name


@pytest.mark.parametrize("vocab", VOCABS.values(), ids=VOCABS.keys())
def test_reverse_complement_matches_jax(vocab):
    perm = tseq.complement_permutation(vocab)
    np.testing.assert_array_equal(perm, jseq.complement_permutation(vocab))
    assert perm.dtype == np.int32
    tokens = np.random.default_rng(0).integers(0, 5, size=(3, 4, 50)).astype(np.int32)
    ours = tseq.reverse_complement(torch.as_tensor(tokens), torch.as_tensor(perm))
    ref = jseq.reverse_complement(jnp.asarray(tokens), jnp.asarray(perm))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    # twice is the identity
    np.testing.assert_array_equal(
        tseq.reverse_complement(ours, torch.as_tensor(perm)).numpy(), tokens)
    for seq in ("ACGTNacgtnXYZ", "ttttgggccaa"):
        np.testing.assert_array_equal(tseq.encode_sequence(seq, vocab),
                                      jseq.encode_sequence(seq, vocab))


def _batches_equal(ours, ref):
    ours, ref = list(ours), list(ref)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        for field in ("tokens", "targets", "row_mask", "indices"):
            x, y = getattr(a, field), getattr(b, field)
            assert x.dtype == y.dtype, field
            np.testing.assert_array_equal(x, y, err_msg=field)
    return ours


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_iterate_batches_matches_jax(shuffle, drop_last):
    """The same batches, the tail padded with copies of row 0 (row_mask
    False, index 0) unless dropped."""
    ds_t = tsynthetic.make_window_dataset({"chr1": 7, "chr2": 6}, n_targets=3, seq_length=30)
    ds_j = jsynthetic.make_window_dataset({"chr1": 7, "chr2": 6}, n_targets=3, seq_length=30)
    batches = _batches_equal(
        tloader.iterate_batches(ds_t, 4, shuffle, np.random.default_rng(5), drop_last),
        jloader.iterate_batches(ds_j, 4, shuffle, np.random.default_rng(5), drop_last))
    assert len(batches) == (3 if drop_last else 4)
    if not drop_last:
        tail = batches[-1]
        assert tail.row_mask.tolist() == [True, False, False, False]
        np.testing.assert_array_equal(tail.indices[1:], 0)
        np.testing.assert_array_equal(tail.tokens[1:], ds_t.tokens[[0, 0, 0]])


def test_make_window_dataset_matches_jax():
    args = ({"chr2": 9, "chr10": 5}, 11, 60, 3, "K562")
    ours, ref = tsynthetic.make_window_dataset(*args), jsynthetic.make_window_dataset(*args)
    for field in ("tokens", "targets", "chroms", "starts"):
        np.testing.assert_array_equal(getattr(ours, field), getattr(ref, field), err_msg=field)
        assert getattr(ours, field).dtype == getattr(ref, field).dtype, field
    assert ours.src_vocab == ref.src_vocab and ours.tgt_vocab == ref.tgt_vocab
    assert ours.chrom_order() == ref.chrom_order() == ["chr2", "chr10"]
    for n in (1, 2, 7, 919):
        assert (tsynthetic.encode_style_label_names(n)
                == jsynthetic.encode_style_label_names(n))


def test_dataset_files_interchange(tmp_path):
    """A dataset file written by either package loads in the other."""
    splits = {s: tsynthetic.make_window_dataset({c: n}, n_targets=4, seq_length=40, seed=i)
              for i, (s, c, n) in enumerate((("train", "chr11_gl000202_random", 6),
                                             ("valid", "chr3", 4), ("test", "chr1", 5)))}
    for saver, loader in ((tartifact, jartifact), (jartifact, tartifact)):
        path = str(tmp_path / f"dataset_{saver is tartifact}.npz")
        saver.save_dataset(path, splits)
        back = loader.load_dataset(path)
        assert set(back) == set(splits)
        for split, ds in splits.items():
            for field in ("tokens", "targets", "chroms", "starts"):
                np.testing.assert_array_equal(getattr(back[split], field), getattr(ds, field))
            assert back[split].src_vocab == ds.src_vocab
            assert back[split].tgt_vocab == ds.tgt_vocab


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_init(name, seq=SEQ, d_model=16):
    """JAX's initial NonStrandSpecific state (an eager init takes seconds,
    so each model's is made once)."""
    model = jax_make_window_model(name, NTARGETS, seq_length=seq, d_model=d_model)
    state = jax_create_window_state(model, jax_make_optimizer("adam", 1e-3),
                                    jax.random.PRNGKey(0), seq, dict(tconstants.SRC_VOCAB))
    return model, jax.device_get(state.params), jax.device_get(state.batch_stats)


def jax_window_state(name, seed=0, seq=SEQ, d_model=16):
    """JAX's initial NonStrandSpecific state, with BatchNorm's scale, bias and
    running stats moved off their identity values (drawn from ``seed``) so
    eval mode tests them."""
    model, params, stats = _jax_init(name, seq, d_model)
    params = jax.tree_util.tree_map(np.array, params)
    stats = jax.tree_util.tree_map(np.array, stats)
    rng = np.random.default_rng(seed)
    for bn, s in stats.get("model", {}).items():
        s["mean"] = rng.normal(0.0, 0.5, s["mean"].shape).astype(np.float32)
        s["var"] = rng.uniform(0.5, 2.0, s["var"].shape).astype(np.float32)
        p = params["model"][bn]
        p["scale"] = rng.uniform(0.5, 1.5, p["scale"].shape).astype(np.float32)
        p["bias"] = rng.normal(0.0, 0.2, p["bias"].shape).astype(np.float32)
    return model, params, stats


def port_model(name, params, stats, seq=SEQ, d_model=16):
    model = NonStrandSpecific(make_window_model(name, NTARGETS, seq_length=seq, d_model=d_model))
    model.load_state_dict(window_state_dict(params, stats))
    return model


def no_dropout(model):
    """p = 0 on every nn.Dropout and on the LSTM (the rates are the
    architecture's, so no flag turns them off)."""
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
        elif isinstance(m, torch.nn.LSTM):
            m.dropout = 0.0
    return model


@pytest.fixture
def jax_no_dropout(monkeypatch):
    """flax's Dropout as the identity, inside the test only; JAX's trace
    caches are cleared on both sides, so no compiled step keeps either
    behaviour."""
    jax.clear_caches()
    monkeypatch.setattr(flax_nn.Dropout, "__call__", lambda self, x, *a, **k: x)
    yield
    monkeypatch.undo()
    jax.clear_caches()


def _tokens(seed, b=3, seq=SEQ):
    return np.random.default_rng(seed).integers(0, 5, size=(b, seq)).astype(np.int32)


def _comp():
    return tseq.complement_permutation(tconstants.SRC_VOCAB)


@pytest.mark.parametrize("name", MODELS)
def test_window_model_eval_matches_jax(name):
    """NonStrandSpecific's (x_fwd, x_rev, mean logits) in eval mode, from the
    same weights: the flatten permutation, the conv and LSTM layouts and the
    running-stat BatchNorm all enter."""
    jmodel, params, stats = jax_window_state(name, seed=1)
    tokens = _tokens(2)
    ref = JaxNonStrandSpecific(model=jmodel).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(tokens),
        jnp.asarray(_comp()), train=False)
    model = port_model(name, params, stats).eval()
    with torch.no_grad():
        ours = model(torch.as_tensor(tokens), torch.as_tensor(_comp()))
    for what, a, b in zip(("x_fwd", "x_rev", "logits"), ours, ref):
        assert a.shape == b.shape, what
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=what, **TOL)
    assert ours[0].shape == (3, 925 if name == "danq" else 16)


@pytest.mark.parametrize("name", MODELS)
def test_window_model_train_matches_jax(name, jax_no_dropout):
    """Train mode, dropout out on both sides: batch statistics over the 2B
    strand batch, and the BatchNorm running stats after one call."""
    jmodel, params, stats = jax_window_state(name, seed=3)
    tokens = _tokens(4, b=4)
    (ref, updates) = JaxNonStrandSpecific(model=jmodel).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(tokens),
        jnp.asarray(_comp()), train=True, mutable=["batch_stats"],
        rngs={"dropout": jax.random.PRNGKey(0)})
    model = no_dropout(port_model(name, params, stats)).train()
    with torch.no_grad():
        ours = model(torch.as_tensor(tokens), torch.as_tensor(_comp()))
    for what, a, b in zip(("x_fwd", "x_rev", "logits"), ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=what, **TOL)
    after = window_state_dict(params, jax.tree_util.tree_map(np.asarray, updates["batch_stats"]))
    state = model.state_dict()
    running = [k for k in after if "running" in k]
    assert len(running) == {"expecto": 8, "deepsea": 0, "danq": 0}[name]
    for key in running:
        np.testing.assert_allclose(state[key].numpy(), after[key].numpy(), err_msg=key, **TOL)


def _samples(name, reps):
    """Every weight of ``reps`` fresh initializations, by parameter name."""
    model = make_window_model(name, NTARGETS, seq_length=SEQ, d_model=16)
    out = {}
    for seed in range(reps):
        model.reset_parameters(torch.Generator().manual_seed(seed))
        for key, p in model.named_parameters():
            out.setdefault(key, []).append(p.detach().flatten().clone())
    return model, {k: torch.cat(v) for k, v in out.items()}


@pytest.mark.parametrize("name", MODELS)
def test_init_follows_flax_distributions(name):
    """lecun-normal kernels (std sqrt(1/fan_in), cut at 2 of the untruncated
    std), zero biases, the embedding's normal (std sqrt(1/5)), orthogonal
    recurrent kernels per gate, BatchNorm at identity; each std within 10%
    of its rule, pooled over 4 initializations."""
    model, samples = _samples(name, reps=4)
    params = dict(model.named_parameters())
    for key, values in samples.items():
        p = params[key]
        if key.endswith("embed.weight"):
            rule = (1.0 / 5) ** 0.5
        elif "bias" in key:
            assert torch.count_nonzero(values) == 0, key
            continue
        elif key.startswith(("bn", "head_bn")):
            assert torch.all(values == 1.0), key
            continue
        elif "weight_hh" in key:
            h = p.shape[1]
            for k in range(4):
                block = p.detach()[k * h:(k + 1) * h]
                torch.testing.assert_close(block @ block.T, torch.eye(h), atol=1e-4, rtol=0)
            continue
        else:  # conv, linear and LSTM input kernels
            fan_in = p.shape[1] if "weight_ih" in key else p[0].numel()
            rule = (1.0 / fan_in) ** 0.5
            assert values.abs().max() <= 2 * rule / 0.87962566103423978 + 1e-6, key
        std = values.std().item()
        assert abs(std / rule - 1) < 0.1, (key, std, rule)
