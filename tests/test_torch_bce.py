"""The masked BCE's kernels (``ops/bce_fused.py`` over ``csrc/bce_fused.cu``)
against their plain versions, on the card: the loss's masked sum and its
closed-form gradient at full chr1 and at ragged shapes, through
``train/loss.py:bce_with_logits`` with every target dtype.

Tolerances, each from the f32 arithmetic:
- the sum against the plain formula in float64: every term is non-negative
  and carries a few f32 roundings (expf, log1pf and three operations, each
  within 2 ulp), and the kernel sums in float64, so the sum stays within
  1e-6 of its size (~17 ulp);
- the gradient against the plain closed form in f32 on the card: the two
  round sigmoid differently for x < 0 (e / (1 + e) against torch's
  1 / (1 + exp(-x))), a few ulp of a value at most 1, times |g m|: 1e-6 of
  |g|.

Imports no JAX. On the card's machine, which has no JAX (tests/conftest.py
imports it), run it without the conftest: ``python -m pytest --noconftest
-q -s tests/test_torch_bce.py``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chromegcn_tpu_torch.ops import _build
from chromegcn_tpu_torch.ops.bce_fused import (
    BCESum, bce_grad_plain, bce_sum, bce_sum_bwd, bce_sum_plain,
)
from chromegcn_tpu_torch.train.loss import bce_with_logits

FULL = (249_856, 919)    # the hub cell's N_PAD and labels
FULL_VALID = 249_088     # chr1's windows at 1 kb
SHAPES = [(1, 919), (63, 919), (2_049, 919), (1, 1), (63, 1), (2_049, 1)]
SUM_RTOL = 1e-6
GRAD_ATOL = 1e-6         # of |g|


card = pytest.mark.skipif(not torch.cuda.is_available(),
                          reason="needs a CUDA card: torch.cuda.is_available() is False")
CUDA = torch.device("cuda")


def inputs(n, l, valid, device, seed=0):
    """Logits N(0, 3^2) with exact zeros and saturating values, 5% positive
    f32 targets and a row mask of ``valid`` leading rows (numpy, so the draws
    do not depend on the device)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, l), dtype=np.float32) * 3).ravel()
    x[::97] = 0.0
    x[1::89] = 60.0
    x[2::83] = -60.0
    z = (rng.random((n, l)) < 0.05).astype(np.float32)
    m = (np.arange(n) < valid).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (x.reshape(n, l), z, m))


def valid_rows(n, mask):
    return {"all": n, "none": 0, "tail": n - n // 4}[mask]


def assert_sum_close(num, x, z, m):
    ref = float(bce_sum_plain(x.double(), z.double(), m.double()))
    assert abs(float(num) - ref) <= SUM_RTOL * abs(ref), (float(num), ref)


@card
@pytest.mark.parametrize("mask", ["all", "none", "tail"])
@pytest.mark.parametrize("shape", SHAPES, ids=[f"{n}x{l}" for n, l in SHAPES])
def test_the_kernels_match_the_plain_version(shape, mask):
    x, z, m = inputs(*shape, valid_rows(shape[0], mask), CUDA, seed=shape[0] + shape[1])
    num = bce_sum(x, z, m)
    assert num.dtype == torch.float32 and num.shape == ()
    assert_sum_close(num, x, z, m)
    if mask == "none":
        assert float(num) == 0.0
    g = torch.tensor(-0.37, device=CUDA)
    dx = bce_sum_bwd(x, z, m, g)
    torch.testing.assert_close(dx, bce_grad_plain(x, z, m, g), rtol=0, atol=GRAD_ATOL * 0.37)
    if mask == "none":
        assert not dx.any()


@card
def test_a_misaligned_operand_takes_the_scalar_walk():
    """Logits one float past a 16-byte boundary: the scalar walk gives the
    same gradient bit for bit (the same arithmetic an element) and a sum as
    close to float64."""
    x, z, m = inputs(2_049, 919, 1_537, CUDA, seed=3)
    buf = torch.empty(x.numel() + 1, dtype=torch.float32, device=CUDA)
    shifted = buf[1:].view_as(x)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16 == 4
    assert_sum_close(bce_sum(shifted, z, m), x, z, m)
    g = torch.tensor(0.8, device=CUDA)
    assert torch.equal(bce_sum_bwd(shifted, z, m, g), bce_sum_bwd(x, z, m, g))


@card
@pytest.mark.parametrize("dtype", [torch.float32, torch.uint8, torch.bool],
                         ids=["f32", "u8", "bool"])
def test_the_loss_takes_the_kernels(dtype):
    """``bce_with_logits`` on the card: 2 sum launches and 1 gradient
    launch, no host sync, the mean of the float64 loss on the CPU, and under
    a cotangent of 2.5 the closed-form gradient of the mean."""
    n, l, valid = 2_049, 919, 1_537
    x, z, m = inputs(n, l, valid, CUDA, seed=5)
    targets, mask = z.to(dtype), m.bool()
    logits = x.clone().requires_grad_(True)
    before = dict(_build.LAUNCHES)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss = bce_with_logits(logits, targets, mask)
        (2.5 * loss).backward()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert _build.LAUNCHES["bce_sum"] - before.get("bce_sum", 0) == 2
    assert _build.LAUNCHES["bce_sum_bwd"] - before.get("bce_sum_bwd", 0) == 1
    ref = bce_with_logits(x.double().cpu(), targets.cpu(), mask.cpu())
    assert abs(float(loss.detach()) - float(ref)) <= SUM_RTOL * abs(float(ref))
    g = torch.tensor(2.5 / (valid * l), device=CUDA)
    torch.testing.assert_close(logits.grad, bce_grad_plain(x, z, m, g), rtol=0,
                               atol=GRAD_ATOL * float(g))


@card
def test_float64_on_the_card_takes_the_torch_formula():
    """Float64 logits on the card (chip_smoke.py's float64 train steps):
    the torch formula, no kernel launched, and under a cotangent of 2.5 the
    loss and its autograd gradient the CPU's within 1e-12 (the card's exp
    and log1p may round apart in the last bit). The yardstick is the same
    formula's autograd, not the closed form, which differs at x == 0."""
    n, l, valid = 2_049, 919, 1_537
    x, z, m = (t.double() for t in inputs(n, l, valid, CUDA, seed=7))
    before = dict(_build.LAUNCHES)
    losses, grads = [], []
    for device in (CUDA, torch.device("cpu")):
        logits = x.to(device, copy=True).requires_grad_(True)
        loss = bce_with_logits(logits, z.to(device), m.bool().to(device))
        (2.5 * loss).backward()
        assert loss.dtype == torch.float64
        losses.append(float(loss.detach()))
        grads.append(logits.grad.cpu())
    assert dict(_build.LAUNCHES) == before
    assert abs(losses[0] - losses[1]) <= 1e-12 * abs(losses[1])
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=1e-12 * 2.5 / (valid * l))


@card
def test_targets_that_want_a_gradient_are_refused():
    x, z, m = inputs(63, 919, 63, CUDA, seed=9)
    with pytest.raises(ValueError, match="no gradient"):
        bce_with_logits(x, z.requires_grad_(True), m.bool())


@card
def test_the_full_chromosome():
    """The hub cell's (249,856, 919) with chr1's 249,088 valid rows: the sum
    within 1e-6 of float64 and the same bits over 3 calls; the gradient
    under the mean's cotangent times 0.6. Prints each kernel's device time
    beside its bound (bytes at 3.35 TB/s), and the loss with its gradient
    through the kernels, the torch formula and the library's
    binary_cross_entropy_with_logits (row weights, a sum), all under
    autograd."""
    x, z, m = inputs(*FULL, FULL_VALID, CUDA, seed=11)
    sums = [bce_sum(x, z, m) for _ in range(3)]
    assert all(torch.equal(s, sums[0]) for s in sums[1:])
    assert_sum_close(sums[0], x, z, m)
    g = torch.tensor(0.6 / (FULL_VALID * FULL[1]), device=CUDA)
    dx = bce_sum_bwd(x, z, m, g)
    torch.testing.assert_close(dx, bce_grad_plain(x, z, m, g), rtol=0,
                               atol=GRAD_ATOL * float(g))
    del dx

    def with_grad(loss):
        def run():
            xg = x.detach().requires_grad_(True)
            loss(xg).backward(g)
        return run

    tensor_bytes = x.numel() * 4
    times = {
        "sum kernels": (lambda: bce_sum(x, z, m), 2 * tensor_bytes),
        "gradient kernel": (lambda: bce_sum_bwd(x, z, m, g), 3 * tensor_bytes),
        "kernels and autograd": (with_grad(lambda xg: BCESum.apply(xg, z, m)),
                                 5 * tensor_bytes),
        "plain sum and autograd": (with_grad(lambda xg: bce_sum_plain(xg, z, m)),
                                   5 * tensor_bytes),
        "library sum and autograd": (with_grad(lambda xg: F.binary_cross_entropy_with_logits(
            xg, z, weight=m[:, None], reduction="sum")), 5 * tensor_bytes),
    }
    for name, (fn, need) in times.items():
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            fn()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / 10
        bound = need / 3.35e12 * 1e3
        print(f"{name}: {ms:.4f} ms a call (CUDA events, 10 calls); bound {bound:.4f} ms "
              f"({need / 1e9:.2f} GB); {100 * bound / ms:.1f}% of it")
