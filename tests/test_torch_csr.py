"""Port parity: the edge form (CSR) that each direction of the port's
block-sparse operator carries (chromegcn_tpu_torch.ops.spmm_bsr), which the
card's kernels B1, B2 and B3 gather over.

The edge form is held against its own blocks, bit for bit, and its product
against the JAX package's spmm_pallas, whose Pallas kernel runs in interpret
mode on the CPU. The kernels themselves are held against the plain versions
on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chromegcn_tpu.ops import sparse as jsp
from chromegcn_tpu.ops import spmm_pallas as jbsr
from chromegcn_tpu_torch.data.synthetic import make_hic_edges
from chromegcn_tpu_torch.ops import gcn_fused as tfused
from chromegcn_tpu_torch.ops import sparse as tsp
from chromegcn_tpu_torch.ops import spmm_bsr as tbsr

CPU = "cpu"
N = 1024
N_PAD_ROWS = 24  # the Hi-C graphs' padding rows, past n_valid


def _graphs(kind, n=N):
    """(port graph, JAX graph) built from the same arrays: a Hi-C graph
    (``hub``: hubness 0.5, long rows) or a random dense one."""
    if kind in ("hic", "hub"):
        edges = make_hic_edges(n - N_PAD_ROWS, 4 * n, seed=7,
                               hubness=0.5 if kind == "hub" else 0.0)
        kw = dict(n_valid=n - N_PAD_ROWS, n_pad=n, hic_edges=edges)
        return tsp.build_chrom_graph("hic", device=CPU, **kw), jsp.build_chrom_graph("hic", **kw)
    rng = np.random.default_rng(n)
    dense = (rng.random((n, n)) < 0.03).astype(np.float32)
    dense *= rng.random((n, n)).astype(np.float32)
    np.fill_diagonal(dense, 1.0)
    return tsp.from_dense(dense, device=CPU), jsp.from_dense(dense)


def _bits(t):
    """A dense tensor's bit patterns, for an exact comparison."""
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _csr_dense(m):
    rows = torch.repeat_interleave(torch.arange(m.n_rows), m.row_ptr.diff().long())
    dense = torch.zeros((m.n_rows, m.n_cols), dtype=m.val.dtype)
    dense[rows, m.col.long()] = m.val
    return dense


def _blocks_dense(m):
    dense = torch.zeros((m.n_rows, m.n_cols), dtype=m.tiles.dtype)
    for blocks, rb, cb, height, count in ((m.tiles, m.tile_rb, m.tile_cb, m.tile_r, m.nt),
                                          (m.strips, m.strip_rb, m.strip_cb, tbsr.STRIP_R, m.ns)):
        rows = rb[:count, None, None].long() * height + torch.arange(height)[None, :, None]
        cols = cb[:count, None, None].long() * m.tile_c + torch.arange(m.tile_c)[None, None, :]
        dense[rows, cols] = blocks[:count]
    return dense


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("min_edges", ["auto", 8, 10**9])  # 10**9: every edge in a strip
@pytest.mark.parametrize("tile", [32, 64, 128, 256])
@pytest.mark.parametrize("kind", ["hic", "dense"])
def test_csr_densified_equals_blocks(kind, tile, min_edges, dtype):
    tg, _ = _graphs(kind)
    op = tbsr.bsr_from_graph(tg, tile, min_edges, dtype, device=CPU)
    for direction in ("fwd", "bwd"):
        m = getattr(op, direction)
        assert m.val.dtype == m.tiles.dtype and m.col.dtype == m.row_ptr.dtype == torch.int32
        csr, blocks = _csr_dense(m), _blocks_dense(m)
        assert torch.equal(_bits(csr), _bits(blocks)), direction
        assert m.nnz == int(torch.count_nonzero(m.tiles)) + int(torch.count_nonzero(m.strips))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tile,min_edges", [(128, "auto"), (32, 8), (256, 10**9)])
@pytest.mark.parametrize("kind", ["hic", "hub"])
def test_csr_rows_ascend_and_padding_rows_are_empty(kind, tile, min_edges, dtype):
    tg, _ = _graphs(kind)
    op = tbsr.bsr_from_graph(tg, tile, min_edges, dtype, device=CPU)
    for direction in ("fwd", "bwd"):
        m = getattr(op, direction)
        ptr = m.row_ptr.numpy()
        assert len(ptr) == m.n_rows + 1 and ptr[0] == 0 and ptr[-1] == m.nnz
        assert (np.diff(ptr) >= 0).all()
        col = m.col.numpy()
        for i in range(m.n_rows):
            assert (np.diff(col[ptr[i]:ptr[i + 1]]) > 0).all(), (direction, i)
        assert ((col >= 0) & (col < m.n_cols)).all()
        assert (ptr[m.n_rows - N_PAD_ROWS:] == m.nnz).all(), "padding rows hold entries"
    if kind == "hub":  # hubs give long rows: several batches of 32 in the kernels
        assert int(op.fwd.row_ptr.diff().max()) > 32


@pytest.mark.parametrize("kind,d,dtype", [
    ("hic", 32, "float32"),
    ("hub", 128, "float32"),
    ("dense", 64, "float32"),
    ("hic", 128, "bfloat16"),
    ("hub", 32, "bfloat16"),
])
def test_csr_product_matches_jax(kind, d, dtype):
    """A @ x over the edge form (a test-only torch.sparse_csr_tensor product:
    bf16 values and x rounded to bf16, summed in f32) against JAX
    spmm_pallas on the same numpy inputs, both directions."""
    tg, jg = _graphs(kind, n=N if kind != "dense" else 512)
    op = tbsr.bsr_from_graph(tg, dtype=dtype, device=CPU)
    jop = jbsr.bsr_from_graph(jg, dtype=dtype)
    x = np.random.default_rng(d).normal(size=(tg.n_nodes, d)).astype(np.float32)
    xt = torch.from_numpy(x)
    if dtype == "bfloat16":
        xt = xt.to(torch.bfloat16).float()
    for direction, jm in (("fwd", jop), ("bwd", jbsr.BSROperator(fwd=jop.bwd, bwd=jop.fwd))):
        m = getattr(op, direction)
        a = torch.sparse_csr_tensor(m.row_ptr.long(), m.col.long(), m.val.float(),
                                    (m.n_rows, m.n_cols), check_invariants=True)
        ref = np.asarray(jbsr.spmm_pallas(jm, jnp.asarray(x)))
        # 1e-5: f32 sums of the same products in another order
        np.testing.assert_allclose((a @ xt).numpy(), ref, rtol=1e-5, atol=1e-5, err_msg=direction)


def test_to_carries_the_edge_form():
    tg, _ = _graphs("hic", n=512)
    op = tbsr.bsr_from_graph(tg, dtype="bfloat16", device=CPU)
    moved = op.to("meta")
    for direction in ("fwd", "bwd"):
        m, mm = getattr(op, direction), getattr(moved, direction)
        for name in ("row_ptr", "col", "val"):
            a, b = getattr(m, name), getattr(mm, name)
            assert b.device.type == "meta" and b.shape == a.shape and b.dtype == a.dtype, name
        assert mm.nnz == m.nnz
    back = op.to(CPU)
    for name in ("row_ptr", "col", "val"):
        assert torch.equal(getattr(back.fwd, name), getattr(op.fwd, name))


def test_edge_form_checks_of_the_kernel_wrappers():
    """What the wrappers check before a launch, on tensors of any device."""
    tg, _ = _graphs("hic", n=512)
    m = tbsr.bsr_from_graph(tg, device=CPU).fwd
    x = torch.zeros((512, 32))
    assert tbsr._check_csr(m, x) == 32
    # B1 takes any width; the multiple-of-4 rule is the fused kernels' alone
    assert tbsr._check_csr(m, torch.zeros((512, 30))) == 30
    with pytest.raises(ValueError, match="multiple of 4"):
        tfused._check_fused_csr(m, torch.zeros((512, 30)), tfused.fwd_smem_bytes, "B2")
    with pytest.raises(ValueError, match="d >= 1"):
        tbsr._check_csr(m, torch.zeros((512, 0)))
    with pytest.raises(ValueError, match="columns"):
        tbsr._check_csr(m, torch.zeros((256, 32)))
    with pytest.raises(ValueError, match="edge form"):
        tbsr._check_csr(tbsr.dataclasses.replace(m, val=m.val.to(torch.float16)), x)
    with pytest.raises(ValueError, match="edge form"):
        tbsr._check_csr(tbsr.dataclasses.replace(m, row_ptr=m.row_ptr[:-1]), x)
    with pytest.raises(ValueError, match="contiguous"):
        tbsr._check_csr(m, torch.zeros((32, 512)).T)


@pytest.mark.parametrize("rows", [64, 32, 16])
def test_bwd_plan_fits_every_width_the_fused_layer_admits(rows):
    """B2 and B3 read no tiles: each width takes R rows of h a CTA (64, 32
    or 16), and both plans (the rows of h and two W chunks) must fit at every
    width of R's range that fused_fits admits (csrc/gather_mma.cuh;
    gcn_fused_smem_bytes and gcn_fused_bwd_smem_bytes agree on the card:
    chip_smoke.py)."""
    op = tbsr.bsr_from_graph(_graphs("hic", n=512)[0], device=CPU)
    widths = [d for d in range(4, 4097, 4) if tfused.rows_per_cta(d) == rows]
    admitted = [d for d in widths if tfused.fused_fits(op, d)]
    assert admitted and admitted == widths[:len(admitted)]
    for d in admitted:
        assert max(tfused.fwd_smem_bytes(d), tfused.bwd_smem_bytes(d)) <= tfused.SMEM_LIMIT, d
    assert (admitted[0], admitted[-1]) == {64: (4, 256), 32: (260, 640), 16: (644, 3328)}[rows]
    assert tfused.bwd_smem_bytes(128) == 4 * (64 * (128 + 4) + 2 * 64 * (32 + 4))
    assert tfused.bwd_smem_bytes(30) == tfused.bwd_smem_bytes(32)  # k padded to 32
