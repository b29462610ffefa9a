"""Port parity: the host BSR build and kernel B1's plain version
(chromegcn_tpu_torch.ops.spmm_bsr) against the JAX package's
ops/spmm_pallas.py, whose Pallas kernel runs in interpret mode on the CPU.

On the CPU the kernel wrapper takes the plain version; the CUDA kernel is
held against the same plain version on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chromegcn_tpu.ops import sparse as jsp
from chromegcn_tpu.ops import spmm_pallas as jbsr
from chromegcn_tpu_torch.data.synthetic import make_hic_edges
from chromegcn_tpu_torch.ops import _build
from chromegcn_tpu_torch.ops import sparse as tsp
from chromegcn_tpu_torch.ops import spmm_bsr as tbsr
from chromegcn_tpu_torch.ops.spmm import spmm, spmm_coo

CPU = "cpu"
FIELDS = ("tiles", "tile_rb", "tile_cb", "strips", "strip_rb", "strip_cb", "live")


def _dense_graph(n, density=0.03, seed=0):
    """The random dense graphs of tests/test_spmm_pallas.py."""
    rng = np.random.default_rng(seed)
    dense = (rng.random((n, n)) < density).astype(np.float32)
    dense *= rng.random((n, n)).astype(np.float32)
    np.fill_diagonal(dense, 1.0)
    return dense


def _graphs(kind, n=1024):
    """(port graph, JAX graph) built from the same arrays."""
    if kind == "hic":
        edges = make_hic_edges(n - 24, 4 * n, seed=7)
        kw = dict(n_valid=n - 24, n_pad=n, hic_edges=edges)
        return tsp.build_chrom_graph("hic", device=CPU, **kw), jsp.build_chrom_graph("hic", **kw)
    dense = _dense_graph(n, seed=n)
    return tsp.from_dense(dense, device=CPU), jsp.from_dense(dense)


def _as_bits(a):
    """Array for exact comparison: bf16 compared bit for bit."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


# (tile, min_edges_per_tile, dtype)
SPLITS = [
    (128, "auto", "float32"),
    (128, 8, "float32"),
    (256, 8, "float32"),
    (256, 10**9, "float32"),  # no tiles: every edge in a strip
    (128, "auto", "bfloat16"),
    (256, 4, "bfloat16"),
]


@pytest.mark.parametrize("kind", ["hic", "dense"])
@pytest.mark.parametrize("tile,min_edges,dtype", SPLITS)
def test_host_bsr_arrays_equal(kind, tile, min_edges, dtype):
    tg, jg = _graphs(kind)
    ours = tbsr.bsr_from_graph(tg, tile, min_edges, dtype, device=CPU)
    ref = jbsr.bsr_from_graph(jg, tile, min_edges, dtype)
    for direction in ("fwd", "bwd"):
        m, r = getattr(ours, direction), getattr(ref, direction)
        for name in FIELDS:
            a, b = _as_bits(getattr(m, name)), _as_bits(getattr(r, name))
            assert a.dtype == b.dtype, (direction, name, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=f"{direction}.{name}")
        assert (m.n_rows, m.n_cols, m.tile_r, m.tile_c) == (r.n_rows, r.n_cols, r.tile_r, r.tile_c)
    assert tbsr.streamed_elements(ours, d=96) == jbsr.streamed_elements(ref, d=96)


@pytest.mark.parametrize("tile,min_edges", [(128, "auto"), (256, 8), (128, 10**9)])
def test_row_pointers_cover_live_blocks(tile, min_edges):
    """The kernel's walk: each row block's live tiles and strips, padding never."""
    tg, _ = _graphs("hic")
    m = tbsr.bsr_from_graph(tg, tile, min_edges, device=CPU).fwd
    nrb = m.n_rows // m.tile_r
    tp, sp, order = m.tile_ptr.numpy(), m.strip_ptr.numpy(), m.strip_order.numpy()
    assert tp[0] == 0 and tp[-1] == m.nt and len(tp) == nrb + 1
    assert sp[0] == 0 and sp[-1] == m.ns and len(sp) == nrb + 1
    assert sorted(order.tolist()) == list(range(m.ns))
    rb, cb = m.tile_rb.numpy(), m.strip_cb.numpy()
    srb = m.strip_rb.numpy() // (m.tile_r // 8)
    for b in range(nrb):
        assert (rb[tp[b]:tp[b + 1]] == b).all()
        grp = order[sp[b]:sp[b + 1]]
        assert (srb[grp] == b).all()
        assert (np.diff(cb[grp]) >= 0).all()  # grouped by column block
    # the padding really is zero blocks past the live counts
    assert not m.tiles[m.nt:].any() and not m.strips[m.ns:].any()


def _jax_spmm(jop, x):
    return np.asarray(jbsr.spmm_pallas(jop, jnp.asarray(x)))


@pytest.mark.parametrize("kind,d,tile,min_edges", [
    ("hic", 32, 128, "auto"),
    ("hic", 128, 256, 8),
    ("dense", 64, 256, 8),
    ("dense", 128, 128, 10**9),
])
def test_bsr_forward_and_grad_match_jax(kind, d, tile, min_edges):
    tg, jg = _graphs(kind, n=1024 if kind == "hic" else 512)
    op = tbsr.bsr_from_graph(tg, tile, min_edges, device=CPU)
    jop = jbsr.bsr_from_graph(jg, tile, min_edges)
    rng = np.random.default_rng(d)
    x = rng.normal(size=(tg.n_nodes, d)).astype(np.float32)
    ct = rng.normal(size=(tg.n_nodes, d)).astype(np.float32)

    xt = torch.tensor(x, requires_grad=True)
    out = tbsr.spmm_bsr(op, xt)
    (out * torch.from_numpy(ct)).sum().backward()
    ref = _jax_spmm(jop, x)
    gref = jax.grad(lambda a: jnp.sum(jbsr.spmm_pallas(jop, a) * ct))(jnp.asarray(x))
    # 1e-5: f32 sums of the same products in another order
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gref), rtol=1e-5, atol=1e-5)
    # and against the port's own COO path, forward and grad
    xc = torch.tensor(x, requires_grad=True)
    out_coo = spmm_coo(tg, xc)
    (out_coo * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), out_coo.detach().numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), xc.grad.numpy(), rtol=1e-5, atol=1e-5)
    assert out.dtype == torch.float32 and out.shape == (tg.n_nodes, d)


def test_bsr_bf16_matches_jax():
    """bf16 tiles, x rounded to bf16, f32 accumulation, on both sides."""
    tg, jg = _graphs("hic")
    op = tbsr.bsr_from_graph(tg, dtype="bfloat16", device=CPU)
    jop = jbsr.bsr_from_graph(jg, dtype="bfloat16")
    x = np.random.default_rng(9).normal(size=(tg.n_nodes, 64)).astype(np.float32)
    out = tbsr.bsr_matmul(op.fwd, torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), _jax_spmm(jop, x), rtol=1e-5, atol=1e-5)


def test_strand_stacked_width_through_spmm():
    """(N, 2d) input, as the strand-stacked layer feeds it, equals two (N, d) calls."""
    tg, _ = _graphs("hic", n=512)
    g = tbsr.attach_bsr(tg, device=CPU)
    x = torch.from_numpy(np.random.default_rng(10).normal(size=(512, 2, 48)).astype(np.float32))
    both = spmm(g, x.reshape(512, 96)).reshape(512, 2, 48)
    for s in range(2):
        np.testing.assert_allclose(
            both[:, s].numpy(), spmm(g, x[:, s].contiguous()).numpy(), rtol=1e-6, atol=1e-6
        )


def test_cpu_wrapper_takes_plain_version_without_launching():
    tg, _ = _graphs("dense", n=512)
    op = tbsr.bsr_from_graph(tg, device=CPU)
    x = torch.from_numpy(np.random.default_rng(11).normal(size=(512, 16)).astype(np.float32))
    _build.LAUNCHES.clear()
    out = tbsr.bsr_matmul(op.fwd, x)
    assert _build.LAUNCHES["bsr_spmm"] == 0
    torch.testing.assert_close(out, tbsr.bsr_matmul_plain(op.fwd, x), rtol=0, atol=0)
    with pytest.raises(ValueError, match="columns"):
        tbsr.bsr_matmul_plain(op.fwd, x[:256])
    with pytest.raises(ValueError, match="cuda or cpu"):
        tbsr.bsr_matmul(op.fwd, x.to("meta"))


def test_missing_nvcc_raises(monkeypatch):
    """No compiler means no kernel, and an error: never a silent fallback."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("bsr_spmm")


def test_library_path_keys_on_source_and_flags(monkeypatch, tmp_path):
    """A change to the nvcc flags, to a kernel's source or to a header it
    includes names another library, so a stale build is never loaded."""
    path = _build.library_path("bsr_spmm")
    assert path == _build.library_path("bsr_spmm")
    assert [p.name for p in _build.sources("gcn_fused")] == ["gcn_fused.cu", "bsr_stream.cuh"]
    assert [p.name for p in _build.sources("bsr_spmm")] == ["bsr_spmm.cu", "csr_gather.cuh"]
    assert [p.name for p in _build.sources("gcn_fused_bwd")] == [
        "gcn_fused_bwd.cu", "csr_gather.cuh"]
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS[:-2])
    assert _build.library_path("bsr_spmm") != path
    monkeypatch.undo()

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for src in _build.CSRC.iterdir():
        (csrc / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    names = ("bsr_spmm", "gcn_fused", "gcn_fused_bwd")
    before = {name: _build.library_path(name) for name in names}
    assert before["bsr_spmm"] == path  # the same bytes give the same name
    # each header edit renames exactly the libraries that include it
    for header_name, includers in (("bsr_stream.cuh", {"gcn_fused"}),
                                   ("csr_gather.cuh", {"bsr_spmm", "gcn_fused_bwd"})):
        header = csrc / header_name
        header.write_bytes(header.read_bytes() + b"\n// edited\n")
        after = {name: _build.library_path(name) for name in names}
        assert {name for name in names if after[name] != before[name]} == includers, header_name
        before = after
    fused = _build.library_path("gcn_fused")
    (csrc / "gcn_fused.cu").write_bytes((csrc / "gcn_fused.cu").read_bytes() + b"\n")
    assert _build.library_path("gcn_fused") != fused


def test_bsr_rejects_misaligned_graph():
    tg = tsp.from_dense(_dense_graph(300, seed=9), device=CPU)
    with pytest.raises(ValueError):
        tbsr.bsr_from_graph(tg, tile=256, device=CPU)
