"""The port's host ingest (A15) against the JAX package's, on the CPU.

The native library: the port builds its own copy of the C++ source with g++
into build/native/, and its ``hic_topk`` and ``intersect_fraction`` equal
the JAX package's library bit for bit (top-k order included; intersection
pairs sorted, since ``std::sort`` orders peaks of equal start either way).
The numpy plain versions equal the library as sets, on inputs with no tie at
the k-th value. Without a compiler the entry points raise: there is no
fallback. Every numpy module (genome, peaks, hic, hichip, expression,
synthetic_raw) gives JAX's results exactly on the same inputs; make_raw_world
writes byte-identical files from one seed.
"""

import filecmp
import json
import os
from pathlib import Path

import numpy as np
import pytest

from chromegcn_tpu import native_bridge as jnb
from chromegcn_tpu.data import synthetic_raw as jraw
from chromegcn_tpu.pipeline import build as jbuild
from chromegcn_tpu.pipeline import expression as jexpr
from chromegcn_tpu.pipeline import genome as jgenome
from chromegcn_tpu.pipeline import hic as jhic
from chromegcn_tpu.pipeline import hichip as jhichip
from chromegcn_tpu.pipeline import peaks as jpeaks
from chromegcn_tpu_torch import native_bridge as tnb
from chromegcn_tpu_torch.data import synthetic_raw as traw
from chromegcn_tpu_torch.pipeline import build as tbuild
from chromegcn_tpu_torch.pipeline import expression as texpr
from chromegcn_tpu_torch.pipeline import genome as tgenome
from chromegcn_tpu_torch.pipeline import hic as thic
from chromegcn_tpu_torch.pipeline import hichip as thichip
from chromegcn_tpu_torch.pipeline import peaks as tpeaks

ROOT = Path(__file__).resolve().parent.parent
CHUNK = 1 << 16  # the C++ reader's chunk


@pytest.fixture(scope="module", autouse=True)
def jax_native():
    """JAX's side runs its library, not its silent numpy fallback."""
    assert jnb.native_available()


def _write(path, lines, final_newline=True):
    path.write_text("\n".join(lines) + ("\n" if final_newline else ""))
    return str(path)


def _random_contacts(rng, n_lines, n_bins, res=1000):
    """Unique undirected pairs with distinct real-valued counts: no two
    contacts tie after any normalization."""
    b1 = rng.integers(0, n_bins, size=4 * n_lines)
    b2 = rng.integers(0, n_bins, size=4 * n_lines)
    lo, hi = np.minimum(b1, b2), np.maximum(b1, b2)
    _, first = np.unique(lo * n_bins + hi, return_index=True)
    first = np.sort(rng.permutation(first)[:n_lines])
    vals = rng.permutation(np.arange(1, len(first) + 1)) + rng.random(len(first))
    return [f"{lo[i] * res}\t{hi[i] * res}\t{v:.6f}" for i, v in zip(first, vals)]


def _case(name, tmp_path):
    """(path, bins, k, kwargs) of one hic_topk case of tests/test_pipeline.py."""
    rng = np.random.default_rng(7)
    if name == "norm zero and NaN bins":
        path = _write(tmp_path / "c.RAWobserved", _random_contacts(rng, 3000, 400))
        norm = rng.uniform(0.5, 1.5, 401)
        norm[rng.choice(401, 30, replace=False)] = 0.0
        norm[rng.choice(401, 30, replace=False)] = np.nan
        return path, np.arange(0, 400_000, 1000), 500, dict(norm=norm)
    if name in ("min_dist", "max_dist"):
        path = _write(tmp_path / "c.RAWobserved", _random_contacts(rng, 3000, 400))
        kw = dict(min_dist_bp=50_000) if name == "min_dist" else dict(max_dist_bp=20_000)
        return path, np.arange(0, 400_000, 1000), 300, kw
    if name == "a line over several chunks, no final newline":
        long_line = " " * (3 * CHUNK) + "0\t1000\t50.0"
        path = _write(tmp_path / "c.RAWobserved",
                      ["0\t2000\t10.0", long_line, "1000\t3000\t7.5", "0\t3000\t5.0"],
                      final_newline=False)
        return path, np.array([0, 1000, 2000, 3000]), 5, {}
    if name == "newlines at the chunk edges":
        lines = [f"{i * 1000}\t{i * 1000 + 1000 * (1 + i % 7)}\t{1.0 + i * 0.5}"
                 for i in range(9000)]
        path = _write(tmp_path / "c.RAWobserved", lines)
        assert os.path.getsize(path) > 2 * CHUNK
        return path, np.arange(0, 9000 * 1000 + 8000, 1000), 50, {}
    if name == "upsample_grid 5":
        lines = [f"{a * 5000}\t{b * 5000}\t{c}.0" for a, b, c in
                 zip(rng.integers(0, 12, 40), rng.integers(0, 12, 40), rng.integers(1, 50, 40))]
        path = _write(tmp_path / "k.RAWobserved", lines)
        return path, np.arange(60) * 1000, 200, dict(norm=np.linspace(0.5, 1.5, 61),
                                                    upsample_grid=5)
    if name == "integer counts, ties":
        lines = [f"{a * 1000}\t{b * 1000}\t{c}" for a, b, c in
                 zip(rng.integers(0, 300, 5000), rng.integers(0, 300, 5000),
                     rng.integers(1, 6, 5000))]
        return _write(tmp_path / "c.RAWobserved", lines), np.arange(0, 300_000, 2000), 400, {}
    raise KeyError(name)


CASES = ("norm zero and NaN bins", "min_dist", "max_dist",
         "a line over several chunks, no final newline", "newlines at the chunk edges",
         "upsample_grid 5", "integer counts, ties")


@pytest.mark.parametrize("name", CASES)
def test_hic_topk_equals_jax_native(name, tmp_path):
    """Bit for bit, order included, ties too: one C++ function in both."""
    path, bins, k, kw = _case(name, tmp_path)
    ours = tnb.hic_topk(path, bins, k, **kw)
    ref = jnb.hic_topk(path, bins, k, **kw)
    assert len(ref[0]) > 0
    for got, want in zip(ours, ref):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _as_set(res):
    return sorted(zip(res[0].tolist(), res[1].tolist(), res[2].tolist()))


@pytest.mark.parametrize("name", [c for c in CASES if c != "integer counts, ties"])
def test_hic_topk_plain_equals_native_as_sets(name, tmp_path):
    """The numpy version keeps the same pairs and values where no tie sits at
    the k-th value (it orders and breaks ties otherwise)."""
    path, bins, k, kw = _case(name, tmp_path)
    native = tnb.hic_topk(path, bins, k, **kw)
    full = tnb.hic_topk(path, bins, 10 ** 6, **kw)
    if len(full[2]) > k:  # the precondition: the k-th value is not tied
        assert full[2][k - 1] != full[2][k]
    assert _as_set(tnb.hic_topk_plain(path, bins, k, **kw)) == _as_set(native)
    np.testing.assert_array_equal(np.sort(native[2])[::-1], native[2])


def test_streaming_upsample_equals_the_materialised_dump(tmp_path):
    """upsample_grid=5 in the stream equals writing the 25x dump with
    upsample_contacts_5kb_to_1kb and streaming it at grid 1, both packages'."""
    path, bins, k, kw = _case("upsample_grid 5", tmp_path)
    rows = np.loadtxt(path)
    ub = thic.upsample_contacts_5kb_to_1kb(rows[:, 0].astype(np.int64),
                                           rows[:, 1].astype(np.int64), rows[:, 2])
    for got, want in zip(ub, jhic.upsample_contacts_5kb_to_1kb(
            rows[:, 0].astype(np.int64), rows[:, 1].astype(np.int64), rows[:, 2])):
        np.testing.assert_array_equal(got, want)
    mat = _write(tmp_path / "k.up", [f"{a}\t{b}\t{c}" for a, b, c in zip(*ub)])
    golden = _as_set(tnb.hic_topk(mat, bins, k, norm=kw["norm"]))
    assert len(golden) > 0
    assert _as_set(tnb.hic_topk(path, bins, k, **kw)) == golden
    assert _as_set(tnb.hic_topk_plain(path, bins, k, **kw)) == golden


def test_hic_topk_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tnb.hic_topk(str(tmp_path / "none.RAWobserved"), np.arange(3), 2)


def _intervals(rng, n_win, n_peaks, span):
    starts = np.sort(rng.integers(0, span, n_win))
    ws, we = starts, starts + rng.integers(200, 1500, n_win)
    ps = rng.integers(0, span, n_peaks)
    ps[: n_peaks // 4] = ps[n_peaks // 4: n_peaks // 2]  # equal starts
    pe = ps + rng.integers(1, 900, n_peaks)
    return ws, we, ps, pe


@pytest.mark.parametrize("min_frac", [0.0, 0.1, 0.5, 1.0])
def test_intersect_fraction_equals_jax_and_plain(min_frac):
    """Sorted (window, peak) pairs: the port's library = JAX's library = the
    plain version; and pairs come by window in all three."""
    ws, we, ps, pe = _intervals(np.random.default_rng(int(min_frac * 10)), 3000, 2500, 2_000_000)
    ours = tnb.intersect_fraction(ws, we, ps, pe, min_frac)
    ref = jnb.intersect_fraction(ws, we, ps, pe, min_frac)
    plain = tnb.intersect_fraction_plain(ws, we, ps, pe, min_frac)
    assert len(ours[0]) > 0
    key = lambda res: sorted(zip(res[0].tolist(), res[1].tolist()))
    assert key(ours) == key(ref) == key(plain)
    np.testing.assert_array_equal(ours[0], plain[0])
    for got, want in zip(plain, jnb._intersect_numpy(ws, we, ps, pe, min_frac)):
        np.testing.assert_array_equal(got, want)


def test_intersect_fraction_threshold_and_empty():
    """bedtools -f 0.1: 99 bp of a 1,000 bp window fails, 100 bp passes; no
    windows or no peaks give no pairs."""
    for fn in (tnb.intersect_fraction, tnb.intersect_fraction_plain):
        assert len(fn([0], [1000], [901], [1000], 0.1)[0]) == 0
        assert fn([0], [1000], [900], [1000], 0.1)[0].tolist() == [0]
        for args in (([], [], [1], [2]), ([0], [10], [], [])):
            w, p = fn(*args, 0.1)
            assert w.dtype == p.dtype == np.int64 and len(w) == len(p) == 0


def test_no_compiler_raises_instead_of_falling_back(tmp_path, monkeypatch):
    """With no compiler and an empty build directory both entry points
    raise with the build's message; nothing returns the plain result."""
    raw = _write(tmp_path / "c.RAWobserved", ["0\t1000\t5.0"])
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(tnb, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnb, "_lib", None)
    with pytest.raises(RuntimeError, match="native ingest library build failed.*no-such-compiler"):
        tnb.hic_topk(raw, np.array([0, 1000]), 1)
    with pytest.raises(RuntimeError, match="native ingest library build failed"):
        tnb.intersect_fraction([0], [1000], [0], [1000])
    assert not list((tmp_path / "build").glob("*.so"))


def test_the_library_is_the_ports_own():
    """Its source lies in the port, its build under build/native/, its name
    keyed on the source, compiler and flags; the bridge reads nothing of
    the JAX package."""
    port = ROOT / "chromegcn_tpu_torch"
    assert tnb.SOURCE.is_file() and port in tnb.SOURCE.parents
    assert tnb.library_path().parent == ROOT / "build" / "native"
    assert tnb.CXXFLAGS == ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-shared")
    paths = [v for v in vars(tnb).values() if isinstance(v, Path)]
    assert paths and not any(ROOT / "chromegcn_tpu" in (p, *p.parents) for p in paths)
    tnb.load()
    assert tnb.library_path().is_file()


# ---------------------------------------------------------------------------
# the numpy modules against JAX's
# ---------------------------------------------------------------------------


def test_constants_and_paths_equal_jax():
    assert tgenome.HG19_SIZES == jgenome.HG19_SIZES
    for chrom in ("chr1", "chr3", "chr8", "chr12", "chr21", "chr2", "chrX"):
        assert tbuild.split_of(chrom) == jbuild.split_of(chrom)
    assert thic.split_graph_paths("r", "test", "500000", "SQRTVC") == \
        jhic.split_graph_paths("r", "test", "500000", "SQRTVC")
    assert traw.default_assays(2, 1, 3) == jraw.default_assays(2, 1, 3)
    assert traw.scaled_hg19_sizes() == jraw.scaled_hg19_sizes()
    assert traw.scaled_hg19_sizes(7, 10) == jraw.scaled_hg19_sizes(7, 10)


@pytest.mark.parametrize("size,window,flank", [(10_000, 1000, 500), (12_345, 1000, 500),
                                               (999, 1000, 500), (50_000, 200, 100)])
def test_tile_and_extend_windows_equal_jax(size, window, flank):
    ours, ref = tgenome.tile_windows(size, window), jgenome.tile_windows(size, window)
    for got, want in zip(ours + tgenome.extend_windows(*ours, flank, size),
                         ref + jgenome.extend_windows(*ref, flank, size)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.fixture
def peak_dir(tmp_path):
    """Two narrowPeak files (one gzipped) and a bed, with short rows."""
    import gzip

    rng = np.random.default_rng(3)
    d = tmp_path / "peaks"
    d.mkdir()
    for name in ("Tf_A.narrowPeak", "HM_b.narrowPeak.gz", "dnase.bed"):
        rows = []
        for chrom in ("chr1", "chr2"):
            for st in rng.integers(0, 60_000, 40):
                rows.append(f"{chrom}\t{st}\t{st + int(rng.integers(50, 700))}\tp\t0\t.\t0\t-1\t-1\t-1")
        rows.append("chr1\t5")  # too short: skipped
        text = "\n".join(rows) + "\n"
        if name.endswith(".gz"):
            with gzip.open(d / name, "wt") as f:
                f.write(text)
        else:
            (d / name).write_text(text)
    (d / "notes.txt").write_text("not a peak file\n")
    return str(d)


def test_peaks_equal_jax(peak_dir):
    files = tpeaks.collect_peak_files(peak_dir)
    assert files == jpeaks.collect_peak_files(peak_dir) and len(files) == 3
    ours = [tpeaks.read_narrowpeak(p) for p in files]
    ref = [jpeaks.read_narrowpeak(p) for p in files]
    for o, r in zip(ours, ref):
        assert o["assay"] == r["assay"]
        for key in ("chrom", "start", "end"):
            assert o[key].dtype == r[key].dtype
            np.testing.assert_array_equal(o[key], r[key])
    assert tpeaks.read_narrowpeak(files[0], assay="x")["assay"] == "x"
    ws, we = tgenome.tile_windows(64_000)
    for chrom in ("chr1", "chr2", "chr9"):
        for frac in (0.1, 0.5):
            (lab, assays), (jlab, jassays) = (tpeaks.label_windows(ws, we, ours, chrom, frac),
                                              jpeaks.label_windows(ws, we, ref, chrom, frac))
            assert assays == jassays and lab.dtype == jlab.dtype
            np.testing.assert_array_equal(lab, jlab)
    assert tpeaks.label_windows(ws, we, ours, "chr1")[0].sum() > 0


def test_read_norm_vector_equals_jax(tmp_path):
    path = tmp_path / "c.SQRTVCnorm"
    path.write_text("1.5\nNaN\n0\n\n  2.25 \nnot-a-number\n0.0\n3e-1\n")
    ours, ref = thic.read_norm_vector(str(path)), jhic.read_norm_vector(str(path))
    assert ours.dtype == ref.dtype
    np.testing.assert_array_equal(ours, ref)
    assert ours.tolist() == [1.5, 0.0, 0.0, 2.25, 0.0, 0.0, 0.3]


@pytest.mark.parametrize("kw", [dict(), dict(norm=True), dict(norm=True, min_dist_bp=20_000),
                                dict(max_dist_bp=30_000), dict(norm=True, upsample_grid=5)],
                         ids=["raw", "norm", "norm min_dist", "max_dist", "norm upsample"])
def test_chrom_topk_edges_equals_jax(kw, tmp_path):
    rng = np.random.default_rng(5)
    raw = _write(tmp_path / "c.RAWobserved", _random_contacts(rng, 4000, 500))
    kw = dict(kw)
    if kw.pop("norm", False):
        norm = rng.uniform(0.5, 1.5, 520)
        norm[rng.choice(520, 10, replace=False)] = np.nan
        norm_path = tmp_path / "c.SQRTVCnorm"
        norm_path.write_text("".join("NaN\n" if np.isnan(v) else f"{v:.6f}\n" for v in norm))
        kw["norm_path"] = str(norm_path)
    starts = np.sort(rng.choice(np.arange(520) * 1000, 350, replace=False))
    ours = thic.chrom_topk_edges(raw, starts, 600, **kw)
    ref = jhic.chrom_topk_edges(raw, starts, 600, **kw)
    assert len(ref[0]) > 0
    for got, want in zip(ours, ref):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.fixture
def pairs_file(tmp_path):
    """HiC-Pro allValidPairs rows: banker's rounding ties (1,500 and 2,500
    both round to 2,000; 3,500 to 4,000), a same-bin pair, an
    inter-chromosomal pair, a malformed row and a short row."""
    rows = [
        ("r1", "chr1", "1499", "+", "chr1", "3200", "-", "0"),
        ("r2", "chr1", "1500", "+", "chr1", "2500", "-", "0"),
        ("r3", "chr1", "3500", "+", "chr1", "12500", "-", "0", "G1"),
        ("r4", "chr1", "5100", "+", "chr1", "5300", "-", "0"),
        ("r5", "chr1", "1000", "+", "chr2", "9000", "-", "0"),
        ("r6", "chr2", "100", "+", "chr2", "7800", "-", "0"),
        ("r7", "chr2", "oops", "+", "chr2", "1000", "-", "0"),
        ("r8", "chr1", "3300", "+", "chr1", "1200", "-", "0"),
        ("r9", "chr2", "500", "+", "chr2", "40500", "-", "0"),
        ("r10", "chr3"),
    ]
    path = tmp_path / "sample.allValidPairs"
    path.write_text("\n".join("\t".join(r) for r in rows) + "\n")
    return str(path)


def test_hichip_equals_jax(pairs_file, tmp_path):
    ours = list(thichip.iter_intra_contacts(pairs_file))
    assert ours == list(jhichip.iter_intra_contacts(pairs_file))
    assert ("chr1", 4000, 12000, 8000) in ours and all(p[1:3] != (2000, 2000) for p in ours)
    counts = thichip.extract_hichip_contacts(pairs_file, str(tmp_path / "port"))
    assert counts == jhichip.extract_hichip_contacts(pairs_file, str(tmp_path / "jax"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names and names
    match, mismatch, errors = filecmp.cmpfiles(tmp_path / "port", tmp_path / "jax", names,
                                               shallow=False)
    assert match == names and not mismatch and not errors
    for chrom in ("chr1", "chr2", "chr3"):
        for kw in ({}, {"max_dist_bp": 10_000}, {"resolution": 5000}):
            for got, want in zip(thichip.hichip_edges(pairs_file, chrom, **kw),
                                 jhichip.hichip_edges(pairs_file, chrom, **kw)):
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)


def test_expression_equals_jax():
    rng = np.random.default_rng(9)
    vals = rng.gamma(1.0, 2.0, size=(40, 5))
    for method in ("median", "mean"):
        np.testing.assert_array_equal(texpr.threshold_expression(vals, method),
                                      jexpr.threshold_expression(vals, method))
    with pytest.raises(ValueError, match="median"):
        texpr.threshold_expression(vals, "max")
    expressed = texpr.threshold_expression(vals)
    genes = [("chr1", 1000 * i, 1000 * i + 500, f"g{i}") for i in range(40)]
    assert texpr.expression_to_bed(genes, expressed, "rna") == \
        jexpr.expression_to_bed(genes, expressed, "rna")
    starts, ends = rng.integers(0, 10 ** 6, 40), rng.integers(0, 10 ** 6, 40)
    strands = np.asarray(rng.choice(["+", "-"], 40))
    for e in (None, ends):
        np.testing.assert_array_equal(texpr.annotate_tss(starts, strands, e),
                                      jexpr.annotate_tss(starts, strands, e))
    np.testing.assert_array_equal(texpr.window_of(starts, 500), jexpr.window_of(starts, 500))
    tss = texpr.annotate_tss(starts, strands, ends)
    windows = np.unique(texpr.window_of(tss))[::2]
    np.testing.assert_array_equal(texpr.tss_window_labels(windows, tss, expressed),
                                  jexpr.tss_window_labels(windows, tss, expressed))


@pytest.mark.parametrize("kw", [
    dict(sizes={"chr1": 20_000, "chr2": 15_500}, seed=3),
    dict(sizes={"chr3": 30_000}, seed=0, n_tfbs=1, n_hm=2, n_dnase=1, motif_p=0.4,
         pairs_per_node=3.0, noise_frac=0.5, hicnorm="KR", fasta_line=61, window=500),
], ids=["two chromosomes", "options"])
def test_make_raw_world_writes_jax_files(kw, tmp_path):
    """Every file byte for byte, ground_truth.json included."""
    kw = dict(kw)
    sizes = kw.pop("sizes")
    ours = traw.make_raw_world(str(tmp_path / "port"), sizes, verbose=lambda *a: None, **kw)
    ref = jraw.make_raw_world(str(tmp_path / "jax"), sizes, verbose=lambda *a: None, **kw)
    assert json.loads(json.dumps(ours)) == json.loads(json.dumps(ref))
    files = sorted(str(p.relative_to(tmp_path / "jax")) for p in (tmp_path / "jax").rglob("*")
                   if p.is_file())
    assert "ground_truth.json" in files and len(files) == 2 + 2 * len(sizes) + ref["n_assays"]
    assert files == sorted(str(p.relative_to(tmp_path / "port"))
                           for p in (tmp_path / "port").rglob("*") if p.is_file())
    for rel in files:
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes(), rel
