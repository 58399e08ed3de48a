"""The port's genotype ingest and file writers against the JAX package's.

One ragged cohort (37 individuals × 203 SNPs, 3% missing) is written in
every format by the JAX package's writers and read by both packages'
``read_marker`` — in memory, and into a store unpacked and 2-bit packed
(explicit ``n_shards``, so both plan the same shards): the genotypes,
marker metadata, shard files and manifests must be identical. The port's
native C++ parsers must agree with its numpy fallbacks, its writers must
write the JAX package's bytes, and ``read_zmat`` must accept and reject
what the JAX package's does."""

import filecmp
import gzip
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import eagleeverything_tpu as ee  # noqa: E402
from eagleeverything_tpu.data import simulate as jsim  # noqa: E402

import eagleeverything_tpu_torch as port  # noqa: E402
from eagleeverything_tpu_torch.data import simulate as psim  # noqa: E402
from eagleeverything_tpu_torch.io import native, parsers  # noqa: E402

N_SHARDS = 3


@pytest.fixture(scope="module")
def sim():
    return jsim.simulate_dataset(n=37, p=203, seed=21, missing_rate=0.03)


def _gz(path: str) -> str:
    with open(path, "rb") as src, gzip.open(path + ".gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    os.remove(path)
    return path + ".gz"


def _ascii(sim, d):
    path = os.path.join(d, "g.txt")
    jsim.write_ascii_geno(sim, path)
    return path, {}


def _ascii_custom(sim, d):
    path = os.path.join(d, "g.txt")
    jsim.write_ascii_geno(sim, path, AA="a", AB="h", BB="b", missing="-")
    return path, {"AA": "a", "AB": "h", "BB": "b", "missing": "-"}


def _nospace(sim, d):
    path = os.path.join(d, "g.txt")
    jsim.write_ascii_geno_nospace(sim, path)
    return path, {"AA": "0", "AB": "1", "BB": "2", "missing": "X"}


def _ped(sim, d):
    path = os.path.join(d, "g.ped")
    jsim.write_plink_ped(sim, path, os.path.join(d, "g.map"))
    return path, {"type": "PLINK"}


def _bed(sim, d):
    path = os.path.join(d, "g.bed")
    jsim.write_plink_bed(sim, path)
    return path, {"type": "PLINK"}


def _vcf(sim, d):
    path = os.path.join(d, "g.vcf")
    jsim.write_vcf(sim, path)
    return path, {"type": "vcf"}


def _gzipped(write):
    def w(sim, d):
        path, kw = write(sim, d)
        return _gz(path), kw
    return w


FORMATS = {
    "ascii": _ascii, "ascii_custom": _ascii_custom, "nospace": _nospace,
    "ped": _ped, "bed": _bed, "vcf": _vcf,
    "ascii.gz": _gzipped(_ascii), "nospace.gz": _gzipped(_nospace),
    "ped.gz": _gzipped(_ped), "vcf.gz": _gzipped(_vcf),
}
MODES = {"memory": None, "store": False, "store_packed": True}


def _same_dir(a: str, b: str) -> None:
    """Same file names, byte-identical files."""
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    assert "manifest.json" in names and len(names) == N_SHARDS + 1
    match, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("fmt", list(FORMATS))
def test_read_marker_matches_jax(sim, tmp_path, fmt, mode):
    path, kw = FORMATS[fmt](sim, str(tmp_path))
    packed = MODES[mode]
    stores = {}
    handles = {}
    for name, pkg in (("jax", ee), ("port", port)):
        if packed is None:
            handles[name] = pkg.read_marker(path, **kw)
        else:
            stores[name] = str(tmp_path / f"store_{name}")
            handles[name] = pkg.read_marker(
                path, store_dir=stores[name], n_shards=N_SHARDS,
                packed=packed, **kw)
    ref, got = handles["jax"], handles["port"]
    assert (got.n, got.p) == (ref.n, ref.p) == sim.geno.shape
    for field in ("marker_names", "chrom", "pos"):
        assert getattr(got, field) == getattr(ref, field), field
    if fmt.startswith(("ped", "bed", "vcf")):
        assert got.marker_names == sim.marker_names
    np.testing.assert_array_equal(got.materialize(), ref.materialize())
    np.testing.assert_array_equal(got.materialize(), sim.geno)
    if packed is None:
        assert got.geno.dtype == np.int8 and got.store_dir is None
    else:
        _same_dir(stores["port"], stores["jax"])


@pytest.mark.parametrize("fmt", ["ascii", "ascii_custom", "nospace", "vcf"])
def test_native_parsers_match_python(sim, tmp_path, fmt):
    """The port's native ingest library loads from its own build directory
    and agrees with the numpy parsers, in blocks that do not divide the
    rows."""
    lib = native.get_lib()
    assert lib is not None, "g++ build of the port's ingest library failed"
    assert native.lib_path().parent == native.BUILD_DIR
    assert os.path.exists(native.lib_path())
    path, kw = FORMATS[fmt](sim, str(tmp_path))
    if fmt == "vcf":
        def read(use_native):
            return np.hstack([g for g, *_ in parsers.iter_vcf_blocks(
                path, block_snps=50, use_native=use_native)])
        dims = parsers.vcf_dims(path)
        assert dims == sim.geno.shape
        got, ref = read(True), read(False)
    else:
        codes = {k: kw.get(k, d) for k, d in
                 (("AA", "AA"), ("AB", "AB"), ("BB", "BB"),
                  ("missing", "NA"))}

        def read(use_native):
            return np.vstack(list(parsers.iter_ascii_blocks(
                path, block_rows=10, use_native=use_native, **codes)))
        got, ref = read(True), read(False)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, sim.geno)


def test_native_vcf_metadata_matches_python(sim, tmp_path):
    path, _ = _vcf(sim, str(tmp_path))
    meta = {}
    for use_native in (True, False):
        names, chroms, poss = [], [], []
        for _, nm, ch, po in parsers.iter_vcf_blocks(path, block_snps=64,
                                                     use_native=use_native):
            names += nm
            chroms += ch
            poss += po
        meta[use_native] = (names, chroms, poss)
    assert meta[True] == meta[False]
    assert meta[True][0] == sim.marker_names


@pytest.mark.parametrize("before", [None, "5"])
def test_ncpu_restores_env(sim, tmp_path, monkeypatch, before):
    """``ncpu`` caps the native pool through EE_NCPU for the call only."""
    if before is None:
        monkeypatch.delenv("EE_NCPU", raising=False)
    else:
        monkeypatch.setenv("EE_NCPU", before)
    path, _ = _ascii(sim, str(tmp_path))
    seen = []
    real = parsers.iter_ascii_blocks

    def spy(*a, **k):
        seen.append(os.environ.get("EE_NCPU"))
        return real(*a, **k)
    monkeypatch.setattr(parsers, "iter_ascii_blocks", spy)
    h = port.read_marker(path, ncpu=2)
    np.testing.assert_array_equal(h.geno, sim.geno)
    assert seen == ["2"]
    assert os.environ.get("EE_NCPU") == before
    with pytest.raises(ValueError):
        port.read_marker(path, ncpu=-1)


def test_bed_gz_refused_like_jax(tmp_path):
    path = str(tmp_path / "g.bed.gz")
    with open(path, "wb") as f:
        f.write(b"\x1f\x8b")
    for pkg in (ee, port):
        with pytest.raises(ValueError, match="gzipped binary PLINK"):
            pkg.read_marker(path, type="PLINK")


_ZMATS = {
    "one_hot": np.eye(5)[[0, 1, 1, 2, 3, 4, 4]],
    "single_row": np.array([[0, 1, 0, 0]]),
    "not_binary": np.array([[0, 2, 0], [1, 0, 0]]),
    "two_links": np.array([[1, 1, 0], [0, 0, 1]]),
    "no_link": np.array([[0, 0, 0], [0, 0, 1]]),
}


@pytest.mark.parametrize("case", list(_ZMATS))
def test_read_zmat_matches_jax(tmp_path, case):
    path = str(tmp_path / "z.txt")
    jsim.write_zmat(_ZMATS[case], path)
    out = {}
    for name, pkg in (("jax", ee), ("port", port)):
        try:
            out[name] = pkg.read_zmat(path)
        except ValueError as e:
            out[name] = str(e)
    if isinstance(out["jax"], str):
        assert out["port"] == out["jax"]
    else:
        assert out["port"].dtype == np.float64
        np.testing.assert_array_equal(out["port"], out["jax"])
    assert isinstance(out["jax"], str) == (case in ("not_binary",
                                                    "two_links", "no_link"))


def _write_geno_custom(mod, sim, path):
    mod.write_ascii_geno(sim, path, AA="0", AB="12", BB="2", missing="NA",
                         sep="\t")


def _write_plink_ped(mod, sim, path):
    mod.write_plink_ped(sim, path, path + ".map")
    return [path, path + ".map"]


def _write_plink_bed(mod, sim, path):
    mod.write_plink_bed(sim, path + ".bed")
    return [path + ext for ext in (".bed", ".bim", ".fam")]


def _write_zmat(mod, sim, path):
    mod.write_zmat(np.eye(6)[[0, 2, 2, 5]], path)


def _write_tutorial(mod, sim, path):
    mod.write_tutorial(path, n=30, p=120, seed=5)
    return [os.path.join(path, f) for f in
            ("geno.txt", "pheno.txt", "map.txt", "qtl_truth.txt")]


WRITERS = {
    "write_ascii_geno": lambda m, s, p: m.write_ascii_geno(s, p),
    "write_ascii_geno_custom": _write_geno_custom,
    "write_ascii_geno_nospace": lambda m, s, p: m.write_ascii_geno_nospace(
        s, p),
    "write_pheno": lambda m, s, p: m.write_pheno(s, p),
    "write_map": lambda m, s, p: m.write_map(s, p),
    "write_plink_ped": _write_plink_ped,
    "write_plink_bed": _write_plink_bed,
    "write_vcf": lambda m, s, p: m.write_vcf(s, p),
    "write_zmat": _write_zmat,
    "write_tutorial": _write_tutorial,
}


@pytest.mark.parametrize("writer", list(WRITERS))
def test_writer_bytes_match_jax(sim, tmp_path, writer):
    files = {}
    for name, mod in (("jax", jsim), ("port", psim)):
        base = str(tmp_path / name / "out")
        os.makedirs(os.path.dirname(base))
        files[name] = WRITERS[writer](mod, sim, base) or [base]
    assert len(files["port"]) == len(files["jax"])
    for got, ref in zip(files["port"], files["jax"]):
        assert os.path.getsize(got) > 0
        assert filecmp.cmp(got, ref, shallow=False), (got, ref)


def test_writers_vectorised_match_loop_on_ragged_rows(sim, tmp_path):
    """Tokens of one width (NA) and of mixed widths (N beside AA) both give
    the reference's loop's text."""
    codes = {0: "AA", 1: "AB", 2: "BB", -9: "NA"}
    loop = "".join(" ".join(codes[int(v)] for v in row) + "\n"
                   for row in sim.geno)
    for missing in ("NA", "N"):
        path = str(tmp_path / f"g_{missing}.txt")
        psim.write_ascii_geno(sim, path, missing=missing)
        with open(path) as f:
            text = f.read()
        assert text == (loop if missing == "NA"
                        else loop.replace("NA", "N"))
