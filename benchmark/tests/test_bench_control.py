"""The control: the plain reference computed in TF32, the precision next
below the configuration's IEEE fp32, put in the program's place. At a CPU
size it must fail one of each cell's limits, where the program passes
them all. (On the card, at the cells' own sizes: ``calibrate.py
--control``.)"""

import numpy as np
import pytest
import torch

import tiny


def test_tf32_rounding():
    import reference
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                      -1.0 - 2.0 ** -10 - 2.0 ** -12, 3.0e-30])
    got = reference.tf32(x)
    # 10 mantissa bits: ties to even, then away from the tie
    assert got.tolist() == [1.0, 1.0, 1.0 + 2.0 ** -9,
                            -1.0 - 2.0 ** -10, pytest.approx(3.0e-30,
                                                             rel=2 ** -10)]
    y = torch.randn(1000)
    assert float(((reference.tf32(y) - y).abs() / y.abs()).max()) <= 2 ** -11


@pytest.mark.parametrize("cell", ["tiny_mf.scan", "tiny_ex.scan"])
def test_control_fails_where_the_program_passes(tiny_root, cell):
    run, line = tiny.run_tiny(tiny_root, cell, seed=31)
    assert line["correct"], line["compared"]
    limits = run.cell.cfg["limits"]
    ctl = {}
    for c in run.checks:
        ctl.update(c.control())
    failed = [k for k, v in ctl.items() if k in limits
              and not v <= limits[k]]
    assert failed, (ctl, limits)


def test_reference_products_match_a_dense_product():
    """The blocked f64 products against one dense product of the same
    draws."""
    import cohort
    import reference
    cfg = {"name": "t", "n_individuals": 64, "n_snps": 5000, "maf_lo": 0.05,
           "maf_hi": 0.5}
    W = torch.cat([g for _, g in cohort.blocks(cfg, 7, "cpu")]).double() - 1
    A = torch.randn(64, 3)
    T = torch.randn(5000, 2)
    rows = torch.tensor([0, 17, 4095, 4096, 4999])
    samples = [("packed_dot", A, (W @ A.double()).float()[rows], rows),
               ("packed_tdot", T, (W.T @ T.double()).float(), None),
               ("kernel_matvec", A, (W.T @ (W @ A.double())).float(), None)]
    gaps = reference.packed_products(cfg, 7, samples, "cpu")
    assert max(gaps) < 1e-6
    ctl = reference.packed_products(cfg, 7, samples, "cpu", control=True)
    assert min(ctl) > 1e-5


def test_cohort_blocks_redraw_alike():
    import cohort
    cfg = {"name": "t", "n_individuals": 50, "n_snps": 9000, "maf_lo": 0.05,
           "maf_hi": 0.5}
    whole = torch.cat([g for _, g in cohort.blocks(cfg, 2**31 + 5, "cpu")])
    again = cohort.genotype_block(cfg, 2**31 + 5, 4096, "cpu")
    assert torch.equal(whole[4096:8192], again)
    assert set(np.unique(whole.numpy())) <= {0, 1, 2}


def test_matfree_reference_pieces():
    """The frozen matrix-free pieces against dense f64 linear algebra: the
    Krylov solve and the quadrature logdet at a depth that spans the
    space, and the blocked CG."""
    import reference_mf
    rng = np.random.default_rng(3)
    n = 48
    A = rng.standard_normal((n, 3 * n))
    K = torch.as_tensor(A @ A.T / (3 * n))
    op = reference_mf.Kernel(K.clone(), control=False)
    Kt = op.K
    Z = torch.as_tensor(reference_mf.rademacher(1, n, 4))
    sk = reference_mf.Krylov(op, Z, n, reorth=True)
    H = Kt + 0.7 * torch.eye(n, dtype=torch.float64)
    want = torch.linalg.solve(H, Z).numpy()
    assert np.allclose(sk.solve(0.7), want, rtol=1e-8, atol=1e-10)
    ld = reference_mf.Krylov(op, Z, n, reorth=True).logdet(0.7)
    # the Hutchinson quadrature of log|H| on four probes, exact at full
    # depth: n·mean_z zᵀ log(H) z / ‖z‖²
    d, U = torch.linalg.eigh(H)
    quad = (U.T @ Z) ** 2 * torch.log(d)[:, None]
    assert np.isclose(ld, float(n * (quad.sum(0) / (Z * Z).sum(0)).mean()),
                      rtol=1e-9)
    B = rng.standard_normal((n, 2))
    X = reference_mf.cg(op, B, 0.7)
    assert np.allclose(X, torch.linalg.solve(H, torch.as_tensor(B)).numpy(),
                       rtol=1e-8, atol=1e-10)
    # the scale is the method's Hutchinson estimate of the mean diagonal
    assert abs(op.s0 / float(K.diagonal().mean()) - 1) < 0.2


def test_dense_kernel_is_the_blocked_product():
    import cohort
    import reference
    import reference_mf
    cfg = {"name": "t", "n_individuals": 40, "n_snps": 5000, "maf_lo": 0.05,
           "maf_hi": 0.5}
    assert torch.equal(reference_mf.dense_kernel(cfg, 9, "cpu"),
                       reference.exact_kernel(cfg, 9, "cpu"))
    W = torch.cat([g for _, g in cohort.blocks(cfg, 9, "cpu")]).double() - 1
    assert torch.equal(reference.exact_kernel(cfg, 9, "cpu"), W.T @ W)
