"""A run with the timed path broken underneath comes out not correct: the
harness's card look skipped, a tiny cell driven end to end on the CPU with
one fault planted in the program for the window. The faults a cell can
have: an answer altered where it is produced; half of the batch left out,
the mean taken over the rest; a step that returns its state unchanged
(also the matrix-free engine's CG); an answer altered (also its logdet
estimate).
(The exchange between chips does not exist in a one-chip cell.)"""

import contextlib

import numpy as np
import pytest

import tiny


@contextlib.contextmanager
def patched(obj, attr, make):
    orig = getattr(obj, attr)
    setattr(obj, attr, make(orig))
    try:
        yield
    finally:
        setattr(obj, attr, orig)


def k1_altered(orig):
    """Every seventh SNP's answer shifted by a hundredth of the scale."""
    def f(Wp, A, means, n):
        D = orig(Wp, A, means, n)
        D[::7] += 1e-2 * float(D.abs().max())
        return D
    return f


def k1_half_batch(orig):
    def f(Wp, A, means, n):
        A2 = A.clone()
        A2[n // 2:] = 0
        return 2 * orig(Wp, A2, means, n)
    return f


def k3_unchanged(orig):
    return lambda Wp, V, means, n: V.clone()


def mmt_half_batch(orig):
    def f(K, Wt):
        W = Wt.float()[: max(1, Wt.shape[0] // 2)]
        return K.addmm_(W.T, W, alpha=2.0)
    return f


def sweep_unchanged(orig):
    first = {}

    def f(self, *args, **kwargs):
        if "t" not in first:
            first["t"] = orig(self, *args, **kwargs)
        return first["t"].copy()
    return f


def eigh_altered(orig):
    """Two eigenvectors swapped where the eigendecomposition returns
    them."""
    def f(*args, **kwargs):
        basis = orig(*args, **kwargs)
        U = (basis.host_f64 if basis.host_f64 is not None
             else basis.device_basis())
        U[:, [0, -1]] = U[:, [-1, 0]]
        return basis
    return f


def index_altered(orig):
    def f(*args, **kwargs):
        res = orig(*args, **kwargs)
        if res.indices:
            res.indices[0] = (res.indices[0] + 4097) % res.p
        return res
    return f


def cg_unchanged(orig):
    """The device CG returns its starting state: no step taken."""
    def f(self, B, delta, s0, tol=1e-6, maxiter=400, **kwargs):
        return orig(self, B, delta, s0, tol=tol, maxiter=0, **kwargs)
    return f


def logdet_altered(orig):
    """The stochastic logdet off by one part in a hundred."""
    def f(self, delta):
        return orig(self, delta) * 1.01
    return f


def _faults():
    from eagleeverything_tpu_torch.models import bigscan, engine_torch
    from eagleeverything_tpu_torch.ops import kernels, packed
    return {
        "k1 answer altered": ("tiny_mf.scan", packed, "packed_dot",
                              k1_altered),
        "k1 half the batch": ("tiny_mf.scan", packed, "packed_dot",
                              k1_half_batch),
        "k3 state unchanged": ("tiny_mf.scan", packed, "kernel_matvec",
                               k3_unchanged),
        "mmt half the batch": ("tiny_ex.scan", kernels, "mmt_accumulate",
                               mmt_half_batch),
        "sweep state unchanged": ("tiny_ex.scan", engine_torch.TiledScan,
                                  "sweep_eig", sweep_unchanged),
        "selection altered": ("tiny_ex.scan", engine_torch,
                              "forward_select", index_altered),
        "matrix-free selection altered": ("tiny_mf.scan", bigscan,
                                          "forward_select_matfree",
                                          index_altered),
        "eigenbasis altered": ("tiny_ex.scan", engine_torch, "eigh_basis",
                               eigh_altered),
        "matrix-free CG state unchanged": ("tiny_mf.scan",
                                           engine_torch.TiledScan,
                                           "device_cg", cg_unchanged),
        "matrix-free logdet altered": ("tiny_mf.scan", bigscan.ShiftedKrylov,
                                       "logdet", logdet_altered),
    }


@pytest.mark.parametrize("fault", ["k1 answer altered", "k1 half the batch",
                                   "k3 state unchanged",
                                   "mmt half the batch",
                                   "sweep state unchanged",
                                   "selection altered",
                                   "matrix-free selection altered",
                                   "eigenbasis altered",
                                   "matrix-free CG state unchanged",
                                   "matrix-free logdet altered"])
def test_fault_makes_the_run_not_correct(tiny_root, fault):
    cell, obj, attr, make = _faults()[fault]
    with patched(obj, attr, make):
        run, line = tiny.run_tiny(tiny_root, cell, seed=77)
    assert line["correct"] is False, line["compared"]
    bad = [k for k, (v, lim) in line["compared"].items()
           if not v <= lim or np.isnan(v)]
    assert bad or line["failed"], line
