"""The plain reference: what the timed calls compute, worked out again from
the benchmark's own genotype draws (:mod:`cohort`) in plain PyTorch and
NumPy, in float64 on the device, in blocks of SNPs so that it fits beside
nothing. It imports nothing of the program: it draws the genotypes again,
recodes them (W = dose − 1) and forms its own exact kernel, products, REML
fits and statistics. One thing of the program's it reads, to judge it: the
exact engine's eigenbasis. Its fp32 eigendecomposition of the uncentred
kernel is as far from an f64 one, in the statistics it leads to, as a
reference in TF32 is, so no comparison of the scan with an f64 scan of its
own could tell a sound program from one in TF32. The scan is therefore
followed in the program's eigenbasis (:class:`ExactScan` ``basis``), and the
eigendecomposition is judged by itself against the exact kernel
(:func:`eig_residuals`), where fp32 and TF32 do part.

Each function also has a ``control`` form: the same reference computed in
TF32, the precision next below the configuration's IEEE fp32 (every operand
of a product other than the genotypes, which TF32 holds exactly, rounded to
TF32's 10-bit mantissa, the products summed in fp32). Run on the card at a
cell's own size, it must come out not correct.

The REML and extBIC functions are frozen copies of
``eagleeverything_tpu_torch/models/reml_core.py`` (``reml_loglik_diag``
:167, ``reml_maximize_diag`` :206, ``independent_cols`` :147,
``log_choose`` :265, ``extbic`` :272): the configuration's own statement of
Eagle's exact method (EMMA's REML, FaST-LMM's eigenbasis, the extended BIC
of Chen & Chen).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy import linalg as sla
from scipy import optimize as _opt
from scipy.special import gammaln

import cohort as cohort_mod


# ---------------------------------------------------------------------------
# precision
# ---------------------------------------------------------------------------


def tf32(x: torch.Tensor) -> torch.Tensor:
    """An f32 tensor rounded to TF32 (10-bit mantissa, to nearest even)."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    b = (b + (0xFFF + ((b >> 13) & 1))) & -8192
    return b.view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, control: bool) -> torch.Tensor:
    """a·b: in the tensors' own f64, or, for the control, on TF32-rounded
    operands with the products summed in IEEE fp32."""
    if not control:
        return a @ b
    return tf32(a) @ tf32(b)


def _ieee() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def gap(got, ref) -> float:
    """max |got − ref| over max |ref|: the widest error as a share of the
    result's scale (0 for two empty or two zero results)."""
    got = torch.as_tensor(got, dtype=torch.float64)
    ref = torch.as_tensor(ref, dtype=torch.float64)
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    err = float((got - ref).abs().max()) if ref.numel() else 0.0
    return err / scale if scale > 0 else err


def column_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max over columns of (max |got − ref| over max |ref|) in that
    column."""
    err = (got.double() - ref).abs().amax(dim=0)
    scale = ref.abs().amax(dim=0)
    return float(torch.where(scale > 0, err / scale, err).max())


# ---------------------------------------------------------------------------
# genotype products of the packed-stack kernels
# ---------------------------------------------------------------------------


def packed_products(cfg: dict, seed: int, samples: list, device,
                    control: bool = False) -> list[float]:
    """The gap of each kept launch's result to the reference product.

    ``samples``: (kind, operand, result, rows) host f32 tensors of calls of
    ``packed_dot`` (D = W·A, A (n, r) → (p, r); ``rows`` the SNPs of D
    kept), ``packed_tdot`` (Wᵀ·T, T (p, r) → (n, r)) or ``kernel_matvec``
    (Wᵀ·(W·V), V (n, r) → (n, r)). With ``control`` the result judged is
    the TF32 reference's, not the program's."""
    _ieee()
    n = cfg["n_individuals"]
    state = []
    for kind, X, out, rows in samples:
        shape = (len(rows) if kind == "packed_dot" else n, X.shape[1])
        state.append({"X": X.to(device, torch.float64),
                      "acc": torch.zeros(shape, dtype=torch.float64,
                                         device=device),
                      "ctl": torch.zeros(shape, dtype=torch.float32,
                                         device=device),
                      "rows": None if rows is None else rows.to(device)})
    for j0, G in cohort_mod.blocks(cfg, seed, device):
        W = G.to(torch.float64) - 1.0
        W32 = W.to(torch.float32)           # exact: W is -1, 0 or 1
        b = W.shape[0]
        for (kind, _, _, _), st in zip(samples, state):
            X = st["X"]
            if kind == "packed_dot":
                at = ((st["rows"] >= j0) & (st["rows"] < j0 + b)).nonzero()[:, 0]
                if at.numel():
                    Wr = W[st["rows"][at] - j0]
                    st["acc"][at] = Wr @ X
                    if control:
                        st["ctl"][at] = _mm(Wr, X, True)
            elif kind == "packed_tdot":
                st["acc"] += W.T @ X[j0:j0 + b]
                if control:
                    st["ctl"] += _mm(W32.T, X[j0:j0 + b], True)
            else:
                st["acc"] += W.T @ (W @ X)
                if control:
                    st["ctl"] += _mm(W32.T, _mm(W32, X, True), True)
    return [gap(st["ctl"] if control else out.to(device), st["acc"])
            for (_, _, out, _), st in zip(samples, state)]


def tile_products(cfg: dict, seed: int, tiles: list, U, device,
                  control: bool = False) -> tuple[float, float]:
    """The exact engine's T = W·U tiles kept from a timed call: (the share
    of kept genotypes that differ between a tile's recoded rows and the
    reference's draws of the same SNPs, the widest error of the kept
    columns of T = W·U as a share of each column's scale: a column of U,
    an eigenvector, sets the scale of its column of T, and the mean
    component's is a hundred times the bulk's).

    ``tiles``: (rows, W rows as dosages int8 (k, n), cols, T[:, cols]
    (b, c), b) host tensors, row 0 the tile's first; ``U`` the program's
    eigenbasis (its own state) the tiles were multiplied by. With
    ``control`` the product judged is the TF32 reference's."""
    _ieee()
    U64 = torch.as_tensor(U, device=device).to(torch.float64)
    where = locate_rows(cfg, seed, [Wr[0] for _, Wr, _, _, _ in tiles],
                        device)
    differ, worst = 0.0, 0.0
    for (rows, Wr, cols, Tc, b), j0 in zip(tiles, where):
        G = rows_of(cfg, seed, j0, b, device)
        differ = max(differ, float((G[rows] != Wr.to(device)).double()
                                   .mean()))
        W = G.to(torch.float64) - 1.0
        Uc = U64[:, cols]
        want = W @ Uc
        got = _mm(W, Uc, True) if control else Tc.to(device)
        worst = max(worst, column_gap(got, want))
    return differ, worst


# ---------------------------------------------------------------------------
# the exact method (MMt, one eigendecomposition, REML in its basis)
# ---------------------------------------------------------------------------


def independent_cols(X: np.ndarray) -> np.ndarray:
    """X reduced to a maximal linearly independent column subset (pivoted
    QR, original order kept)."""
    if X.shape[1] == 0:
        return X
    _, R, piv = sla.qr(X, mode="economic", pivoting=True)
    diag = np.abs(np.diag(R))
    if diag.size == 0 or diag[0] == 0.0:
        return X[:, :0]
    tol = max(X.shape) * np.finfo(np.float64).eps * diag[0]
    return X[:, np.sort(piv[:int(np.sum(diag > tol))])]


def reml_loglik_diag(delta, d, y_star, X_star, q, ld2) -> float:
    """Restricted log-likelihood in K's eigenbasis (EMMA's convention)."""
    n = d.shape[0]
    nq = n - q
    w = 1.0 / (d + delta)
    Xw = X_star * w[:, None]
    XtHiX = Xw.T @ X_star
    b = Xw.T @ y_star
    yPy = float(y_star @ (w * y_star) - b @ np.linalg.solve(XtHiX, b))
    if yPy <= 0:
        return -math.inf
    s1, ld1 = np.linalg.slogdet(XtHiX)
    if s1 <= 0:
        return -math.inf
    logdetH = float(np.sum(np.log(d + delta)))
    return 0.5 * (nq * math.log(nq / (2.0 * math.pi)) - nq
                  - nq * math.log(yPy) - (logdetH + ld1 - ld2))


def reml_maximize_diag(d, y_star, X_star, llim=-10.0, ulim=10.0,
                       ngrids=100) -> dict:
    """Maximise the eigenbasis LL(δ): a log grid, then bounded Brent
    around every interior grid maximum. {delta, loglik, sigma2_g}."""
    d = np.maximum(np.asarray(d, dtype=np.float64), 0.0)
    X_star = independent_cols(np.asarray(X_star, dtype=np.float64))
    q = X_star.shape[1]
    ld2 = np.linalg.slogdet(X_star.T @ X_star)[1] if q else 0.0
    grid = np.exp(np.linspace(llim, ulim, ngrids + 1))
    lls = np.array([reml_loglik_diag(g, d, y_star, X_star, q, ld2)
                    for g in grid])
    cands = [(grid[0], lls[0]), (grid[-1], lls[-1])]
    for i in range(1, ngrids):
        if lls[i] > lls[i - 1] and lls[i] > lls[i + 1]:
            res = _opt.minimize_scalar(
                lambda g: -reml_loglik_diag(g, d, y_star, X_star, q, ld2),
                bounds=(grid[i - 1], grid[i + 1]), method="bounded",
                options={"xatol": 1e-12})
            cands.append((float(res.x), -float(res.fun)))
    delta, loglik = max(cands, key=lambda c: c[1])
    w = 1.0 / (d + delta)
    Xw = X_star * w[:, None]
    b = Xw.T @ y_star
    yPy = float(y_star @ (w * y_star)
                - b @ np.linalg.solve(Xw.T @ X_star, b))
    return {"delta": float(delta), "loglik": float(loglik),
            "sigma2_g": yPy / (d.shape[0] - q)}


def extbic(loglik: float, n: int, p: int, k: int, lam: float) -> float:
    """−2·LL + k·log n + 2·λ·log C(p, k)."""
    log_choose = float(gammaln(p + 1) - gammaln(k + 1) - gammaln(p - k + 1))
    return -2.0 * loglik + k * math.log(n) + 2.0 * lam * log_choose


def exact_kernel(cfg: dict, seed: int, device) -> torch.Tensor:
    """The raw MMt K = W·Wᵀ (n, n) f64 on the device: sums of products of
    −1, 0 and 1, exact."""
    n = cfg["n_individuals"]
    K = torch.zeros((n, n), dtype=torch.float64, device=device)
    for _, G in cohort_mod.blocks(cfg, seed, device):
        W = G.to(torch.float64) - 1.0
        K.addmm_(W.T, W)
    return K


def normalized(K: torch.Tensor) -> torch.Tensor:
    """K over the mean of its diagonal."""
    return K / K.diagonal().mean()


RESID_QUANTILES = (0.1, 0.25, 0.5, 0.9, 1.0)


def eig_residuals(K: torch.Tensor, d, U) -> dict:
    """The eigenpair residuals ‖K̃·u_i − d_i·u_i‖ / max |d| of an
    eigendecomposition (d, U) of K̃ = K / mean(diag K), in f64, against the
    exact K: {"max", "med", "q<k>" for each of RESID_QUANTILES}. The lower
    quantiles are what the precision of the eigendecomposition moves (a
    handful of columns of the fp32 solver read ~20 times its median, as
    high as those of one that reads its input in TF32); the max is what a
    wrong eigenpair moves."""
    U = torch.as_tensor(U, device=K.device).to(torch.float64)
    d = torch.as_tensor(np.asarray(d, np.float64), device=K.device)
    scale = float(K.diagonal().mean())
    norms = torch.empty(U.shape[1], dtype=torch.float64, device=K.device)
    step = 4096                 # columns a product, so that it fits
    for c0 in range(0, U.shape[1], step):
        Uc = U[:, c0:c0 + step]
        R = (K @ Uc) / scale - Uc * d[c0:c0 + step]
        norms[c0:c0 + step] = torch.linalg.vector_norm(R, dim=0)
    norms /= d.abs().max()
    qs = torch.quantile(norms.cpu(), torch.tensor(RESID_QUANTILES,
                                                  dtype=torch.float64))
    out = {f"q{q:g}": float(v) for q, v in zip(RESID_QUANTILES, qs)}
    out.update(max=float(norms.max()), med=out["q0.5"])
    return out


def eig_control(K: torch.Tensor, dtype) -> dict:
    """:func:`eig_residuals` of the eigendecomposition in fp32 of K̃ read in
    ``dtype``: TF32 (rounded to its 10-bit mantissa, as a TF32 product
    would read it) or bf16."""
    Kn = normalized(K).to(torch.float32)
    Kn = tf32(Kn) if dtype == "tf32" else Kn.to(torch.bfloat16).float()
    d, U = torch.linalg.eigh(Kn)
    del Kn
    return eig_residuals(K, d.double().cpu().numpy(), U)


def locate_rows(cfg: dict, seed: int, rows: list, device) -> list[int]:
    """The SNP index of each given genotype row (int8 dosages (n,)), found
    by a random fingerprint of every row of the cohort."""
    n = cfg["n_individuals"]
    gen = torch.Generator(device=device)
    gen.manual_seed(12345)
    r = torch.randn(n, dtype=torch.float64, device=device, generator=gen)
    prints = torch.cat([G.to(torch.float64) @ r
                        for _, G in cohort_mod.blocks(cfg, seed, device)])
    return [int(torch.argmin((prints - torch.as_tensor(
        row, device=device).to(torch.float64) @ r).abs()))
        for row in rows]


def rows_of(cfg: dict, seed: int, j0: int, count: int, device
            ) -> torch.Tensor:
    """Dosages int8 (count, n) of SNPs [j0, j0 + count), drawn again."""
    B = cohort_mod.BLOCK
    parts = []
    for b0 in range(j0 // B * B, j0 + count, B):
        G = cohort_mod.genotype_block(cfg, seed, b0, device)
        lo, hi = max(j0, b0) - b0, min(j0 + count, b0 + G.shape[0]) - b0
        parts.append(G[lo:hi])
    return torch.cat(parts)


class ExactScan:
    """Eagle's exact scan of one cohort, for any number of traits: the
    kernel K = W·Wᵀ / mean(diag), its eigendecomposition K = U·diag(d)·Uᵀ,
    T = Wᵀ·U (one row a SNP), then for each trait the forward selection:
    REML in the eigenbasis, the outlier statistic t_j = â_j² / var(â_j)
    with â = Wᵀ·P̃·y and var(â_j) = σ²_g·(Wᵀ·P̃·W)_jj for every SNP, the
    argmax, and its acceptance while extBIC falls.

    ``basis`` = (d, U) gives the eigendecomposition to follow (the
    program's own, whose stage :func:`eig_residuals` judges by itself);
    without it the reference decomposes K itself."""

    def __init__(self, cfg: dict, seed: int, device, control: bool = False,
                 basis=None):
        _ieee()
        self.cfg, self.seed, self.device = cfg, seed, device
        self.control = control
        dt = torch.float32 if control else torch.float64
        p = cfg["n_snps"]
        self.K = exact_kernel(cfg, seed, device)
        if basis is None:
            d, U = torch.linalg.eigh(normalized(self.K).to(dt))
            d = d.double().cpu().numpy()
        else:
            d, U = basis
            U = torch.as_tensor(U, device=device).to(
                torch.float32 if control else torch.float64)
        self.d = np.maximum(np.asarray(d, np.float64), 0.0)
        self.U = U
        n = U.shape[0]
        self.T = torch.empty((p, n), dtype=dt, device=device)
        for j0, G in cohort_mod.blocks(cfg, seed, device):
            W = (G.to(torch.float64) - 1.0).to(dt)
            self.T[j0:j0 + W.shape[0]] = _mm(W, U, control)

    def project(self, M: np.ndarray) -> np.ndarray:
        """Uᵀ·M, host f64."""
        Md = torch.as_tensor(np.ascontiguousarray(M), device=self.device,
                             dtype=self.U.dtype)
        return _mm(self.U.T, Md, self.control).double().cpu().numpy()

    def column(self, j: int) -> np.ndarray:
        """The recoded genotypes of SNP j, host f64."""
        j0 = j // cohort_mod.BLOCK * cohort_mod.BLOCK
        G = cohort_mod.genotype_block(self.cfg, self.seed, j0, self.device)
        return G[j - j0].double().cpu().numpy() - 1.0

    def sweep(self, fit: dict, y_star: np.ndarray, Xs: np.ndarray
              ) -> np.ndarray:
        """t of every SNP at the fit: with s = (d + δ)^(-1/2) and Q an
        orthonormal basis of diag(s)·Uᵀ·X, P̃·y = U·z3 for
        z3 = s ∘ (I − QQᵀ)(s ∘ Uᵀy) and (Wᵀ·P̃·W)_jj = ‖T_j∘s‖² −
        ‖(T_j∘s)·Q‖²."""
        s = 1.0 / np.sqrt(self.d + fit["delta"])
        Q, _ = np.linalg.qr(independent_cols(Xs) * s[:, None])
        z1 = s * y_star
        z3 = s * (z1 - Q @ (Q.T @ z1))
        dt = self.T.dtype
        s_d, Q_d, z3_d = (torch.as_tensor(a, dtype=dt, device=self.device)
                          for a in (s, Q, z3))
        out = torch.empty(self.T.shape[0], dtype=torch.float64,
                          device=self.device)
        for i0 in range(0, self.T.shape[0], cohort_mod.BLOCK):
            T = self.T[i0:i0 + cohort_mod.BLOCK]
            ahat = _mm(T, z3_d[:, None], self.control)[:, 0]
            Ts = T * s_d
            TQ = _mm(Ts, Q_d, self.control)
            vara = fit["sigma2_g"] * ((Ts * Ts).sum(1) - (TQ * TQ).sum(1))
            out[i0:i0 + T.shape[0]] = torch.where(
                vara > 1e-12, ahat * ahat / vara, 0.0).double()
        return out.cpu().numpy()

    def scan(self, y: np.ndarray, maxit: int, lam: float = 1.0) -> dict:
        """{indices, extbic_path, t: [per iteration]} of one trait, with
        the intercept as the base design."""
        n, p = y.shape[0], self.T.shape[0]
        X = np.ones((n, 1))
        y_star, Xs = self.project(y), self.project(X)
        fit = reml_maximize_diag(self.d, y_star, Xs)
        best = extbic(fit["loglik"], n, p, 0, lam)
        selected, path, stats = [], [best], []
        for _ in range(maxit):
            t = self.sweep(fit, y_star, Xs)
            t[selected] = 0.0
            stats.append(t)
            cand = int(np.argmax(t))
            if t[cand] <= 0.0:
                break
            w = self.column(cand)
            Xs_new = np.hstack([Xs, self.project(w)[:, None]])
            fit_new = reml_maximize_diag(self.d, y_star, Xs_new)
            ebic = extbic(fit_new["loglik"], n, p, len(selected) + 1, lam)
            if not ebic < best:
                break
            selected.append(cand)
            X = np.hstack([X, w[:, None]])
            Xs, fit, best = Xs_new, fit_new, ebic
            path.append(ebic)
        return {"indices": selected, "extbic_path": path, "t": stats}


def t_gap(got: np.ndarray, ref: np.ndarray) -> float:
    """max_j |t_j − t_ref,j| / max(t_ref,j, 1): relative where a SNP
    scores above 1, absolute below (most SNPs score about 1)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1.0),
                        initial=0.0))


def scan_gaps(got: dict, ref: dict) -> dict:
    """The gaps of one trait's scan to the reference's: whether the
    selections differ (1) or not (0), the extBIC path's widest relative
    gap, and the statistics' widest gap over the sweeps both ran on the
    same model."""
    same = list(got["indices"]) == list(ref["indices"])
    k = min(len(got["extbic_path"]), len(ref["extbic_path"]))
    e = np.asarray(got["extbic_path"][:k], np.float64)
    r = np.asarray(ref["extbic_path"][:k], np.float64)
    ebic = float(np.max(np.abs(e - r) / np.abs(r), initial=0.0))
    # sweep i runs on the model of the first i selections
    agree = 0
    while (agree < min(len(got["indices"]), len(ref["indices"]))
           and got["indices"][agree] == ref["indices"][agree]):
        agree += 1
    tg = max((t_gap(a, b) for a, b in
              list(zip(got["t"], ref["t"]))[:agree + 1]), default=0.0)
    return {"selection": 0 if same else 1, "extbic": ebic, "t": tg}
