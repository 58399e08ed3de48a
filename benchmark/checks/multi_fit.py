"""``am_multi``'s lockstep matrix-free scan, held trait by trait to the
plain reference of its method (:mod:`reference_mf`, float64 on the card).

What a call of ``am_multi`` promises: each of its traits gets the fits
that a single-trait scan of that trait alone would make along the same
selections (the union Krylov basis is, column by column, the single-trait
basis, and every decision value is polished by an exact solve). So the
reference builds its dense kernel once and fits each trait on its own:
the base model, then the trait's selections added one at a time. Every
trait of the judged call is fitted, so that a trait's result handed to
another trait's slot shows.

Kept in the window: every completed call's traits and results, and of one
wide stat-row pass a call (``TiledScan.matfree_stat_rows_multi``: all the
call's traits side by side in one K1 launch; the call's first pass, then
the pass drawn from (seed, call) when there is one) columns of that
launch's operand and rows and columns of its result, drawn from the seed.
Once the window has closed, one completed call is drawn from the seed.
The numbers compared:

- ``multi_extbic_gap``: every trait's extBIC path (the base model's and
  each accepted model's) against the reference's, the widest gap over the
  traits as a share of the reference's value;
- ``multi_t_gap``: the statistic t of each trait's selected SNPs at the
  fit each was selected from, the widest relative gap over the traits;
- ``wide_k1_gap``: the kept K1 launch of the drawn call's wide pass
  against the f64 product of the reference's own draws, the widest error
  as a share of the result's scale (:func:`reference.packed_products`).

A window with no completed call, or a judged call without a kept wide
launch, has nothing judged, and is not correct.
"""

import numpy as np
import torch

import reference
import reference_mf

NUMBERS = ("multi_extbic_gap", "multi_t_gap", "wide_k1_gap")
KEEP_COLS = 16          # columns kept of the wide launch's operand, result
KEEP_ROWS = 4096        # rows (SNPs) kept of its result


def path_gap(got, ref) -> float:
    """The widest gap of two extBIC paths as a share of the reference's
    values; inf when their lengths differ."""
    e, r = np.asarray(got, float), np.asarray(ref, float)
    if len(e) != len(r):
        return float("inf")
    return float(np.max(np.abs(e - r) / np.abs(r), initial=0.0))


def rel_gap(got, ref) -> float:
    a, b = np.asarray(got, float), np.asarray(ref, float)
    return float(np.max(np.abs(a - b) / np.abs(b), initial=0.0))


def trait_fits(op, ld, cfg: dict, seed: int, device, y: np.ndarray,
               selected: list, lam: float) -> dict:
    """:func:`reference_mf.matfree_scan` on a kernel and a logdet basis
    built once for every trait: {extbic_path, t, delta}."""
    n, p = cfg["n_individuals"], cfg["n_snps"]
    cols = [reference_mf.column(cfg, seed, int(j), device) for j in selected]
    X = np.ones((n, 1))
    fit = reference_mf.reml_fit(op, ld, y, X, w=cols[0] if cols else None)
    path = [reference.extbic(fit["loglik"], n, p, 0, lam)]
    ts, deltas = [], [fit["delta"]]
    for k, w in enumerate(cols):
        ts.append(fit["t"])
        X = np.column_stack([X, w])
        fit = reference_mf.reml_fit(
            op, ld, y, X, hint=fit["delta"],
            w=cols[k + 1] if k + 1 < len(cols) else None)
        path.append(reference.extbic(fit["loglik"], n, p, k + 1, lam))
        deltas.append(fit["delta"])
    return {"extbic_path": path, "t": ts, "delta": deltas}


def reference_scans(cfg: dict, seed: int, device, ys: list, sels: list,
                    lam: float, control: bool = False) -> list:
    """Each trait's fits along its selections, on one dense kernel of the
    reference's own draws (TF32 products for the control)."""
    reference._ieee()
    n = cfg["n_individuals"]
    op = reference_mf.Kernel(reference_mf.dense_kernel(cfg, seed, device),
                             control)
    ld = reference_mf.Krylov(
        op, torch.as_tensor(reference_mf.rademacher(
            reference_mf.LD_SEED, n, reference_mf.LD_PROBES), device=device),
        reference_mf.LD_M, reorth=False)
    out = [trait_fits(op, ld, cfg, seed, device, y, sel, lam)
           for y, sel in zip(ys, sels)]
    del op, ld
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


class Check:
    def __init__(self, run):
        self.run = run
        self.kept = []          # (traits, [(sel, path, t)], wide) a call
        self.notes = {}         # both sides' paths, for calibration
        self.ref = None         # the f64 reference's fits, once computed
        self.last = None        # the latest K1 launch's (operand, result)
        self.wide = None        # this call's kept wide launch
        self._start(0)

    def _start(self, call):
        self.call, self.passes, self.wide = call, 0, None
        rng = np.random.default_rng([self.run.seed, 8, call])
        self.pick = int(rng.integers(0, max(self.run.cell.maxit, 1)))

    def targets(self):
        from eagleeverything_tpu_torch.models import engine_torch
        from eagleeverything_tpu_torch.ops import packed
        return {"packed_dot": (packed, "packed_dot"),
                "matfree_stat_rows_multi": (engine_torch.TiledScan,
                                            "matfree_stat_rows_multi")}

    def listen(self, name, args, out):
        if name == "packed_dot":
            # not copied: only the launch that ends a wide pass is kept
            self.last = (args[1], out)
        elif name == "matfree_stat_rows_multi":
            last, self.last = self.last, None
            # a pass of the whole resident stack in one launch
            if (self.passes in (0, self.pick) and last is not None
                    and last[1].shape[0] == self.run.cohort.p):
                self.wide = self._keep(*last)
            self.passes += 1

    def _keep(self, X, D):
        """Columns of the launch's operand and result, and rows of its
        result, drawn from the seed, to the host: a sample as
        :func:`reference.packed_products` takes it."""
        rng = np.random.default_rng([self.run.seed, 9, self.call,
                                     self.passes])
        r, p = X.shape[1], D.shape[0]
        cols = sorted(rng.choice(r, min(KEEP_COLS, r), replace=False)
                      .tolist())
        rows = torch.as_tensor(np.sort(rng.choice(p, min(KEEP_ROWS, p),
                                                  replace=False)))
        return ("packed_dot", X[:, cols].cpu(),
                D[rows.to(D.device)][:, cols].cpu(), rows)

    def observe(self, call, traits, results):
        if results is not None:
            got = []
            for res in results:
                t = [float(res.outlier_stats[i][j])
                     for i, j in enumerate(res.indices)]
                got.append(([int(j) for j in res.indices],
                            [float(e) for e in res.extbic_path], t))
            self.kept.append((list(traits), got, self.wide))
        self.last = None
        self._start(call + 1)

    def _readings(self, control: bool) -> dict:
        if not self.kept:
            return dict.fromkeys(NUMBERS, float("inf"))
        rng = np.random.default_rng([self.run.seed, 7])
        traits, got, wide = self.kept[int(rng.integers(0, len(self.kept)))]
        cfg, seed, dev = self.run.cohort.cfg, self.run.seed, self.run.device
        lam = self.run.cell.traffic.get("lam", 1.0)
        sels = [sel for sel, _, _ in got]
        if self.ref is None:
            self.ref = reference_scans(cfg, seed, dev, traits, sels, lam)
        paths = [path for _, path, _ in got]
        ts = [t for _, _, t in got]
        if control:             # the TF32 reference in the program's place
            ctl = reference_scans(cfg, seed, dev, traits, sels, lam,
                                  control=True)
            paths = [c["extbic_path"] for c in ctl]
            ts = [c["t"] for c in ctl]
        self.notes["multi" + (".control" if control else "")] = {
            "extbic": paths, "t": ts, "ref": self.ref}
        out = {"multi_extbic_gap": max(path_gap(e, r["extbic_path"])
                                       for e, r in zip(paths, self.ref)),
               "multi_t_gap": max(rel_gap(t, r["t"])
                                  for t, r in zip(ts, self.ref))}
        out["wide_k1_gap"] = (float("inf") if wide is None else
                              reference.packed_products(
                                  cfg, seed, [wide], dev,
                                  control=control)[0])
        return out

    def judge(self):
        return self._readings(control=False)

    def control(self):
        """The readings of the reference computed with TF32 products."""
        return self._readings(control=True)
