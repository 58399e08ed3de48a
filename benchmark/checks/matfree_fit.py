"""The matrix-free engine's decision path, held to the plain reference of
its method (:mod:`reference_mf`, float64 on the card).

Kept in the window: every call's trait and result. Once the window has
closed, one call that completed is drawn from the seed, and the reference
fits the same models on its own draws of the genotypes: the base model,
then the base model with the call's selections added one at a time. The
numbers compared:

- ``mf_extbic_gap``: the call's extBIC path (the base model's and each
  accepted model's, so the REML fit, its δ search, the stochastic logdet
  and the exact solves) against the reference's, the widest gap as a
  share of the reference's value;
- ``mf_t_gap``: the statistic t of each selected SNP at the fit it was
  selected from (the sweep's exact rescoring: the device CG solves and the
  stat rows), the widest relative gap.

A window with no completed call has nothing judged, and is not correct.
"""

import numpy as np

import reference_mf

NUMBERS = ("mf_extbic_gap", "mf_t_gap")


class Check:
    def __init__(self, run):
        self.run = run
        self.kept = []          # (trait, indices, extbic_path, t, δ̂s) a trait
        self.notes = {}         # both sides' paths, for calibration
        self.deltas = []        # the program's δ̂ of this call, fit by fit

    def targets(self):
        from eagleeverything_tpu_torch.models import bigscan
        return {"reml_maximize_matfree": (bigscan, "reml_maximize_matfree")}

    def listen(self, name, args, out):
        """δ̂ of every fit of the window, for calibration's notes."""
        if name != "reml_maximize_matfree":
            return
        fit = out[0] if isinstance(out, tuple) else out
        self.deltas.append(float(fit.delta))

    def observe(self, call, traits, results):
        deltas, self.deltas = self.deltas, []
        if results is None:
            return
        for y, res in zip(traits, results):
            t = [float(res.outlier_stats[i][j])
                 for i, j in enumerate(res.indices)]
            self.kept.append((y, [int(j) for j in res.indices],
                              [float(e) for e in res.extbic_path], t,
                              deltas))

    def _readings(self, control: bool) -> dict:
        if not self.kept:
            return dict.fromkeys(NUMBERS, float("inf"))
        rng = np.random.default_rng([self.run.seed, 7])
        pick = int(rng.integers(0, len(self.kept)))
        y, sel, path, t, deltas = self.kept[pick]
        args = (self.run.cohort.cfg, self.run.seed, self.run.device, y, sel,
                self.run.cell.traffic.get("lam", 1.0))
        ref = reference_mf.matfree_scan(*args)
        if control:             # the TF32 reference in the program's place
            ctl = reference_mf.matfree_scan(*args, control=True)
            path, t = ctl["extbic_path"], ctl["t"]
        self.notes["mf" + (".control" if control else "")] = {
            "extbic": path, "t": t, "delta": deltas,
            "ref": ref}
        e, r = np.asarray(path), np.asarray(ref["extbic_path"])
        k = min(len(e), len(r))
        gap_e = float(np.max(np.abs(e[:k] - r[:k]) / np.abs(r[:k]),
                             initial=0.0))
        if len(e) != len(r):
            gap_e = float("inf")
        a, b = np.asarray(t), np.asarray(ref["t"])
        gap_t = float(np.max(np.abs(a - b) / np.abs(b), initial=0.0))
        return {"mf_extbic_gap": gap_e, "mf_t_gap": gap_t}

    def judge(self):
        return self._readings(control=False)

    def control(self):
        """The readings of the reference computed with TF32 products."""
        return self._readings(control=True)
