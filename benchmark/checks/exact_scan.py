"""The exact eigenbasis engine's calls, held to the plain reference of
Eagle's exact method (:mod:`reference`, float64 on the card).

The program decomposes its kernel in fp32 (cuSOLVER), and the kernel's top
eigenvalue, the genotypes' mean component, is thousands of times its bulk:
that eigendecomposition alone moves a statistic by about 2% and an extBIC
by about 2e-5 from an f64 one, as much as the reference in TF32 does. So
the reference follows the program's own eigenbasis through the scan (what
it reads of the program's state), and judges that stage by itself against
the exact kernel: the tenth percentile of the eigenpair residuals, which
an fp32 solver on an fp32 kernel keeps about 4.5 times below one that
reads the kernel in TF32.

Kept in the window, from one call drawn from the seed among the first two
(the first call's is kept until the drawn call starts, which it then ends
inside the window; a window of one call judges that call): the MMt (the host array ``TiledScan.compute_K`` returns, not copied), the
eigenbasis ``eigh_basis`` returned (d, and U copied to the host), two
``eig_T_tile`` launches (the first and one drawn from the seed: the
recoded tile as dosages and T, on the host), and the call's selections,
extBIC path and statistics (``AMResult.outlier_stats``: t of every SNP at
every sweep). The numbers compared:

- ``mmt_gap``: the MMt's widest error over its scale (exact: 0);
- ``eig_resid_q10`` and ``eig_resid``: the tenth percentile and the
  largest over i of ‖K̃·u_i − d_i·u_i‖ / max |d| of the program's
  eigenbasis against the reference's exact K̃ (the percentile moves with
  the precision, the largest with a wrong eigenpair);
- ``unpack_gap``: the share of kept genotypes of the W tiles that differ
  from the reference's draws (exact: 0);
- ``tgemm_gap``: the kept columns of T = W·U against the f64 product of
  the reference's W and the program's U, each as a share of its column's
  scale;
- ``sel_mismatch``, ``extbic_gap``, ``t_gap``: the call's selections (0 if
  equal), extBIC path (widest relative gap) and statistics (widest gap,
  relative above 1, absolute below) against the reference's scan of the
  same trait in the program's eigenbasis.
"""

import numpy as np
import torch

import reference

PICK_BELOW = 2          # the judged call is drawn from the first two
DRAW_BELOW = 9          # T tiles of a sweep from which the extra one is drawn
KEEP = 64               # rows and columns kept of a T tile
NUMBERS = ("mmt_gap", "eig_resid", "eig_resid_q10", "unpack_gap",
           "tgemm_gap", "sel_mismatch", "extbic_gap", "t_gap")


class Check:
    def __init__(self, run):
        self.run = run
        rng = np.random.default_rng([run.seed, 4])
        self.pick_call = int(rng.integers(0, PICK_BELOW))
        self.pick_tile = int(rng.integers(1, DRAW_BELOW))
        self.call = 0
        self.notes = {}         # the residuals' quantiles, for calibration
        self.kept = self._empty()
        self.kept_call = 0
        # the eigenbasis is copied into page-locked memory made in set-up,
        # so that the copy in the window is one fast DMA
        n = run.cohort.n
        self.u_host = (torch.empty((n, n), dtype=torch.float32,
                                   pin_memory=True)
                       if torch.device(run.device).type == "cuda" else None)

    @staticmethod
    def _empty() -> dict:
        return {"K": None, "basis": None, "tiles": [], "scans": [],
                "seen": 0}

    def targets(self):
        from eagleeverything_tpu_torch.models import engine_torch
        from eagleeverything_tpu_torch.ops import kernels
        return {"compute_K": (engine_torch.TiledScan, "compute_K"),
                "eigh_basis": (engine_torch, "eigh_basis"),
                "eig_T_tile": (kernels, "eig_T_tile")}

    def listen(self, name, args, out):
        if self.call not in (0, self.pick_call):
            return
        if self.call != self.kept_call:
            # the drawn call has started, so it ends inside the window:
            # what the first call kept gives way to it
            self.kept, self.kept_call = self._empty(), self.call
        k = self.kept
        if name == "compute_K":
            k["K"] = out
        elif name == "eigh_basis":
            if out.host_f64 is not None:
                U = torch.from_numpy(np.array(out.host_f64))
            else:
                U = self.u_host.copy_(out.device_basis())
            k["basis"] = (np.array(out.d), U)
        elif name == "eig_T_tile":
            if k["seen"] in (0, self.pick_tile):
                k["tiles"].append(self._tile(args[0], out))
            k["seen"] += 1

    def _tile(self, Wt, T):
        """Rows of the recoded tile (its first and some drawn from the
        seed) and columns of T drawn from the seed, to the host."""
        rng = np.random.default_rng([self.run.seed, 5, self.kept["seen"]])
        b, m = T.shape
        rows = [0] + sorted(rng.choice(np.arange(1, b), min(KEEP, b - 1),
                                       replace=False).tolist())
        cols = sorted(rng.choice(m, min(KEEP, m), replace=False).tolist())
        return (rows, (Wt[rows] + 1).to(torch.int8).cpu(), cols,
                T[:, cols].cpu(), b)

    def observe(self, call, traits, results):
        if call == self.kept_call and results is not None:
            for y, res in zip(traits, results):
                self.kept["scans"].append(
                    (y, {"indices": list(res.indices),
                         "extbic_path": list(res.extbic_path),
                         "t": list(res.outlier_stats)}))
        self.call = call + 1

    def _readings(self, control: bool) -> dict:
        cfg, seed, dev = self.run.cohort.cfg, self.run.seed, self.run.device
        maxit = self.run.cell.maxit
        lam = self.run.cell.traffic.get("lam", 1.0)
        k = self.kept
        ref = reference.ExactScan(cfg, seed, dev, basis=k["basis"])
        out = dict.fromkeys(NUMBERS, 0.0)
        if control:
            for dtype in ("tf32", "bf16"):
                r = reference.eig_control(ref.K, dtype)
                self.notes[f"resid.{dtype}"] = r
                tag = "" if dtype == "tf32" else ".bf16"
                out["eig_resid" + tag] = r["max"]
                out["eig_resid_q10" + tag] = r["q0.1"]
            other = reference.ExactScan(cfg, seed, dev, control=True,
                                        basis=k["basis"])
        else:
            out["mmt_gap"] = reference.gap(torch.as_tensor(k["K"],
                                                           device=dev), ref.K)
            r = self.notes["resid"] = reference.eig_residuals(ref.K,
                                                              *k["basis"])
            out["eig_resid"], out["eig_resid_q10"] = r["max"], r["q0.1"]
        differ, out["tgemm_gap"] = reference.tile_products(
            cfg, seed, k["tiles"], k["basis"][1], dev, control=control)
        if not control:         # the control's tiles are its own draws
            out["unpack_gap"] = differ
        for y, got in k["scans"]:
            if control:
                got = other.scan(y, maxit, lam)
            g = reference.scan_gaps(got, ref.scan(y, maxit, lam))
            out["sel_mismatch"] += g["selection"]
            out["extbic_gap"] = max(out["extbic_gap"], g["extbic"])
            out["t_gap"] = max(out["t_gap"], g["t"])
        return out

    def judge(self):
        k = self.kept
        if (k["K"] is None or k["basis"] is None or not k["tiles"]
                or not k["scans"]):
            # nothing was kept, so nothing was checked: not correct
            return dict.fromkeys(NUMBERS, float("inf"))
        return self._readings(control=False)

    def control(self):
        """The readings of the reference computed in TF32: its products,
        and an fp32 eigendecomposition of K̃ read in TF32 (and, as
        ``.bf16``, of one that reads K̃ in bf16)."""
        return self._readings(control=True)
