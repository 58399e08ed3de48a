"""The genotype products of the matrix-free engine's hand-written kernels,
K1 ``packed_dot`` (D = W·A), K2 ``packed_tdot`` (Wᵀ·T) and K3
``kernel_matvec`` (Wᵀ·(W·V), K1 then K2), as the timed calls ran them.

Kept in the window: in the first call, the first launch of each kernel at
each width; in every call, one more launch of each kernel at an index drawn
from (seed, call). Of each kept launch, columns (and of K1's result, rows)
drawn from the seed go to the host as they come. Once the window has closed the reference forms the same product
in float64 from its own draws of the genotypes; the number compared is the
widest error as a share of the result's scale, over the kept launches of
each kernel, for each kernel that the configuration gives a limit (on the
CPU ``kernel_matvec`` computes its product without ``packed_tdot``).
"""

import numpy as np
import torch

import reference

KINDS = ("packed_dot", "packed_tdot", "kernel_matvec")
GAPS = {"packed_dot": "k1_gap", "packed_tdot": "k2_gap",
        "kernel_matvec": "k3_gap"}
DRAW_BELOW = 512        # launches a call from which the extra one is drawn
KEEP_COLS = 16          # columns kept of a launch's operand and result
KEEP_ROWS = 4096        # rows kept of packed_dot's result


class Check:
    def __init__(self, run):
        self.run = run
        self.samples = []           # see _keep
        self.widths = set()         # (kind, r) kept from the first call
        self.count = dict.fromkeys(KINDS, 0)
        self.call = 0
        self._draw(0)

    def _draw(self, call):
        rng = np.random.default_rng([self.run.seed, 3, call])
        self.pick = {k: int(rng.integers(0, DRAW_BELOW)) for k in KINDS}

    def targets(self):
        from eagleeverything_tpu_torch.ops import packed
        return {k: (packed, k) for k in KINDS}

    def listen(self, name, args, out):
        if name not in KINDS:
            return
        X = args[1]
        i = self.count[name]
        self.count[name] += 1
        first = self.call == 0 and (name, X.shape[1]) not in self.widths
        if first:
            self.widths.add((name, X.shape[1]))
        if first or i == self.pick[name]:
            self.samples.append(self._keep(name, X, out, i))

    def _keep(self, name, X, out, i):
        """Up to KEEP_COLS columns of the launch's operand and result (the
        columns of a product are independent products), and of
        ``packed_dot``'s (p, r) result up to KEEP_ROWS rows, drawn from
        the seed, to the host: (kind, operand, result, rows or None)."""
        rng = np.random.default_rng([self.run.seed, 6, self.call, i])
        r = X.shape[1]
        cols = sorted(rng.choice(r, min(KEEP_COLS, r), replace=False)
                      .tolist())
        rows = None
        if name == "packed_dot":
            p = out.shape[0]
            rows = torch.as_tensor(np.sort(rng.choice(
                p, min(KEEP_ROWS, p), replace=False)))
            out = out[rows.to(out.device)]
        return (name, X[:, cols].cpu(), out[:, cols].cpu(), rows)

    def observe(self, call, traits, results):
        self.call = call + 1
        self.count = dict.fromkeys(KINDS, 0)
        self._draw(self.call)

    def _gaps(self, control):
        gaps = reference.packed_products(self.run.cohort.cfg, self.run.seed,
                                         self.samples, self.run.device,
                                         control=control)
        out = {}
        limits = self.run.cell.cfg["limits"]
        for kind in (k for k in KINDS if GAPS[k] in limits):
            got = [g for (k, *_), g in zip(self.samples, gaps) if k == kind]
            # no launch kept: nothing was checked, which is not correct
            out[GAPS[kind]] = max(got) if got else float("inf")
        return out

    def judge(self):
        return self._gaps(control=False)

    def control(self):
        return self._gaps(control=True)
