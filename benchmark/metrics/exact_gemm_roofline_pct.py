"""exact_gemm_roofline_pct: the share of their bound at which the exact
engine's products ran, ``kernels.mmt_accumulate`` (K += Wᵀ·W) and
``kernels.eig_T_tile`` (T = W·U): the sum of each call's least time
(``yardstick.gemm_bound`` of its FLOPs and bytes) over the device time of
the kernels those calls launched, from the device trace."""

import yardstick


def read(run):
    if not run.profile:
        return None
    least = sum(yardstick.gemm_bound(*yardstick.mmt_work(t, n)) / 1e3
                for t, n, _ in run.shapes.get("mmt_accumulate", []))
    least += sum(yardstick.gemm_bound(*yardstick.eig_t_work(t, n, m)) / 1e3
                 for t, n, m in run.shapes.get("eig_T_tile", []))
    spent = sum(run.profile["range_device_s"].get(k, 0.0)
                for k in ("mmt_accumulate", "eig_T_tile"))
    return 100.0 * least / spent if least > 0 and spent > 0 else None
