"""Shared input assembly for the scan-level API functions: trait vector,
fixed-effects design, NA bookkeeping, Zmat alignment (reference: the
``check.inputs`` / ``indxNA`` preamble of ``AM()``, SURVEY.md §3.2)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np

from eagleeverything_tpu_torch.api.design import build_design, na_rows
from eagleeverything_tpu_torch.api.read import GenoHandle, PhenoHandle


@dataclasses.dataclass
class PreparedInputs:
    y: np.ndarray              # trait, NA rows dropped
    X0: np.ndarray             # base design, NA rows dropped
    xnames: list[str]
    keep: np.ndarray           # kept record indices
    dropped: np.ndarray        # dropped record indices (indxNA)
    handle: GenoHandle
    Z: Optional[np.ndarray]    # NA-filtered incidence matrix or None
    # keep_records to pass to the engine when individuals must be dropped
    keep_individuals: Optional[np.ndarray]


def prepare_inputs(
    trait: str,
    geno: Union[GenoHandle, np.ndarray],
    pheno: Union[PhenoHandle, dict, np.ndarray],
    fformula: Optional[str],
    Zmat: Optional[np.ndarray],
) -> PreparedInputs:
    if isinstance(pheno, PhenoHandle):
        columns = pheno.columns
    elif isinstance(pheno, dict):
        columns = {k: np.asarray(v) for k, v in pheno.items()}
    else:
        columns = None
    if columns is not None:
        if trait not in columns:
            raise KeyError(
                f"trait {trait!r} is not a phenotype column; "
                f"available: {sorted(columns)}"
            )
        y_full = np.asarray(columns[trait], dtype=np.float64)
    else:
        y_full = np.asarray(pheno, dtype=np.float64)
        columns = {trait or "trait": y_full}

    n_rec = y_full.shape[0]
    X_full, xnames = build_design(columns, fformula, n_rec)

    # every design column is NA-checked (an all-ones intercept is inert;
    # under '-1' formulas column 0 is a real term)
    used = [y_full] + [X_full[:, j] for j in range(X_full.shape[1])]
    drop = na_rows(*used)
    keep = np.setdiff1d(np.arange(n_rec), drop)
    y = y_full[keep]
    X0 = X_full[keep]

    handle = geno if isinstance(geno, GenoHandle) else None
    if handle is None:
        arr = np.asarray(geno)
        handle = GenoHandle(n=arr.shape[0], p=arr.shape[1],
                            source="<array>", geno=arr)

    Z = Zmat
    keep_individuals = None
    if Z is not None:
        # a copy only when records are dropped: at biobank n a dense Z is
        # tens of GB, nearly all of it zero pages never written
        Z = np.asarray(Z, dtype=np.float64)
        if len(keep) != n_rec:
            Z = Z[keep]
        if Z.shape[1] != handle.n:
            raise ValueError(
                f"Zmat has {Z.shape[1]} columns but genotypes have "
                f"{handle.n} individuals"
            )
    else:
        if handle.n != n_rec:
            raise ValueError(
                f"{n_rec} phenotype records vs {handle.n} genotyped "
                "individuals — supply Zmat for unbalanced designs"
            )
        if len(keep) != n_rec:
            keep_individuals = keep

    return PreparedInputs(
        y=y, X0=X0, xnames=xnames, keep=keep, dropped=drop,
        handle=handle, Z=Z, keep_individuals=keep_individuals,
    )
