"""Fixed-effects design-matrix construction from a formula string.

Reference: the internal ``constructX``-style function that expands
``fformula`` over phenotype columns plus one column per selected marker
(SURVEY.md §3.2; the reference consumes an R formula in ``AM()``'s
``fformula`` argument [K: R/AM.R]). The rebuild supports the R-formula
surface the reference exercises:

- ``a + b``        — additive terms
- ``a:b``          — interaction (product; factor levels crossed)
- ``a*b``          — expands to ``a + b + a:b``
- ``-1`` / ``+0``  — remove the intercept
- ``log(a)``, ``sqrt(a)``, ``exp(a)``, ``abs(a)``, ``I(a^2)`` —
  numeric transforms (a safe, explicit subset — no arbitrary code)

Numeric columns enter as-is; string/factor columns are dummy-coded
dropping the first level; an intercept is included unless removed.
Unsupported grammar raises with the supported surface listed.
"""

from __future__ import annotations

import re
from typing import Optional

import numpy as np

_TRANSFORMS = {
    "log": np.log,
    "log2": np.log2,
    "log10": np.log10,
    "sqrt": np.sqrt,
    "exp": np.exp,
    "abs": np.abs,
}

_GRAMMAR_HELP = (
    "supported formula grammar: column names joined with '+', "
    "interactions 'a:b', crossings 'a*b' (= a + b + a:b), intercept "
    "removal '-1'/'+0', and transforms log()/log2()/log10()/sqrt()/"
    "exp()/abs()/I(col^k) of numeric columns"
)


def _column(pheno: dict, name: str):
    if name not in pheno:
        raise KeyError(
            f"formula term {name!r} is not a phenotype column; "
            f"available: {sorted(pheno)}")
    return pheno[name]


def _factor_parts(term: str, pheno: dict, n: int
                  ) -> list[tuple[str, np.ndarray]]:
    """Expand ONE atomic term (a bare column or a transform call) into
    (name, column) factors: a numeric column is itself; a string/factor
    column is its dummy codes (first level dropped)."""
    m = re.fullmatch(r"I\(\s*([A-Za-z_]\w*)\s*\^\s*(\d+)\s*\)", term)
    if m:
        col = np.asarray(_column(pheno, m.group(1)))
        if not np.issubdtype(col.dtype, np.number):
            raise ValueError(f"I({m.group(1)}^k) needs a numeric column")
        return [(term, col.astype(np.float64) ** int(m.group(2)))]
    m = re.fullmatch(r"([A-Za-z_]\w*)\(\s*([A-Za-z_]\w*)\s*\)", term)
    if m:
        fn, name = m.group(1), m.group(2)
        if fn not in _TRANSFORMS:
            raise ValueError(
                f"unsupported transform {fn!r} in formula; {_GRAMMAR_HELP}")
        col = np.asarray(_column(pheno, name))
        if not np.issubdtype(col.dtype, np.number):
            raise ValueError(f"{fn}({name}) needs a numeric column")
        return [(term, _TRANSFORMS[fn](col.astype(np.float64)))]
    if not re.fullmatch(r"[A-Za-z_]\w*", term):
        raise ValueError(
            f"cannot parse formula term {term!r}; {_GRAMMAR_HELP}")
    col = _column(pheno, term)
    arr = np.asarray(col)
    if np.issubdtype(arr.dtype, np.number):
        return [(term, arr.astype(np.float64))]
    s = arr.astype(str)
    levels = sorted(set(s))
    return [(f"{term}{lev}", (s == lev).astype(np.float64))
            for lev in levels[1:]]  # drop first level (baseline)


def build_design(
    pheno: dict[str, np.ndarray],
    fformula: Optional[str],
    n: int,
) -> tuple[np.ndarray, list[str]]:
    """Build (X, column_names) from the phenotype table and formula RHS."""
    cols: list[np.ndarray] = []
    names: list[str] = []
    intercept = True
    if fformula:
        rhs = fformula.split("~")[-1].strip()
        # split on +/- at top level (no parens nesting beyond one call)
        pieces = re.split(r"(?<![\^(])\s*([+-])\s*", " " + rhs)
        # pieces = ['', term?, sep, term, sep, term...]; normalize
        terms: list[tuple[str, str]] = []   # (sign, text)
        sign = "+"
        for piece in pieces:
            piece = piece.strip()
            if piece in ("+", "-"):
                sign = piece
                continue
            if piece:
                terms.append((sign, piece))
                sign = "+"
        for sgn, term in terms:
            if term in ("1", "0"):
                if (sgn == "-" and term == "1") or (sgn == "+" and term == "0"):
                    intercept = False
                continue
            if sgn == "-":
                raise ValueError(
                    f"term removal '-{term}' is not supported (only '-1'); "
                    + _GRAMMAR_HELP)
            # a*b*... → all additive terms + all interactions
            if "*" in term:
                atoms = [a.strip() for a in term.split("*") if a.strip()]
                import itertools
                for r in range(1, len(atoms) + 1):
                    for combo in itertools.combinations(atoms, r):
                        _emit_interaction(list(combo), pheno, n, cols, names)
            else:
                _emit_interaction(
                    [a.strip() for a in term.split(":") if a.strip()],
                    pheno, n, cols, names)
    if intercept:
        cols.insert(0, np.ones(n))
        names.insert(0, "(Intercept)")
    if not cols:
        raise ValueError("formula removed the intercept and has no terms")
    X = np.column_stack(cols)
    return X, names


def _emit_interaction(atoms: list[str], pheno: dict, n: int,
                      cols: list[np.ndarray], names: list[str]) -> None:
    """Append the (crossed) columns for one ':'-joined term; duplicate
    names (e.g. from a*b expansion re-emitting a) are skipped."""
    parts = [_factor_parts(a, pheno, n) for a in atoms]
    import itertools
    for combo in itertools.product(*parts):
        name = ":".join(nm for nm, _ in combo)
        if name in names:
            continue
        col = np.ones(n)
        for _, c in combo:
            col = col * c
        cols.append(col)
        names.append(name)


def na_rows(*arrays: np.ndarray) -> np.ndarray:
    """Indices of records with any missing value across the given columns
    (reference: the ``indxNA`` bookkeeping in ``AM()``, SURVEY.md §3.2)."""
    n = len(arrays[0])
    bad = np.zeros(n, dtype=bool)
    for a in arrays:
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.number):
            bad |= ~np.isfinite(a.astype(np.float64))
        else:
            s = a.astype(str)
            bad |= (s == "NA") | (s == "nan") | (s == "")
    return np.where(bad)[0]
