"""The sweep's probe Krylov basis (``MatfreeContext.isqrt_probes``) is
cached for the whole call when it fits the Krylov cache budget at the size
it is held: the device Lanczos's (r_pad, m, n) f32 basis where that hook
is wired, the host recurrence's f64 basis where it is not.

On the CPU, where the port's device Lanczos runs its plain torch steps:
a matrix-free ``am()`` over three sweeps, at a budget between the basis's
f32 and f64 counts, builds it once (the ``probes`` spans count ``cached``
0, then 1, 1) and gives the results of a run under the f32 count, which
builds it every sweep, bit for bit; ``am_multi`` (two traits, through
``isqrt_probes_shifts``) does the same; and with a Zmat that is not
one-hot (no device hook) the f64 count still decides."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import eagleeverything_tpu_torch as port  # noqa: E402
from eagleeverything_tpu_torch.data.simulate import simulate_dataset  # noqa: E402
from eagleeverything_tpu_torch.models.bigscan import ShiftedKrylov  # noqa: E402
from eagleeverything_tpu_torch.utils.config import EagleConfig  # noqa: E402

N, P, MAXIT = 400, 2000, 3
# the probe basis at EagleConfig's defaults (128 probe columns, 40 steps)
F32 = ShiftedKrylov.device_bytes(N, 128, 40)        # 8.2 MB
F64 = ShiftedKrylov.cache_bytes(N, 128, 40)         # 16.4 MB
# both budgets hold every [X y] basis of these scans (at most 2.1 MB)
BETWEEN = EagleConfig(matfree_cache_gb=(F32 + F64) / 2 / 1e9)
UNDER = EagleConfig(matfree_cache_gb=F32 / 2 / 1e9)


@pytest.fixture(scope="module")
def sim():
    return simulate_dataset(n=N, p=P, n_qtl=3, seed=21, h2_qtl=0.6)


def _logged(fn, tmp_path, name, **kw):
    log = str(tmp_path / f"{name}.jsonl")
    res = fn(log_jsonl=log, maxit=MAXIT, engine="matfree", device="cpu",
             **kw)
    with open(log) as f:
        return res, [json.loads(ln) for ln in f if ln.strip()]


def _probes(events):
    """(each ``probes`` span's ``cached`` counter in order, the number of
    ``krylov_basis`` spans under them, the call's stack passes)."""
    spans = [e for e in events if e.get("event") == "phase"]
    probes = [e for e in spans if e["phase"] == "probes"]
    ids = {e["id"] for e in probes}
    builds = sum(1 for e in spans if e["phase"] == "krylov_basis"
                 and e["parent"] in ids)
    passes = next(e["total"] for e in events
                  if e.get("event") == "stack_passes")
    return [e["cached"] for e in probes], builds, passes


def _same(a, b):
    """Selections, extBIC and LL paths, every sweep's statistics and the
    final fit, bit for bit."""
    assert list(a.indices) == list(b.indices)
    assert list(a.extbic_path) == list(b.extbic_path)
    assert list(a.loglik_path) == list(b.loglik_path)
    assert len(a.outlier_stats) == len(b.outlier_stats)
    for s, t in zip(a.outlier_stats, b.outlier_stats):
        assert np.array_equal(s, t)
    assert (a.delta, a.sigma2_g, a.sigma2_e) == (b.delta, b.sigma2_g,
                                                 b.sigma2_e)


@pytest.fixture(scope="module")
def singles(sim, tmp_path_factory):
    d = tmp_path_factory.mktemp("probe_cache")
    return {name: _logged(lambda **kw: port.am("y", sim.geno, {"y": sim.y},
                                               **kw), d, name, config=cfg)
            for name, cfg in (("between", BETWEEN), ("under", UNDER))}


def test_a_budget_between_the_counts_builds_the_basis_once(singles):
    res, events = singles["between"]
    cached, builds, _ = _probes(events)
    assert len(res.indices) == MAXIT
    assert cached == [0] + [1] * (len(cached) - 1) and len(cached) >= 2
    assert builds == 1


def test_a_basis_built_every_sweep_gives_the_same_scan(singles):
    res, events = singles["under"]
    cached, builds, passes = _probes(events)
    assert cached == [0] * len(cached) and builds == len(cached)
    _same(singles["between"][0], res)
    # each build is one 40-step Lanczos, a stack pass a step
    once = _probes(singles["between"][1])[2]
    assert passes - once == (builds - 1) * 40


def test_am_multi_builds_the_basis_once_for_every_trait(sim, tmp_path):
    rng = np.random.default_rng(3)
    traits = {"a": sim.y, "b": sim.y + 0.5 * rng.standard_normal(N)}
    out = {}
    for name, cfg in (("between", BETWEEN), ("under", UNDER)):
        out[name] = _logged(lambda **kw: port.am_multi(
            list(traits), sim.geno, traits, **kw), tmp_path, name,
            config=cfg)
    cached, builds, _ = _probes(out["between"][1])
    assert cached == [0] + [1] * (len(cached) - 1) and len(cached) >= 2
    assert builds == 1
    cached, builds, _ = _probes(out["under"][1])
    assert cached == [0] * len(cached) and builds == len(cached)
    for t in traits:
        _same(out["between"][0][t], out["under"][0][t])


def test_without_the_device_hook_the_f64_count_decides(tmp_path):
    """A weighted Zmat (not one-hot) gets no device Lanczos: the probe
    basis is a host f64 one, over the budget that caches the card's f32
    basis, so every sweep runs the host recurrence; over its f64 count it
    is cached."""
    sim = simulate_dataset(n=N // 2, p=P, n_qtl=3, seed=22, h2_qtl=0.6)
    Z = np.kron(np.eye(N // 2), np.ones((2, 1)))
    Z *= np.where(np.arange(N) % 3 == 0, 0.5, 1.0)[:, None]
    y = Z @ sim.y + 0.3 * np.random.default_rng(4).standard_normal(N)
    cached = {}
    for name, cfg in (("between", BETWEEN),
                      ("over", EagleConfig(matfree_cache_gb=2 * F64 / 1e9))):
        _, events = _logged(lambda **kw: port.am(
            "y", sim.geno, {"y": y}, Zmat=Z, **kw), tmp_path, name,
            config=cfg)
        cached[name] = _probes(events)[:2]
    n_sweeps = len(cached["between"][0])
    assert n_sweeps >= 2
    assert cached["between"] == ([0] * n_sweeps, 0)
    assert cached["over"] == ([0] + [1] * (n_sweeps - 1), 1)
