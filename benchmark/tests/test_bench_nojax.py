"""Nothing the benchmark runs imports JAX or the JAX package; the check
compares whole top-level module names, since the port's name begins with
the JAX package's."""

import ast
import subprocess
import sys
import textwrap

import tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "eagleeverything_tpu"}


def test_forbidden_modules_compares_top_level_names(monkeypatch):
    import harness
    fake = {"eagleeverything_tpu_torch": object(),
            "eagleeverything_tpu_torch.ops": object(),
            "jaxtyping": object(), "flaxen": object()}
    monkeypatch.setattr(sys, "modules", fake)
    assert harness.forbidden_modules() == []
    monkeypatch.setattr(sys, "modules",
                        dict(fake, **{"eagleeverything_tpu.ops": object(),
                                      "jax.numpy": object()}))
    assert harness.forbidden_modules() == ["eagleeverything_tpu", "jax"]


def test_no_source_of_the_benchmark_imports_them():
    for path in tiny.BENCH.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, (path, n)


def test_a_run_loads_none_of_them(tiny_root):
    """A whole CPU run of a tiny cell in a fresh process, then a look at
    what it loaded."""
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(tiny.BENCH / 'tests')!r})
        from pathlib import Path
        import tiny
        harness = tiny.harness_on(Path({str(tiny_root)!r}))
        run, line = tiny.run_tiny(Path({str(tiny_root)!r}), "tiny_ex.scan")
        assert line["correct"], line
        print("FOUND", harness.forbidden_modules())
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(tiny.ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOUND []" in out.stdout
