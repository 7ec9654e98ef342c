"""The plain reference against a dense float64 solve, the TF32 rounding of
the control, and what the benchmark's modules import."""

import ast
import math
from pathlib import Path

import pytest
import torch

from portbench.reference import rbf_krr

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "rlaopt_tpu"}


def _dense(X, ls):
    X = X.double() / ls
    sq = (X * X).sum(1)
    return torch.exp(-0.5 * torch.clamp(sq[:, None] + sq[None, :] - 2 * X @ X.T, min=0))


@pytest.mark.parametrize("n, rows", [(300, None), (300, 97)])
def test_residual_matches_dense_solve(n, rows):
    gen = torch.Generator().manual_seed(3)
    X = torch.randn((n, 5), generator=gen)
    y = torch.randn((n, 2), generator=gen, dtype=torch.float64)
    ls, reg = 2.0, 0.3
    K = _dense(X, ls)
    W = torch.linalg.solve(K + reg * torch.eye(n, dtype=torch.float64), y)
    idx = torch.arange(n) if rows is None else torch.randperm(n, generator=gen)[:rows]
    # the exact solution: the residual is float64 round-off
    assert float(rbf_krr.residual_norms(X, y, W, reg, ls, idx).max()) < 1e-10 * float(
        torch.linalg.norm(y))
    # any other W: the dense residual, over the rows
    W2 = torch.randn((n, 2), generator=gen, dtype=torch.float64)
    r = (y - (K @ W2 + reg * W2))[idx]
    want = torch.linalg.norm(r, dim=0) * math.sqrt(n / idx.shape[0])
    got = rbf_krr.residual_norms(X, y, W2, reg, ls, idx)
    assert torch.allclose(got, want, rtol=1e-12, atol=0)
    assert torch.allclose(rbf_krr.gram_apply(X, idx, W2, ls, block_values=1000),
                          (K @ W2)[idx], rtol=1e-12, atol=1e-12)


def test_tf32_round():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -1.0 - 2**-10 - 2**-12, 3.0e-3])
    got = rbf_krr.tf32_round(x)
    # ties to even at 2^-11 (half a TF32 step at 1), the rest to nearest
    assert got.tolist()[:4] == [1.0, 1.0, 1.0 + 2**-9, -1.0 - 2**-10]
    assert abs(got[4] - x[4]) <= 2**-11 * float(x[4])
    bits = got.view(torch.int32)
    assert bool(torch.all(bits & 0x1FFF == 0))


def test_tf32_control_is_off_by_tf32_rounding():
    gen = torch.Generator().manual_seed(4)
    X = torch.randn((400, 28), generator=gen)
    V = torch.randn((400, 1), generator=gen, dtype=torch.float64)
    rows = torch.arange(400)
    exact = rbf_krr.gram_apply(X, rows, V, 28**0.5)
    f32 = rbf_krr.gram_apply(X, rows, V.float(), 28**0.5, torch.float32).double()
    tf32 = rbf_krr.gram_apply(X, rows, V.float(), 28**0.5, torch.float32, tf32=True).double()
    err = lambda a: float((a - exact).abs().max() / exact.abs().max())  # noqa: E731
    assert err(f32) < 1e-5 < err(tf32)


def _imports(path: Path):
    """Top-level names of the modules a file imports (relative imports are
    the benchmark's own and left out)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_nothing_the_benchmark_runs_imports_jax():
    files = [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]
    assert any(p.name == "run.py" for p in files)
    for p in files:
        found = _imports(p) & FORBIDDEN
        assert not found, f"{p.relative_to(BENCH)} imports {found}"


def test_reference_imports_nothing_of_the_program():
    for p in (BENCH / "reference").glob("*.py"):
        found = {m for m in _imports(p) if m.startswith("rlaopt_tpu")} | (
            _imports(p) - {"torch", "numpy", "math"})
        assert not found, f"reference/{p.name} imports {found}"


def test_import_walk_sees_a_forbidden_name(tmp_path):
    p = tmp_path / "bad.py"
    p.write_text("import numpy\nfrom rlaopt_tpu.models import LinSys\nimport rlaopt_tpu_torch\n")
    assert _imports(p) == {"numpy", "rlaopt_tpu", "rlaopt_tpu_torch"}
    # whole top-level names: the port's name begins with the JAX package's
    assert _imports(p) & FORBIDDEN == {"rlaopt_tpu"}
