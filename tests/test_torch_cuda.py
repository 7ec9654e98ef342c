"""The hand-written CUDA Gram kernels against their plain PyTorch versions
(float64) on a card. Marked ``cuda``: they skip without one. This file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from rlaopt_tpu_torch.ops import kernel_cuda, kernel_plain

SQDIST_KINDS = ("rbf", "matern12", "matern32", "matern52")


def _data(seed, n, m, d, k):
    rng = np.random.default_rng(seed)
    X1 = rng.standard_normal((n, d)).astype(np.float32)
    X2 = rng.standard_normal((m, d)).astype(np.float32)
    V = rng.standard_normal((m, k)).astype(np.float32)
    return X1, X2, V


def _rel(got, ref):
    return ((got.double() - ref).abs().max() / ref.abs().max()).item()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", SQDIST_KINDS)
@pytest.mark.parametrize("k", [1, 3, 16, 70])
def test_cuda_matmat_matches_plain(cuda_device, kind, k):
    X1, X2, V = _data(7, 1000, 777, 3, k)
    args = [torch.from_numpy(a).to(cuda_device) for a in (X1, X2, V)]
    ref = kernel_plain.gram_matmat(kind, *[a.double() for a in args], 1.3, 0.9)
    got = kernel_cuda.gram_matmat(kind, *args, 1.3, 0.9)
    hi, lo = kernel_cuda.gram_matmat_comp(kind, *args, 1.3, 0.9)
    torch.cuda.synchronize()
    err = _rel(got, ref)
    err_comp = _rel(hi.double() + lo.double(), ref)
    assert err <= 2e-5
    assert err_comp <= err
    assert err_comp <= 1e-10


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 5, 16])
def test_cuda_symmetric_matches_plain(cuda_device, k):
    rng = np.random.default_rng(8)
    X = torch.from_numpy(rng.standard_normal((1300, 28)).astype(np.float32))
    V = torch.from_numpy(rng.standard_normal((1300, k)).astype(np.float32))
    X, V = X.to(cuda_device), V.to(cuda_device)
    ref = kernel_plain.gram_matvec_symmetric("rbf", X.double(), V.double(), 5.3)
    got = kernel_cuda.gram_matvec_symmetric("rbf", X, V, 5.3)
    torch.cuda.synchronize()
    assert _rel(got, ref) <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("kind", SQDIST_KINDS)
def test_cuda_ard_lengthscale(cuda_device, kind):
    """A (d,) lengthscale: K1 and K2 get points pre-scaled by the wrapper,
    K1c divides by it in float64 inside the kernel."""
    X1, X2, V = _data(9, 500, 300, 5, 3)
    ls = torch.tensor([0.7, 1.1, 1.9, 2.5, 0.9], device=cuda_device)
    args = [torch.from_numpy(a).to(cuda_device) for a in (X1, X2, V)]
    ref = kernel_plain.gram_matmat(kind, *[a.double() for a in args], ls.double())
    got = kernel_cuda.gram_matmat(kind, *args, ls)
    hi, lo = kernel_cuda.gram_matmat_comp(kind, *args, ls.double())
    Xs = args[0][:300]  # as many points as V has rows
    ref_sym = kernel_plain.gram_matvec_symmetric(
        kind, Xs.double(), args[2].double(), ls.double()
    )
    sym = kernel_cuda.gram_matvec_symmetric(kind, Xs, args[2], ls)
    torch.cuda.synchronize()
    assert _rel(got, ref) <= 2e-5
    assert _rel(hi.double() + lo.double(), ref) <= 1e-10
    assert _rel(sym, ref_sym) <= 2e-5


@pytest.mark.cuda
def test_cuda_launch_counts_and_refusals(cuda_device):
    X = torch.randn((300, 4), device=cuda_device)
    V = torch.randn((300, 17), device=cuda_device)
    kernel_cuda.reset_launch_counts()
    kernel_cuda.gram_matmat("rbf", X, X, V, 1.0)
    kernel_cuda.gram_matmat_comp("rbf", X, X, V[:, :2], 1.0)
    assert kernel_cuda.launch_counts() == {
        "gram_matmat": 1, "gram_matmat_comp": 1, "gram_matvec_symmetric": 0,
    }
    with pytest.raises(ValueError, match="k <= 16"):
        kernel_cuda.gram_matvec_symmetric("rbf", X, V, 1.0)
    with pytest.raises(NotImplementedError, match="float32 only"):
        kernel_cuda.gram_matmat("rbf", X.double(), X.double(), V.double(), 1.0)
    with pytest.raises(NotImplementedError, match="_laplace_matmat"):
        kernel_cuda.gram_matmat("laplace", X, X, V, 1.0)
    assert kernel_cuda.launch_counts()["gram_matvec_symmetric"] == 0
