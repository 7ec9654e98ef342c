"""The frozen yardstick: the bounds at PERF.md's shapes, the data streams
repeating from their seed, and the kernel groups."""

import pytest
import torch

from portbench import data, peaks, profgroup


@pytest.mark.parametrize("kernel, n, k, cd, ms", [
    ("gram_matvec_symmetric", 100_000, 1, None, 6.567),        # K2, exact, k = 1
    ("gram_matmat", 100_000, 500, None, 60.606),               # K1 wide, the sketch
    ("gram_matvec_symmetric_tier", 1_000_000, 1, "bf16x3", 119.567),  # K2b at 1M
])
def test_bound_ms_at_perf_shapes(kernel, n, k, cd, ms):
    bound, by = peaks.bound_ms(kernel, n, n, 28, k, "rbf", cd)
    assert round(bound, 3) == ms
    assert by == "operations"


def test_tier_tc_ops_counts_passes():
    assert peaks.tier_tc_ops(10.0, 4.0, 28, 1, "bf16x3") == 10.0 * 2 * 28 * 3
    assert peaks.tier_tc_ops(10.0, 4.0, 28, 17, "bfloat16") == 10.0 * 2 * 28 + 4.0


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 12345678901234])
def test_streams_repeat_from_their_seed(seed):
    X1, X2 = data.points(seed, 300, 28, "cpu"), data.points(seed, 300, 28, "cpu")
    assert torch.equal(X1, X2)
    y1 = data.target(seed, 3, X1, 2, 0.1)
    assert torch.equal(y1, data.target(seed, 3, X2, 2, 0.1))
    assert not torch.equal(y1, data.target(seed, 4, X1, 2, 0.1))
    assert not torch.equal(X1, data.points(seed + 1, 300, 28, "cpu"))
    rows = data.sample_rows(seed, 1000, 64)
    assert torch.equal(rows, data.sample_rows(seed, 1000, 64))
    assert rows.shape == (64,) and bool(torch.all(rows[1:] > rows[:-1]))
    assert torch.equal(data.sample_rows(seed, 50, None), torch.arange(50))
    assert 0 <= data.stream_seed(seed, "points") < 2**63


def test_target_recipe():
    X = data.points(5, 200, 28, "cpu")
    g = data.generator(5, "targets", 0, "cpu")
    w = torch.randn((28, 1), generator=g)
    eps = torch.randn((200, 1), generator=g)
    assert torch.equal(data.target(5, 0, X, 1, 0.1), torch.tanh(X @ w) + 0.1 * eps)


@pytest.mark.parametrize("name, group", [
    ("void tile_triangle<0, 1>(float const*, int)", "gram_matvec_symmetric"),
    ("void gram_tier_symmetric<0, 3, 1>(float const*)", "gram_matvec_symmetric_tier"),
    ("void gram_wide_tf32<0, 16>(float const*)", "gram_matmat"),
    ("void gram_comp_symmetric<0, 1, double>(double*)", "gram_matvec_symmetric_f64"),
    ("void gram_comp_finish<float, 0>(float*)", "gram_matvec_symmetric_comp"),
    ("void at::native::vectorized_elementwise_kernel<4>()", "other"),
])
def test_kernel_groups(name, group):
    assert profgroup._kernel_group(name) == group
