"""#9's plan and its segmented schedule, on the CPU.

The CSR kernel runs only on a card (``tests/test_torch_cuda.py``, marked
``cuda``). Here its plan (``kernel_cuda.csr_plan``: the rows longer than a
segment, cut into segments) is held to the buffers it was built from, and
the wrapper ``kernel_cuda._csr_launch`` runs as written down to its two C
entry points, which are emulated on the host: they read the operands
through the pointers the wrapper passes and follow the kernels' order (the
short rows whole; each segment's partial sums; the partials of a long row
added in segment order, column chunk by column chunk). So the tests hold
the schedule's summation order to the plain version (``sparse.ops._plain``)
and to the JAX package's lane-aligned kernel in interpret mode, on numpy
buffers shaped like ``chip_smoke.py``'s ragged operands, and show which
schedule each of path S's operands takes.
"""

import contextlib
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from rlaopt_tpu.sparse.laned import csr_to_laned, laned_matmat
from rlaopt_tpu_torch.ops import kernel_cuda
from rlaopt_tpu_torch.sparse import SparseCSRTensor, sparse_aslinop
from rlaopt_tpu_torch.sparse import ops as tops

S = kernel_cuda.CSR_SEGMENT
F64 = 1e-12


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _csr(lengths, n_cols, seed):
    """A CSR of these row lengths in a shuffled order, each row's first
    column repeated; float64 values."""
    rng = np.random.default_rng(seed)
    lengths = np.array(lengths)
    rng.shuffle(lengths)
    indptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    indices = rng.integers(0, n_cols, indptr[-1]).astype(np.int32)
    starts = indptr[:-1][lengths >= 2]
    indices[starts + 1] = indices[starts]
    return rng.standard_normal(indptr[-1]), indices, indptr


def _ragged_rows(n_cols=5000, seed=23, reps=6):
    """``chip_smoke.ragged_rows_csr``'s lengths (0 to 20,000 entries), fewer
    of each, with rows of exactly S, S + 1 and 2S + 1."""
    base = [0, 1, 15, 16, 17, 33, 300, 20000, S, S + 1, 2 * S + 1]
    return _csr(base * reps, n_cols, seed)


def _ragged(n_cols=700, seed=21, n_rows=3000):
    """``chip_smoke.ragged_csr``'s lengths: 0 to 40 entries, every seventh
    row empty, every 500th of 300 to 1,200."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, 41, n_rows)
    lengths[::7] = 0
    lengths[3::500] = rng.integers(300, 1201, len(lengths[3::500]))
    return _csr(lengths, n_cols, seed + 1)


OPERANDS = {"ragged rows": (_ragged_rows, 5000), "ragged": (_ragged, 700)}


@pytest.mark.parametrize("segment", [S, 256, 128])
@pytest.mark.parametrize("name", list(OPERANDS))
def test_plan_covers_every_entry_once_in_order(name, segment):
    """Each row of more than ``segment`` entries is in the plan, in row
    order, cut into segments that tile its entries in order, all of
    ``segment`` entries but the last; no other row is; the counts, the
    longest row and the launch order (by index in the row, then row) agree
    with the buffers."""
    make, _ = OPERANDS[name]
    _, _, indptr = make()
    plan = kernel_cuda.csr_plan(torch.from_numpy(indptr), segment)
    lengths = np.diff(indptr)
    long = np.flatnonzero(lengths > segment)
    assert plan.n_rows == len(lengths) and plan.nnz == indptr[-1]
    assert plan.max_row == lengths.max() and plan.segment == segment
    assert plan.n_long == len(long) > 0 and plan.long_nnz == lengths[long].sum()
    np.testing.assert_array_equal(plan.rows.numpy(), long)
    assert plan.rows.dtype == torch.int32 and plan.order.dtype == torch.int32
    first, lo, hi = plan.first.numpy(), plan.lo.numpy(), plan.hi.numpy()
    assert first[0] == 0 and first[-1] == plan.n_segs == len(lo) == len(hi)
    covered = np.zeros(indptr[-1], np.int64)
    keys = []
    for i, r in enumerate(long):
        seg = range(first[i], first[i + 1])
        assert len(seg) == -(-lengths[r] // segment) >= 2
        assert lo[seg[0]] == indptr[r] and hi[seg[-1]] == indptr[r + 1]
        for j, g in enumerate(seg):
            assert lo[g] < hi[g] <= lo[g] + segment
            assert j == len(seg) - 1 or (hi[g] - lo[g] == segment and hi[g] == lo[g + 1])
            covered[lo[g]:hi[g]] += 1
            keys.append((j, i))
    in_long = np.zeros(indptr[-1], bool)
    for r in long:
        in_long[indptr[r]:indptr[r + 1]] = True
    assert np.all(covered[in_long] == 1) and not covered[~in_long].any()
    want = sorted(range(len(keys)), key=lambda g: keys[g])
    np.testing.assert_array_equal(plan.order.numpy(), want)


def test_plan_of_short_rows_holds_no_segments():
    """A CSR whose rows all fit a segment (path S's forward CSR, rows of
    16) has a plan of its sizes alone, and no segmented schedule at any k."""
    indptr = torch.arange(0, 16 * (1 << 20) + 1, 16, dtype=torch.int64)
    plan = kernel_cuda.csr_plan(indptr)
    assert (plan.n_rows, plan.nnz, plan.max_row, plan.n_long, plan.n_segs) == (
        1 << 20, 16 << 20, 16, 0, 0)
    assert plan.lo is None and plan.order is None
    assert not kernel_cuda.csr_segmented(plan)
    with pytest.raises(ValueError, match="segments of 0"):
        kernel_cuda.csr_plan(indptr, 0)


def _host(ptr, shape, ctype):
    return np.ctypeslib.as_array(ctypes.cast(ptr, ctypes.POINTER(ctype)), shape=shape)


class _CSREntries:
    """#9's two C entry points emulated on the host, with the arguments of
    their ctypes signatures. ``rl_csr_spmm``: every row whole;
    ``rl_csr_spmm_segmented``: the rows of at most ``segment`` entries
    whole, then per chunk of columns each segment's sums into ``part`` (in
    the launch order) and each long row's partials added in segment order.
    ``calls`` keeps each call's entry and schedule."""

    def __init__(self):
        self.calls = []

    @staticmethod
    def _buffers(dtype, indptr, indices, values, X, Y, n_rows, nnz, k):
        ct = ctypes.c_float if dtype == 0 else ctypes.c_double
        p = _host(indptr, (n_rows + 1,), ctypes.c_int64)
        c = _host(indices, (nnz,), ctypes.c_int32)
        v = _host(values, (nnz,), ct)
        x = _host(X, (int(c.max()) + 1, k), ct)
        return ct, p, c, v, x, _host(Y, (n_rows, k), ct)

    @staticmethod
    def _sum(c, v, x, lo, hi, cols):
        return (v[lo:hi, None] * x[c[lo:hi]][:, cols]).sum(0)

    def rl_csr_spmm(self, *args):
        assert len(args) == len(kernel_cuda._SIGNATURES["rl_csr_spmm"])
        dtype, indptr, indices, values, X, Y, n_rows, nnz, k, lanes, _s = args
        _, p, c, v, x, y = self._buffers(dtype, indptr, indices, values, X, Y, n_rows, nnz, k)
        for r in range(n_rows):
            y[r] = self._sum(c, v, x, p[r], p[r + 1], slice(None))
        self.calls.append({"entry": "rl_csr_spmm", "lanes": lanes, "k": k})
        return 0

    def rl_csr_spmm_segmented(self, *args):
        assert len(args) == len(kernel_cuda._SIGNATURES["rl_csr_spmm_segmented"])
        (dtype, indptr, indices, values, X, Y, part, seg_lo, seg_hi, seg_order, first, rows,
         n_rows, nnz, n_long, n_segs, segment, k, lanes, chunk, _s) = args
        ct, p, c, v, x, y = self._buffers(dtype, indptr, indices, values, X, Y, n_rows, nnz, k)
        pt = _host(part, (n_segs, chunk), ct)
        lo, hi = (_host(a, (n_segs,), ctypes.c_int64) for a in (seg_lo, seg_hi))
        order = _host(seg_order, (n_segs,), ctypes.c_int32)
        fst = _host(first, (n_long + 1,), ctypes.c_int64)
        rws = _host(rows, (n_long,), ctypes.c_int32)
        assert sorted(order) == list(range(n_segs))
        for r in range(n_rows):
            if p[r + 1] - p[r] <= segment:
                y[r] = self._sum(c, v, x, p[r], p[r + 1], slice(None))
        for c0 in range(0, k, chunk):
            kc = min(chunk, k - c0)
            for g in order:
                pt[g, :kc] = self._sum(c, v, x, lo[g], hi[g], slice(c0, c0 + kc))
            for i in range(n_long):
                acc = pt[fst[i], :kc].copy()
                for g in range(fst[i] + 1, fst[i + 1]):
                    acc += pt[g, :kc]
                y[rws[i], c0:c0 + kc] = acc
        self.calls.append({"entry": "rl_csr_spmm_segmented", "lanes": lanes, "k": k,
                           "chunk": chunk, "segment": segment, "n_long": n_long,
                           "n_segs": n_segs})
        return 0


@pytest.fixture
def card(monkeypatch):
    """CPU tensors through the card's route: ``is_cuda`` reads true, and
    #9's wrapper runs down to the emulated entries (``entries.calls``)."""
    entries = _CSREntries()
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(kernel_cuda, "build", lambda: None)
    monkeypatch.setattr(kernel_cuda, "_stream", lambda t: None)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setitem(kernel_cuda._lib, "handle", entries)
    return entries


def _on_host(values, indices, indptr, dtype=torch.float64):
    return (torch.from_numpy(values).to(dtype), torch.from_numpy(indptr),
            torch.from_numpy(indices))


@pytest.mark.parametrize("k", [1, 3, 10, 300])
@pytest.mark.parametrize("name", list(OPERANDS))
def test_segmented_order_matches_the_plain_product(card, name, k):
    """The ragged operands at every k of ``chip_smoke.py``: the long rows
    take the segmented schedule, the short rows their lanes from their own
    mean length; in float64 the segmented order (segments summed, then
    partials added in segment order) is the plain product's to 1e-12."""
    make, n_cols = OPERANDS[name]
    values, indices, indptr = make()
    v, p, c = _on_host(values, indices, indptr)
    X = torch.from_numpy(np.random.default_rng(k).standard_normal((n_cols, k)))
    plan = kernel_cuda.csr_plan(p)
    fn = kernel_cuda.csr_spmv if k == 1 else kernel_cuda.csr_spmm
    got = fn(v, p, c, X, len(indptr) - 1, plan)
    ref = tops._plain(v, p, c, X, len(indptr) - 1, False)
    assert _rel(got, ref) <= F64
    call, = card.calls
    lengths = np.diff(indptr)
    short = lengths <= S
    assert call["entry"] == "rl_csr_spmm_segmented" and call["n_long"] == (~short).sum()
    assert call["lanes"] == kernel_cuda.spmm_lanes(short.sum(), lengths[short].sum(), k)
    assert call["chunk"] == k and call["segment"] == S


def test_ragged_rows_short_lanes_follow_the_short_rows():
    """``ragged_rows_csr`` and a CSR of uniform rows with the same mean
    length (~2,548 entries) differ in schedule: the first is segmented, its
    short rows on the lanes of their own mean length (not a block of 256,
    as the mean of all rows would give); the second keeps every row whole,
    a block of 256 a row up to 16 columns."""
    lengths = np.tile([0, 1, 15, 16, 17, 33, 300, 20000], 40)
    ragged = kernel_cuda.csr_plan(torch.from_numpy(np.concatenate([[0], np.cumsum(lengths)])))
    uniform = kernel_cuda.csr_plan(torch.arange(0, 320 * 2548 + 1, 2548))
    assert abs(ragged.nnz / ragged.n_rows - uniform.nnz / uniform.n_rows) < 1
    assert kernel_cuda.csr_segmented(ragged) and uniform.n_long == 320
    short = lengths[lengths <= S]
    lanes = kernel_cuda.spmm_lanes(ragged.n_rows - ragged.n_long, ragged.nnz - ragged.long_nnz, 10)
    assert lanes == kernel_cuda.spmm_lanes(len(short), short.sum(), 10) < 32
    assert kernel_cuda.spmm_lanes(ragged.n_rows, ragged.nnz, 10) == kernel_cuda.CSR_BLOCK_ROW
    assert not kernel_cuda.csr_segmented(uniform)
    assert kernel_cuda.spmm_lanes(uniform.n_rows, uniform.nnz, 10) == kernel_cuda.CSR_BLOCK_ROW


@pytest.mark.parametrize("k", [1, 2, 3])
def test_segmented_order_matches_jax_laned(card, k):
    """A small ragged CSR (1,000 columns, within the JAX kernel's cap) with
    segments of 8 entries: the segmented order against the JAX package's
    ``laned_matmat`` in interpret mode, to the tolerance of
    ``test_csr_csc_products_match_jax_laned_and_scipy`` (1e-12)."""
    values, indices, indptr = _csr([0, 1, 3, 8, 9, 17, 40, 33, 0, 5] * 4, 1000, 41)
    v, p, c = _on_host(values, indices, indptr)
    X = np.random.default_rng(42).standard_normal((1000, k))
    plan = kernel_cuda.csr_plan(p, 8)
    got = kernel_cuda.csr_spmm(v, p, c, torch.from_numpy(X), len(indptr) - 1, plan)
    assert card.calls[-1]["entry"] == "rl_csr_spmm_segmented" and card.calls[-1]["segment"] == 8
    laned = csr_to_laned(values, indptr.astype(np.int32), indices, 1000)
    ref = laned_matmat(laned, jnp.asarray(X), len(indptr) - 1, interpret=True)
    assert _rel(got, ref) <= F64
    A = sp.csr_matrix((values, indices, indptr), shape=(len(indptr) - 1, 1000))
    assert _rel(got, A @ X) <= F64


def test_wide_columns_in_chunks(card, monkeypatch):
    """Past 16 columns the partial buffer is held within
    ``CSR_PART_BYTES`` by taking the columns in chunks of whole 128-column
    tiles (here a cap that takes 128 at a time of 300); the product is the
    plain one's. The sketch's shape at segments of 512 takes 2,048 columns
    at a time."""
    values, indices, indptr = _ragged_rows(reps=2)
    v, p, c = _on_host(values, indices, indptr)
    plan = kernel_cuda.csr_plan(p)
    X = torch.from_numpy(np.random.default_rng(43).standard_normal((5000, 300)))
    with monkeypatch.context() as mp:
        mp.setattr(kernel_cuda, "CSR_PART_BYTES", plan.n_segs * 200 * 8)
        got = kernel_cuda.csr_spmm(v, p, c, X, len(indptr) - 1, plan)
    assert card.calls[-1]["chunk"] == 128
    assert _rel(got, tops._plain(v, p, c, X, len(indptr) - 1, False)) <= F64
    assert kernel_cuda.csr_chunk(1024 * 16384 // 512, 4096, 4) == 2048
    assert kernel_cuda.csr_chunk(1024 * 16384 // 2048, 4096, 4) == 4096
    assert kernel_cuda.csr_chunk(10**6, 16, 8) == 16


def _adjoint_indptr(seed=5):
    """The row lengths of path S's adjoint CSR: the column counts of 2^24
    uniform column draws over 1,024 columns (~16,384 each)."""
    counts = np.random.default_rng(seed).multinomial(16 << 20, np.full(1024, 1 / 1024))
    return torch.from_numpy(np.concatenate([[0], np.cumsum(counts)]).astype(np.int64))


def test_path_s_shapes_keep_their_schedules(card, monkeypatch):
    """Path S's forward CSR (2^20 rows of 16) takes 4 lanes a row at k = 1
    and 10; its adjoint (1,024 rows of ~16,384, about one length) keeps
    every row whole: a block of 256 a row at k ≤ 16 and a warp per (row,
    column tile) at the sketch's k = 4,096; one entry call a product, the
    plan given and never rebuilt or read again."""
    fwd = kernel_cuda.csr_plan(torch.arange(0, 16 * (1 << 20) + 1, 16))
    adj = kernel_cuda.csr_plan(_adjoint_indptr())
    lengths = np.diff(_adjoint_indptr().numpy())
    assert fwd.n_long == 0 and adj.n_long == 1024
    assert adj.n_segs == sum(-(-n // S) for n in lengths)
    assert kernel_cuda.spmm_lanes(fwd.n_rows, fwd.nnz, 1) == 4
    assert not kernel_cuda.csr_segmented(adj)
    assert kernel_cuda.spmm_lanes(adj.n_rows, adj.nnz, 10) == kernel_cuda.CSR_BLOCK_ROW

    def refuse(*a, **kw):
        raise AssertionError("a product with its plan rebuilt it")

    # a small CSR of each kind, with the decisions of the path's plans
    small = {"forward": _csr([16] * 64, 32, 44), "adjoint": _csr([600] * 8, 900, 45)}
    plans = {name: kernel_cuda.csr_plan(torch.from_numpy(b[2])) for name, b in small.items()}
    monkeypatch.setattr(kernel_cuda, "csr_plan", refuse)
    for name, k, entry, lanes in (("forward", 1, "rl_csr_spmm", 4),
                                  ("forward", 10, "rl_csr_spmm", 4),
                                  ("adjoint", 1, "rl_csr_spmm", kernel_cuda.CSR_BLOCK_ROW),
                                  ("adjoint", 10, "rl_csr_spmm", kernel_cuda.CSR_BLOCK_ROW),
                                  ("adjoint", 300, "rl_csr_spmm", 32)):
        values, indices, indptr = small[name]
        v, p, c = _on_host(values, indices, indptr, torch.float32)
        n_cols = int(indices.max()) + 1
        X = torch.ones((n_cols, k))
        before = len(card.calls)
        kernel_cuda.csr_spmm(v, p, c, X, len(indptr) - 1, plans[name])
        assert len(card.calls) == before + 1
        assert card.calls[-1]["entry"] == entry and card.calls[-1]["lanes"] == lanes


def test_plan_is_built_once_and_shared_by_t_views(monkeypatch):
    """A tensor builds its CSR's plan at most once, and the CSR of its
    transpose's once; ``.T`` views share both; a product on the card takes
    the kept plan, and the wrapper refuses a plan of other buffers."""
    built = []
    real = kernel_cuda.csr_plan

    def counted(indptr, segment=None):
        built.append(indptr)
        return real(indptr, segment)

    monkeypatch.setattr(kernel_cuda, "csr_plan", counted)
    values, indices, indptr = _ragged_rows(reps=1)
    A = SparseCSRTensor(values, indices, indptr, (len(indptr) - 1, 5000), device="cpu")
    plan = A._csr_plan()
    assert A.T.T._csr_plan() is plan and A._csr_plan() is plan
    plan_t = A.T._csr_plan()
    assert A.T.T.T._csr_plan() is plan_t and plan_t is not plan
    assert len(built) == 2 and built[0] is A.indptr and built[1] is A.T._csr_buffers()[2]
    assert plan_t.n_rows == 5000 and plan_t.nnz == A.nnz
    sparse_aslinop(A) @ torch.ones(5000, dtype=torch.float64)  # the host builds none
    assert len(built) == 2
    v, c, p = A.values, A.indices, A.indptr
    with pytest.raises(ValueError, match="other buffers"):
        monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
        kernel_cuda.csr_spmm(v, p, c, torch.ones((5000, 2), dtype=torch.float64), A.shape[0],
                             plan_t)


def test_card_products_take_the_kept_plans(card, monkeypatch):
    """On the card (``is_cuda``), ``A @ x`` and ``A.T @ y`` and the
    operator of ``sparse_aslinop`` take the tensor's kept plans: built once
    each, at the first product or at the operator's construction."""
    built = []
    real = kernel_cuda.csr_plan
    monkeypatch.setattr(kernel_cuda, "csr_plan",
                        lambda indptr, segment=None: built.append(indptr) or real(indptr, segment))
    values, indices, indptr = _ragged_rows(reps=1)
    A = SparseCSRTensor(values, indices, indptr, (len(indptr) - 1, 5000), device="cpu")
    x, y = torch.ones(5000, dtype=torch.float64), torch.ones(A.shape[0], dtype=torch.float64)
    for _ in range(2):
        A @ x
        A.T @ y
    assert len(built) == 2
    op = sparse_aslinop(A)
    op @ x
    op.T @ y
    assert len(built) == 2 and len(card.calls) == 6
    assert _rel(op @ x, A.to_scipy() @ np.ones(5000)) <= F64
