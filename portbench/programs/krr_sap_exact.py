"""ASkotch on an operator at the exact float32 tier: the program of every
configuration whose ``program`` is ``krr_sap_exact``.

It is ``krr_sap``'s program (set-up, window and the check's numbers, as
``programs/krr_sap.py`` says) with a tap on the operator's dense block
tile and the control of an exact float32 configuration (``"control":
"tf32_reference"``), read from the same kept outputs as the program's
numbers. A kernel with no lower tier of its own (Laplace has only the
exact one) has no lower tier for a control to run at.

``blk_err``
    For one block tile ``K[blk, blk]`` that SAP materialized in the window
    (drawn from the seed among them), ``max|T - K[blk, blk]| / max K`` over
    the check's ``oracle_rows`` rows of the tile, drawn from the seed as
    ``oracle_err``'s; the reference's ``gram_block(X, rows, cols,
    lengthscale)`` in float64 judges. Infinite where SAP materialized no
    tile.

The control stands in for the program's float32 products:

``oracle_err``
    The reference at float32 with a TF32 contraction in place of each kept
    row-oracle apply, judged as the program's apply is.
``blk_err``
    The reference's tile at float32 from the points rounded to bfloat16
    (what a dense block fed bfloat16 points computes), judged as the
    program's tile is.
``res_gap``, ``res_at.<i>``
    The program's own: the iterates and logged estimates are the
    program's, so these two do not tell the control from the program.
"""

import math
import random

import torch

from portbench import data
from portbench.programs import krr_sap


class BlockProbe:
    """Taps an operator's dense block tile. While on, one tile that the
    solver materialized is kept with its block, drawn from the seed
    (reservoir) among them; the tile is the solver's own tensor, not a
    copy."""

    def __init__(self, K, seed: int):
        self._bd = K.blk_dense
        K.blk_dense = self.blk_dense
        self.on = False
        self._rng = random.Random(data.stream_seed(seed, "block_sample"))
        self.seen, self.kept = 0, None

    def blk_dense(self, blk):
        T = self._bd(blk)
        if self.on:
            self.seen += 1
            if self._rng.randrange(self.seen) == 0:
                self.kept = (blk, T)
        return T


class Program(krr_sap.Program):
    """``krr_sap``'s program, with the tile's tap and the control above."""

    def __init__(self, cell, seed, device, traced, log=print):
        super().__init__(cell, seed, device, traced, log)
        self.block = BlockProbe(self.K, seed)
        self.tile = None  # (blk, the check's rows of it, those rows of the kept tile)
        self._own = {}

    def window(self, seconds, traced):
        self.block.on = True
        try:
            super().window(seconds, traced)
        finally:
            self.block.on = False

    def release(self):
        if self.block.kept is not None:
            blk, T = self.block.kept
            pos = data.sample_rows(self.seed, self.blk, self.cell.check["oracle_rows"])
            pos = pos.to(T.device)
            self.tile = (blk, pos, T[pos])
        self.block = None
        super().release()

    def numbers(self, reference, names, control=False):
        if not control:
            out = super().numbers(reference, [k for k in names if k != "blk_err"])
            self._own = dict(out)
        else:
            out = {k: v for k, v in self._own.items() if k in names}
            if "oracle_err" in names:
                pos = data.sample_rows(self.seed, self.blk, self.cell.check["oracle_rows"])
                out["oracle_err"] = tf32_oracle_err(reference, self.X, self.ls, self.applies,
                                                    pos)
        if "blk_err" in names:
            out["blk_err"] = blk_err(reference, self.X, self.ls, self.tile, control)
        return out


def tf32_oracle_err(reference, X, lengthscale, applies, pos):
    """``krr_sap.oracle_err`` of the TF32 reference's applies in place of
    the program's (on the rows ``pos`` of each kept block)."""
    got = []
    for blk, V, Y in applies:
        p = pos.to(blk.device)
        Yc = torch.zeros_like(Y)
        Yc[p] = reference.gram_apply(X, blk[p], V.float(), lengthscale, torch.float32,
                                     tf32=True)
        got.append((blk, V, Yc))
    return krr_sap.oracle_err(reference, X, lengthscale, got, pos)


def blk_err(reference, X, lengthscale, tile, control=False):
    """``max|T - K[blk[p], blk]| / max K[blk[p], blk]`` of the kept tile's
    rows ``p`` (the control's T: the reference at float32 from the points
    rounded to bfloat16); infinite without a tile."""
    if tile is None:
        return math.inf
    blk, p, T = tile
    rows = blk[p]
    ref = reference.gram_block(X, rows, blk, lengthscale)
    if control:
        T = reference.gram_block(X.bfloat16().float(), rows, blk, lengthscale, torch.float32)
    return (torch.max(torch.abs(T.double() - ref)) / torch.max(ref)).item()
