"""KNN: k-nearest neighbours by euclidean distance (paper benchmark #2).

The port of ``repro.apps.knn``: 16000 2-D points, one query, k=4; squared
distances (no sqrt needed for ranking).  Fully vectorizable (paper: KNN is
the best case -- all-binary8 variables, ~all ops vector, -30% energy)."""
from __future__ import annotations

import numpy as np
import torch

from .common import AppSpec, TPContext, TVal

NPTS = 16_000
K = 4


class Knn(AppSpec):
    def __init__(self):
        super().__init__(name="KNN",
                         variables=("points", "query", "diff", "sq", "dist"))

    def gen_inputs(self, seed: int):
        rng = np.random.default_rng(seed)
        pts = rng.uniform(-4.0, 4.0, (NPTS, 2)).astype(np.float32)
        q = rng.uniform(-2.0, 2.0, (2,)).astype(np.float32)
        return pts, q

    def reference(self, inputs):
        pts, q = np.asarray(inputs[0], np.float64), np.asarray(inputs[1],
                                                               np.float64)
        d = ((pts - q) ** 2).sum(axis=1)
        idx = np.argsort(d)[:K]
        return d[idx]

    def run(self, ctx: TPContext, inputs):
        pts, q = inputs
        p = ctx.var("points", pts)
        qq = ctx.var("query", q)
        diff = ctx.sub("diff", p, qq, vec=True)
        sq = ctx.mul("sq", diff, diff, vec=True)
        x = ctx.add("dist", TVal(sq.value[:, 0], "sq"),
                    TVal(sq.value[:, 1], "sq"), vec=True)
        ctx.other(NPTS)  # comparisons for the running top-k
        idx = torch.argsort(x.value, stable=True)[:K]
        return x.value[idx]
