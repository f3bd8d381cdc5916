"""JACOBI: Jacobi method on a 2D heat grid (paper benchmark #1).

The port of ``repro.apps.jacobi``: 34x34 grid, fixed boundary, T sweeps of
    new[i,j] = 0.25 * (g[i-1,j] + g[i+1,j] + g[i,j-1] + g[i,j+1]).
Not vectorizable (unaligned stencil accesses -- paper Fig. 5 shows zero
vector ops for JACOBI).
"""
from __future__ import annotations

import numpy as np

from .common import AppSpec, TPContext, TVal

N = 34
T = 100


class Jacobi(AppSpec):
    def __init__(self):
        super().__init__(name="JACOBI",
                         variables=("grid", "acc", "new", "factor"))

    def gen_inputs(self, seed: int):
        rng = np.random.default_rng(seed)
        g = np.zeros((N, N), np.float32)
        g[0, :] = rng.uniform(0.5, 2.0)     # hot edge
        g[-1, :] = rng.uniform(0.0, 0.2)
        g[:, 0] = rng.uniform(0.2, 1.0)
        g[:, -1] = rng.uniform(0.2, 1.0)
        g[1:-1, 1:-1] = rng.uniform(0.0, 1.0, (N - 2, N - 2))
        return g

    def reference(self, g):
        g = np.asarray(g, np.float64).copy()
        for _ in range(T):
            inner = 0.25 * (g[:-2, 1:-1] + g[2:, 1:-1] +
                            g[1:-1, :-2] + g[1:-1, 2:])
            g[1:-1, 1:-1] = inner
        return g

    def run(self, ctx: TPContext, g0):
        g = ctx.var("grid", g0)
        factor = ctx.var("factor", 0.25)
        for _ in range(T):
            up = TVal(g.value[:-2, 1:-1], "grid")
            down = TVal(g.value[2:, 1:-1], "grid")
            left = TVal(g.value[1:-1, :-2], "grid")
            right = TVal(g.value[1:-1, 2:], "grid")
            s = ctx.add("acc", up, down)
            s = ctx.add("acc", s, left)
            s = ctx.add("acc", s, right)
            inner = ctx.mul("new", s, factor)
            newg = g.value.clone()
            newg[1:-1, 1:-1] = inner.value
            g = ctx.var("grid", newg)
            ctx.other(inner.value.numel())  # index arithmetic
        return g.value
