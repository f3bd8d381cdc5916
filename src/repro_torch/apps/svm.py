"""SVM: linear-kernel prediction stage (paper benchmark #5).

The port of ``repro.apps.svm``: 1001 support vectors x 10 features: score
= sum_i alpha_i * (sv_i . x) + b.  Dot products vectorize (paper: 60% of
SVM ops vectorizable, largest memory-access reduction, all-binary8
bindings)."""
from __future__ import annotations

import numpy as np

from .common import AppSpec, TPContext

NSV = 1001
NF = 10


class Svm(AppSpec):
    def __init__(self):
        super().__init__(name="SVM",
                         variables=("svs", "x", "alpha", "prod", "dot",
                                    "acc", "bias"))

    def gen_inputs(self, seed: int):
        rng = np.random.default_rng(seed)
        svs = rng.normal(0, 1.0, (NSV, NF)).astype(np.float32)
        alpha = (rng.uniform(0.05, 1.0, NSV) *
                 rng.choice([-1.0, 1.0], NSV)).astype(np.float32)
        x = rng.normal(0, 1.0, NF).astype(np.float32)
        b = np.float32(rng.normal())
        return svs, alpha, x, b

    def reference(self, inputs):
        svs, alpha, x, b = [np.asarray(v, np.float64) for v in inputs]
        return np.atleast_1d(alpha @ (svs @ x) + b)

    def run(self, ctx: TPContext, inputs):
        svs, alpha, x, b = inputs
        sv = ctx.var("svs", svs)
        al = ctx.var("alpha", alpha)
        xx = ctx.var("x", x)
        bb = ctx.var("bias", b)
        prod = ctx.mul("prod", sv, xx, vec=True)          # (NSV, NF)
        dots = ctx.reduce_sum("dot", prod, axis=1, vec=True)
        w = ctx.mul("acc", dots, al, vec=True)
        score = ctx.reduce_sum("acc", w, axis=None)
        out = ctx.add("acc", score, bb)
        return out.value.reshape(-1)
