"""CONV: 5x5 valid convolution on a 30x30 image (paper benchmark #6).

The port of ``repro.apps.conv``: multiply-accumulate over 25 taps per
output pixel; fully vectorizable."""
from __future__ import annotations

import numpy as np

from .common import AppSpec, TPContext, TVal

IMG = 30
KW = 5
OUT = IMG - KW + 1


class Conv(AppSpec):
    def __init__(self):
        super().__init__(name="CONV",
                         variables=("img", "ker", "prod", "acc", "out"))

    def gen_inputs(self, seed: int):
        rng = np.random.default_rng(seed)
        img = rng.uniform(0.0, 1.0, (IMG, IMG)).astype(np.float32)
        ker = rng.normal(0, 0.3, (KW, KW)).astype(np.float32)
        ker /= max(np.abs(ker).sum(), 1.0)
        return img, ker

    def reference(self, inputs):
        img, ker = [np.asarray(v, np.float64) for v in inputs]
        out = np.zeros((OUT, OUT))
        for i in range(KW):
            for j in range(KW):
                out += ker[i, j] * img[i:i + OUT, j:j + OUT]
        return out

    def run(self, ctx: TPContext, inputs):
        img, ker = inputs
        im = ctx.var("img", img)
        kk = ctx.var("ker", ker)
        acc = None
        for i in range(KW):
            for j in range(KW):
                patch = TVal(im.value[i:i + OUT, j:j + OUT], "img")
                kij = TVal(kk.value[i, j], "ker")
                p = ctx.mul("prod", patch, kij, vec=True)
                acc = p if acc is None else ctx.add("acc", acc, p, vec=True)
        out = ctx.mul("out", acc, ctx.var("ker", 1.0))
        return out.value
