"""DWT: 3-level 1-D Haar discrete wavelet transform (paper benchmark #4).

The port of ``repro.apps.dwt``: signal length 4096; per level: approx =
(a+b)*c, detail = (a-b)*c with c = 0.5 (orthonormal-scaled Haar uses
1/sqrt(2); the embedded variant scales by 0.5 to stay in add/sub/mul).
Pairwise ops vectorize."""
from __future__ import annotations

import numpy as np
import torch

from .common import AppSpec, TPContext, TVal

N = 4096
LEVELS = 3


class Dwt(AppSpec):
    def __init__(self):
        super().__init__(name="DWT",
                         variables=("signal", "approx", "detail", "half"))

    def gen_inputs(self, seed: int):
        rng = np.random.default_rng(seed)
        t = np.linspace(0, 8 * np.pi, N)
        sig = (np.sin(t) + 0.3 * np.sin(7.1 * t)
               + 0.05 * rng.normal(size=N)).astype(np.float32)
        return sig

    def reference(self, sig):
        a = np.asarray(sig, np.float64)
        out = []
        for _ in range(LEVELS):
            approx = 0.5 * (a[0::2] + a[1::2])
            detail = 0.5 * (a[0::2] - a[1::2])
            out.append(detail)
            a = approx
        out.append(a)
        return np.concatenate(out[::-1])

    def run(self, ctx: TPContext, sig):
        a = ctx.var("signal", sig)
        half = ctx.var("half", 0.5)
        outs = []
        name = "signal"
        for _lv in range(LEVELS):
            ev = TVal(a.value[0::2], name)
            od = TVal(a.value[1::2], name)
            s = ctx.add("approx", ev, od, vec=True)
            apx = ctx.mul("approx", s, half, vec=True)
            d = ctx.sub("detail", ev, od, vec=True)
            det = ctx.mul("detail", d, half, vec=True)
            outs.append(det.value)
            a, name = apx, "approx"
        outs.append(a.value)
        return torch.cat(outs[::-1])
