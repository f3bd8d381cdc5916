"""PCA: principal component analysis via covariance + power iteration
(paper benchmark #3: the cast-pathology case -- many binary32 scalar ops,
>10-20% cast overhead after tuning, energy above baseline until manual
vectorization).

The port of ``repro.apps.pca``.  The divisors and the norm floor of the
``special`` steps are f32 tensors, as numpy's f32 arithmetic has them (a
Python divisor of a CUDA tensor would be applied as a multiplication by
its reciprocal).  The component sign is picked on the host: one read of
the 40-element vector per component.
"""
from __future__ import annotations

import numpy as np
import torch

from .common import AppSpec, TPContext, TVal

NSAMP = 60
NFEAT = 40
NCOMP = 4
POWER_ITERS = 12


def _div(v: torch.Tensor, d: int) -> torch.Tensor:
    """``v / d`` in f32, correctly rounded (numpy's ``f32 / int``)."""
    return v / torch.full_like(v, d)


def _inv_norm(t: torch.Tensor) -> torch.Tensor:
    """``1 / sqrt(max(t, 1e-30))`` in f32, numpy's f32 sequence."""
    return 1.0 / torch.sqrt(torch.clamp(t, min=1e-30))


class Pca(AppSpec):
    """``manual_vec=True`` reproduces the paper's manually-vectorized PCA
    (Fig. 7 labels 1-3): the cov/matvec/projection inner loops are tagged
    vectorizable."""

    manual_vec = False

    def __init__(self):
        super().__init__(name="PCA",
                         variables=("data", "mean", "centered", "cov",
                                    "vec", "matvec", "norm", "proj"))

    def gen_inputs(self, seed: int):
        rng = np.random.default_rng(seed)
        base = rng.normal(0, 1, (NSAMP, NCOMP))
        mix = rng.normal(0, 1, (NCOMP, NFEAT))
        data = base @ mix + 0.1 * rng.normal(0, 1, (NSAMP, NFEAT))
        return data.astype(np.float32)

    def reference(self, data):
        x = np.asarray(data, np.float64)
        xc = x - x.mean(axis=0)
        cov = xc.T @ xc / (NSAMP - 1)
        v = np.full(NFEAT, 1.0 / np.sqrt(NFEAT))
        comps = []
        c = cov.copy()
        for _ in range(NCOMP):
            vv = v.copy()
            for _ in range(POWER_ITERS):
                vv = c @ vv
                vv = vv / np.linalg.norm(vv)
            lam = vv @ c @ vv
            comps.append(vv * np.sign(vv[np.argmax(np.abs(vv))]))
            c = c - lam * np.outer(vv, vv)
        w = np.stack(comps, axis=1)
        return xc @ w

    def run(self, ctx: TPContext, data):
        x = ctx.var("data", data)
        s = ctx.reduce_sum("mean", x, axis=0)
        mean = ctx.special("mean", s, lambda v: _div(v, NSAMP),
                           n_equiv_b32_ops=1)
        mv = self.manual_vec
        xc = ctx.sub("centered", x, mean, vec=mv)
        # cov = xc^T xc / (n-1): NFEAT^2 dots of length NSAMP
        prods = ctx.mul("cov", TVal(xc.value[:, :, None], "centered"),
                        TVal(xc.value[:, None, :], "centered"), vec=mv)
        cov = ctx.reduce_sum("cov", prods, axis=0, vec=mv)
        cov = ctx.special("cov", cov, lambda v: _div(v, NSAMP - 1),
                          n_equiv_b32_ops=1)
        comps = []
        c = cov
        for _comp in range(NCOMP):
            v = ctx.var("vec", np.full(NFEAT, 1.0 / np.sqrt(NFEAT),
                                       np.float32))
            for _ in range(POWER_ITERS):
                mvp = ctx.mul("matvec", c, TVal(v.value[None, :], "vec"),
                              vec=mv)
                v_new = ctx.reduce_sum("matvec", mvp, axis=1, vec=mv)
                nrm2 = ctx.reduce_sum(
                    "norm", ctx.mul("norm", v_new, v_new), axis=None)
                inv = ctx.special("norm", nrm2, _inv_norm,
                                  n_equiv_b32_ops=10)
                v = ctx.mul("vec", v_new, inv)
            # eigenvalue + deflation
            mvec = ctx.reduce_sum("matvec",
                                  ctx.mul("matvec", c,
                                          TVal(v.value[None, :], "vec"),
                                          vec=mv),
                                  axis=1, vec=mv)
            lam = ctx.reduce_sum("norm", ctx.mul("norm", mvec, v), axis=None)
            outer = ctx.mul("cov", TVal(v.value[:, None], "vec"),
                            TVal(v.value[None, :], "vec"))
            scaled = ctx.mul("cov", outer, lam)
            c = ctx.sub("cov", c, scaled)
            vh = v.value.cpu().numpy()
            sign = np.sign(vh[np.argmax(np.abs(vh))]) or 1.0
            comps.append(v.value * float(sign))
        w = torch.stack(comps, dim=1)
        pr = ctx.mul("proj", TVal(xc.value[:, :, None], "centered"),
                     TVal(w[None, :, :], "vec"), vec=mv)
        proj = ctx.reduce_sum("proj", pr, axis=1, vec=mv)
        return proj.value
