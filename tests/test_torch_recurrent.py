"""rwkv6-1.6b (``ssm``: time mix and channel mix, no attention) and
recurrentgemma-2b (``hybrid``: RG-LRU blocks and local attention, MQA,
head_dim 16, window 32), reduced, against the JAX package on the CPU.
Weights come from the reference's ``init_params`` (``PRNGKey(0)``) and
cross by ``models/convert.params_from_numpy``; inputs and recurrent
states are seeded numpy.

Tolerances:

* binary32: every output and f32 state within 1e-5 x max(1, max|ref|)
  (only summation orders differ);
* transprecision (JAX compiled with ``xla_allow_excess_precision`` off,
  see ``tests/test_torch_model.py``): bf16 outputs and logits within
  2^-8 x max|ref| (a bf16 rounding may flip by one ulp where the
  summation orders differ), and every binary8 (e5m2) state element equal
  to the reference's or one e5m2 step from it; the module and model
  tests count the elements a step apart (``_e5m2_steps``) and hold that
  count at 0;
* the chunked route against the whole prompt (the same package on both
  sides) only under binary32, at the reference's own tolerance
  (``tests/test_recurrent.py``: 2e-4 for rwkv, 3e-4 for the RG-LRU):
  under transprecision the state is rounded to e5m2 at every chunk end,
  so the two routes are different computations, in the reference too.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get as jget_config  # noqa: E402
from repro.core.policy import get_policy as jget_policy  # noqa: E402
from repro.kernels import paged_cache as jpc  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.models import rwkv6 as jrwkv  # noqa: E402
from repro.models.registry import build as jbuild  # noqa: E402
from repro.engine import scheduler as jscheduler  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.engine import (Engine, FaultPlan, Request,  # noqa: E402
                                StreamedTransport, synchronous_generate)
from repro_torch.engine import scheduler as tscheduler  # noqa: E402
from repro_torch.kernels import paged_cache as tpc  # noqa: E402
from repro_torch.launch.serve import build_draft  # noqa: E402
from repro_torch.models import qparams  # noqa: E402
from repro_torch.models import rglru, rwkv6, scan  # noqa: E402
from repro_torch.models.convert import (params_from_numpy,  # noqa: E402
                                        tensor_from_numpy)
from repro_torch.models.registry import build  # noqa: E402
from test_torch_model import _close, _f32, to_numpy  # noqa: E402

RWKV, RG = "rwkv6-1.6b", "recurrentgemma-2b"
PROMPT = [3, 17, 42, 7, 99, 1, 64, 23, 5, 88, 12, 30, 2]   # 13: 8 + 5
PAGE, PPS = 8, 3
FIELDS = ("arch", "family", "n_layers", "d_model", "n_heads", "n_kv",
          "d_ff", "vocab", "head_dim", "rope_theta", "norm", "act_fn",
          "gated_ffn", "tied_embeddings", "embed_scale", "use_bias",
          "moe_experts", "loss_chunks", "attn_pattern", "window",
          "rwkv_head_dim", "rwkv_chunk", "rwkv_fused", "rglru_width",
          "conv_width")
B32_TOL, CHUNK_TOL = 1e-5, {RWKV: 2e-4, RG: 3e-4}


JIT_OPTIONS = {"xla_allow_excess_precision": False,
               "xla_backend_optimization_level": 0}
_jax_jit = jax.jit


def _jit(f, **kw):
    """``test_torch_model._jit`` (every bf16 rounding honoured) at XLA's
    lowest backend optimization level, which compiles these graphs
    faster."""
    return _jax_jit(f, compiler_options=JIT_OPTIONS, **kw)


@functools.lru_cache(maxsize=None)
def _numpy_params(arch, pol):
    """The reference's ``init_params(PRNGKey(0))`` in one compiled call.
    Under transprecision its leaves are the binary32 draws rounded to
    the dtypes the reference makes them in (its init draws f32 and
    casts), so they are cast from the binary32 tree."""
    jmodel, _ = jbuild(arch, reduced=True)
    key = jax.random.PRNGKey(0)
    if pol == "binary32":
        return to_numpy(_jit(lambda k: jmodel.init_params(
            k, jget_policy(pol)))(key))
    shapes = jax.eval_shape(lambda k: jmodel.init_params(
        k, jget_policy(pol)), key)
    return jax.tree.map(lambda a, sd: np.asarray(jnp.asarray(a).astype(
        sd.dtype)), _numpy_params(arch, "binary32"), shapes)


def _jparams(arch, pol):
    return jax.tree.map(jnp.asarray, _numpy_params(arch, pol))


def _e5m2_steps(got, want):
    """Per element, how many e5m2 steps ``got`` lies from ``want`` (both
    e5m2 tensors / arrays): their codes on one monotone integer line."""
    def line(a):
        c = _codes(a).astype(np.int32)
        mag = c & 0x7F
        return np.where(c & 0x80, -mag, mag)
    return np.abs(line(got) - line(want))


def _codes(a):
    if isinstance(a, torch.Tensor):
        return a.view(torch.uint8).numpy()
    return np.asarray(a).view(np.uint8)


def _state_close(got, want, pol, what):
    """One state tensor: e5m2 states within one step (returns how many
    elements moved), the others (f32 ``h``, bf16 token shifts) within
    the output tolerance."""
    w = np.asarray(want)
    if w.dtype.name == "float8_e5m2":
        steps = _e5m2_steps(got, w)
        assert steps.max() <= 1, (what, int(steps.max()))
        return int((steps > 0).sum())
    scale = max(1.0, float(np.abs(w.astype(np.float32)).max()))
    _close(got, w, (B32_TOL if pol == "binary32" else 2.0 ** -8) * scale)
    return 0


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", [RWKV, RG])
def test_config_is_the_references(arch, reduced):
    """Field for field the reference's config and its ``param_count``
    (1,584,091,136 and 2,894,481,920 at full size; recurrentgemma's 26
    layers hold 8 attention layers at i % 3 == 2); the reduced init holds
    exactly that many parameters, and both configs follow paligemma-3b
    in ``ARCHS``."""
    assert configs.ARCHS[7:9] == (RWKV, RG)
    want = jget_config(arch, reduced=reduced)
    got = configs.get(arch, reduced=reduced)
    for f in FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    assert got.param_count() == want.param_count()
    if not reduced:
        assert got.param_count() == {RWKV: 1_584_091_136,
                                     RG: 2_894_481_920}[arch]
        assert got.attn_pattern.count("attn") == (0 if arch == RWKV else 8)
        return
    model, cfg = build(arch, reduced=True)
    params = model.init_params(torch.Generator().manual_seed(0),
                               get_policy("binary32"), device="cpu")
    assert sum(t.numel() for t in qparams.tree_leaves(params)) \
        == cfg.param_count()
    ported = params_from_numpy(_numpy_params(arch, "binary32"),
                               device="cpu")
    assert sum(t.numel() for t in qparams.tree_leaves(ported)) \
        == cfg.param_count()


# ---------------------------------------------------------------------------
# the scan helper
# ---------------------------------------------------------------------------

def _jcomb(lhs, rhs):
    a1, s1 = lhs
    a2, s2 = rhs
    return a1 * a2, a2[..., None] * s1 + s2


@pytest.mark.parametrize("n", [1, 2, 5, 8, 13])
def test_scan_is_the_references(n):
    """rwkv's combine over (B, n, H, dk) decays and (B, n, H, dk, dv)
    states: bit for bit ``jax.lax.associative_scan`` (odd and even
    lengths), and within f32 rounding of a sequential scan."""
    rng = np.random.default_rng(n)
    a = rng.uniform(0.2, 1.0, (2, n, 3, 4)).astype(np.float32)
    s = rng.normal(size=(2, n, 3, 4, 5)).astype(np.float32)
    ja, js = jax.jit(lambda a, s: jax.lax.associative_scan(
        _jcomb, (a, s), axis=1))(a, s)
    ta, ts = scan.associative_scan(
        scan.linear_combine, (torch.from_numpy(a), torch.from_numpy(s)),
        dim=1)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    seq_a, seq_s = [a[:, 0]], [s[:, 0]]
    for t in range(1, n):
        seq_a.append(seq_a[-1] * a[:, t])
        seq_s.append(a[:, t][..., None] * seq_s[-1] + s[:, t])
    np.testing.assert_allclose(ta.numpy(), np.stack(seq_a, 1), rtol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.stack(seq_s, 1), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the modules
# ---------------------------------------------------------------------------

def _inputs(arch, pol, S, with_state, seed):
    """Seeded (x (2, S, d) in the activation dtype, state or None) as
    numpy in the reference's dtypes, for the layer-0 block."""
    cfg = jget_config(arch, reduced=True)
    jpol = jget_policy(pol)
    rng = np.random.default_rng(seed)
    act = jpol.dtype("act")
    x = np.asarray(jnp.asarray(rng.normal(size=(2, S, cfg.d_model))
                               .astype(np.float32)).astype(act))
    if not with_state:
        return x, None
    if arch == RWKV:
        st = jrwkv.rwkv_init_state(cfg, 2, jpol)
        return x, tuple(np.asarray(jnp.asarray(
            rng.normal(size=f.shape).astype(np.float32) * 0.5)
            .astype(f.dtype)) for f in st)
    st = jrglru.rglru_init_state(cfg, 2, jpol)
    return x, tuple(np.asarray(jnp.asarray(
        rng.normal(size=f.shape).astype(np.float32))
        .astype(f.dtype)) for f in st)


def _blocks(arch, pol):
    """The reference's block and the port's for the layer-0 weights:
    rwkv's time mix followed by its channel mix on the time mix's output
    (the state threaded through both), or ``rglru_block``."""
    jcfg = jget_config(arch, reduced=True)
    cfg = configs.get(arch, reduced=True)
    jpol = jget_policy(pol, decode_impl="xla", matmul_impl="xla")
    tpol = get_policy(pol, decode_impl="xla", matmul_impl="xla")
    if arch == RWKV:
        def jf(p, x, st):
            st = None if st is None else jrwkv.RwkvState(*st)
            a, st = jrwkv.time_mix(p, x, jcfg, jpol, state=st)
            f, st = jrwkv.channel_mix(p, a, jcfg, jpol, state=st)
            return (a, f), st

        def tf(p, x, st):
            st = None if st is None else rwkv6.RwkvState(*st)
            a, st = rwkv6.time_mix(p, x, cfg, tpol, state=st)
            f, st = rwkv6.channel_mix(p, a, cfg, tpol, state=st)
            return (a, f), st
        return jf, tf

    def jf(p, x, st):
        st = None if st is None else jrglru.RglruState(*st)
        out, st = jrglru.rglru_block(p, x, jcfg, jpol, state=st)
        return (out,), st

    def tf(p, x, st):
        st = None if st is None else rglru.RglruState(*st)
        out, st = rglru.rglru_block(p, x, cfg, tpol, state=st)
        return (out,), st
    return jf, tf


@functools.lru_cache(maxsize=None)
def _jax_modules(arch, pol):
    """The reference's block on every case's inputs, in one compiled
    call: {(S, with_state): (outputs, state)}."""
    jf, _ = _blocks(arch, pol)
    jp = jax.tree.map(jnp.asarray,
                      _numpy_params(arch, pol)["layers"][0]["mix"])
    cases = [(S, w) for a, S, w in MODULE_CASES if a == arch]
    args = []
    for S, w in cases:
        x, st = _inputs(arch, pol, S, w, seed=S)
        args.append((jnp.asarray(x), None if st is None
                     else tuple(jnp.asarray(f) for f in st)))
    outs = _jit(lambda p, args: [jf(p, x, st) for x, st in args])(jp, args)
    return dict(zip(cases, outs))


MODULE_CASES = [(arch, S, st) for arch in (RWKV, RG) for S in (1, 5, 8, 13)
                for st in (True, False)
                if not (arch == RWKV and S == 1 and not st)]


@pytest.mark.parametrize("pol", ["binary32", "transprecision"])
@pytest.mark.parametrize("arch,S,with_state", MODULE_CASES,
                         ids=[f"{a.split('-')[0]}-S{s}-{'state' if w else 'none'}"
                              for a, s, w in MODULE_CASES])
def test_module_matches_jax(arch, S, with_state, pol):
    """rwkv's ``time_mix`` + ``channel_mix`` and ``rglru_block`` at S = 1
    (the recurrent step; rwkv's needs a state, in the reference too), 5,
    8 (rwkv: one chunk of ``rwkv_chunk``), 13 (C = 1: a prime length) with
    and without a carried state."""
    x, state = _inputs(arch, pol, S, with_state, seed=S)
    jouts, jst = _jax_modules(arch, pol)[(S, with_state)]
    _, tf = _blocks(arch, pol)
    p = params_from_numpy(_numpy_params(arch, pol)["layers"][0]["mix"],
                          device="cpu")
    outs, st = tf(p, tensor_from_numpy(x), None if state is None
                  else tuple(tensor_from_numpy(f) for f in state))
    for got, want in zip(outs, jouts):
        w = _f32(want)
        scale = max(1.0, float(np.abs(w).max()))
        _close(got, w, (B32_TOL if pol == "binary32" else 2.0 ** -8) * scale)
        assert np.isfinite(_f32(got)).all()
    assert (st is None) == (jst is None)
    if st is not None:
        flipped = sum(_state_close(g, w, pol, f"state {i}")
                      for i, (g, w) in enumerate(zip(st, jst)))
        assert flipped == 0


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

def _paged(cfg, pol, jax_side):
    """One slot's paged caches for the attention layers (pages 2, 0, 3),
    None at the recurrent ones."""
    mod = jpc if jax_side else tpc
    out = []
    for kind in cfg.attn_pattern:
        if kind != "attn":
            out.append(None)
            continue
        c = mod.init_paged_cache(1, 4, PAGE, PPS, cfg.n_kv, cfg.head_dim,
                                 pol.dtype("kv_cache"))
        out.append(mod.set_block_tables(c, np.array([[2, 0, 3]], np.int32)))
    return out


@functools.lru_cache(maxsize=None)
def _jax_model_run(arch, pol):
    """The reference's whole prefill, and its chunked route (8 + 5 tokens
    with ``pstates``) + decode step over one slot's pages, in one
    compiled call: (logits, recurrent states after each route)."""
    jm, jcfg = jbuild(arch, reduced=True)
    jpol = jget_policy(pol, decode_impl="xla", matmul_impl="xla")
    toks = jnp.asarray([PROMPT], jnp.int32)
    tok = jnp.asarray([[PROMPT[-1]]], jnp.int32)

    def run(p, s, ps):
        lp, st = jm.prefill(p, {"tokens": toks}, jpol, 24)
        c1, s, ps = jm.prefill_chunk(p, toks[:, :8], s, ps, jpol, slot=0,
                                     q_offset=0)
        c2, s, ps = jm.prefill_chunk(p, toks[:, 8:], s, ps, jpol, slot=0,
                                     q_offset=8)
        s = [ps[i] if k != "attn" else s[i]
             for i, k in enumerate(jcfg.attn_pattern)]
        lcd, s = jm.decode_step(p, tok, s, jpol)
        return [lp, c1, c2, lcd], (st, s)
    ps = [None if k == "attn" else s
          for k, s in zip(jcfg.attn_pattern, jm.init_state(1, PAGE, jpol))]
    return _jit(run)(_jparams(arch, pol), _paged(jcfg, jpol, True), ps)


def _port_model_run(arch, pol, decode_impl, matmul_impl):
    model, cfg = build(arch, reduced=True)
    tpol = get_policy(pol, decode_impl=decode_impl, matmul_impl=matmul_impl)
    tp = params_from_numpy(_numpy_params(arch, pol), device="cpu")
    if matmul_impl == "qmm_pallas":
        tp = qparams.encode_params(tp, tpol)
    toks = torch.tensor([PROMPT], dtype=torch.int32)
    tok = torch.tensor([[PROMPT[-1]]], dtype=torch.int32)
    lp, st = model.prefill(tp, {"tokens": toks}, tpol, 24)
    ld, _ = model.decode_step(tp, tok, st, tpol)
    ps = model.recurrent_state(1, tpol, "cpu")
    s = _paged(cfg, tpol, False)
    c1, s, ps = model.prefill_chunk(tp, toks[:, :8], s, ps, tpol, slot=0,
                                    q_offset=0)
    c2, s, ps = model.prefill_chunk(tp, toks[:, 8:], s, ps, tpol, slot=0,
                                    q_offset=8)
    assert all((p is None) == (k == "attn")
               for p, k in zip(ps, cfg.attn_pattern))
    s = [ps[i] if k != "attn" else s[i]
         for i, k in enumerate(cfg.attn_pattern)]
    lcd, s = model.decode_step(tp, tok, s, tpol)
    return [lp, c1, c2, lcd], (st, s), ld, cfg


MODEL_CASES = [(a, p, sp) for a in (RWKV, RG)
               for p, sp in (("binary32", ("xla", "xla")),
                             ("binary32", ("paged", "qmm_pallas")),
                             ("transprecision", ("xla", "xla")))]


@pytest.mark.parametrize("arch,pol,spell", MODEL_CASES,
                         ids=[f"{a.split('-')[0]}-{p}-{s[1]}"
                              for a, p, s in MODEL_CASES])
def test_model_matches_jax(arch, pol, spell):
    """``prefill`` (13 tokens), and ``prefill_chunk`` with ``pstates`` (8
    then 5 tokens; rwkv's chunks run C = 8 and C = 5) + ``decode_step``
    over the slot's pages and the carried states: the logits and the
    recurrent states after both routes against the reference's.  Under
    binary32 the chunked route also lies within the reference's own
    tolerance of the whole route, its decode step's logits too (the
    whole route's decode step over contiguous caches, the synchronous
    loop's)."""
    want, (jw, jc) = _jax_model_run(arch, pol)
    got, (tw, tc), ld, cfg = _port_model_run(arch, pol, *spell)
    scale = max(1.0, max(float(np.abs(_f32(w)).max()) for w in want))
    tol = (B32_TOL if pol == "binary32" else 2.0 ** -8) * scale
    for g, w in zip(got, want):
        _close(g, w, tol)
        assert np.isfinite(_f32(g)).all()
    flipped = 0
    for li, kind in enumerate(cfg.attn_pattern):
        if kind == "attn":
            continue
        for route_t, route_j in ((tw, jw), (tc, jc)):
            for f, (g, w) in enumerate(zip(route_t[li], route_j[li])):
                flipped += _state_close(g, w, pol, f"layer {li} field {f}")
    assert flipped == 0
    if pol == "binary32":
        # chunked against whole: prefill's last logits and the decode's
        _close(got[2], got[0], CHUNK_TOL[arch] * scale)
        _close(got[3], ld, CHUNK_TOL[arch] * scale)


def test_one_token_chunk_and_short_conv_history():
    """A last chunk of one token takes the S == 1 step in both modules,
    and a chunk shorter than ``conv_width - 1`` still carries the conv
    history: chunks 8 + 1 + 2 + 2 of the prompt give the whole route's
    logits (binary32, the reference's tolerance) on both configs."""
    for arch in (RWKV, RG):
        model, cfg = build(arch, reduced=True)
        tpol = get_policy("binary32", decode_impl="xla", matmul_impl="xla")
        tp = params_from_numpy(_numpy_params(arch, "binary32"), device="cpu")
        toks = torch.tensor([PROMPT], dtype=torch.int32)
        lp, _ = model.prefill(tp, {"tokens": toks}, tpol, 24)
        ps = model.recurrent_state(1, tpol, "cpu")
        s = _paged(cfg, tpol, False)
        for lo, hi in ((0, 8), (8, 9), (9, 11), (11, 13)):
            lc, s, ps = model.prefill_chunk(tp, toks[:, lo:hi], s, ps, tpol,
                                            slot=0, q_offset=lo)
        scale = max(1.0, float(lp.abs().max()))
        _close(lc, lp, CHUNK_TOL[arch] * scale)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _capture_prefill_logits(mod, sink):
    """Wrap ``mod.Engine._complete_prefill`` to record each request's
    last-chunk logits; returns the original."""
    real = mod.Engine._complete_prefill

    def wrapped(self, task):
        sink[task.request.rid] = _f32(task.logits).reshape(-1)
        return real(self, task)
    mod.Engine._complete_prefill = wrapped
    return real


@functools.lru_cache(maxsize=None)
def _engine_prompts():
    rng = np.random.default_rng(0)
    return tuple(tuple(rng.integers(0, 97, 13).tolist()) for _ in range(3))


@functools.lru_cache(maxsize=None)
def _jax_engine(arch):
    """The reference's engine under binary32 (its ``xla`` spellings): 3
    requests of 13 tokens over 2 slots, chunks 8 + 5, 5 new tokens."""
    jm, jcfg = jbuild(arch, reduced=True)
    sink = {}
    real = _capture_prefill_logits(jscheduler, sink)
    try:
        reqs = [jscheduler.Request(i, list(p), 5)
                for i, p in enumerate(_engine_prompts())]
        # the reference's workers compile with the options of ``_jit``
        jax.jit = _jit
        jscheduler.Engine(jm, jcfg, jget_policy("binary32",
                                                decode_impl="xla"),
                          _jparams(arch, "binary32"), slots=2, capacity=24,
                          page_size=PAGE).run(reqs)
    finally:
        jax.jit = _jax_jit
        jscheduler.Engine._complete_prefill = real
    return [r.generated for r in reqs], sink


ENGINE_CASES = [(RWKV, "paged", False), (RG, "paged", False),
                (RG, "flash_pallas", False), (RG, "paged", True)]


@pytest.mark.parametrize("arch,decode,streamed", ENGINE_CASES,
                         ids=["rwkv6", "recurrentgemma-paged",
                              "recurrentgemma-flash_pallas",
                              "recurrentgemma-streamed"])
def test_engine_matches_jax_engine(arch, decode, streamed):
    """binary32, engine against engine: 3 requests over 2 slots (the
    third reuses a slot, whose recurrent row must start from its own
    prompt), prompts of 13 tokens in chunks of 8 + 5.  The port serves
    its kernel spellings (``qmm_pallas`` over the packed binary32 store:
    the reference's f32 products) under ``paged`` or ``flash_pallas``,
    colocated or streamed.  The tokens equal the reference's engine's,
    and each request's last-chunk logits lie within 1e-5 x max(1,
    max|logit|) of the reference's.  An attention-free config runs with
    no pool state at all."""
    want, jlogits = _jax_engine(arch)
    model, cfg = build(arch, reduced=True)
    pol = get_policy("binary32", decode_impl=decode,
                     matmul_impl="qmm_pallas")
    params = qparams.encode_params(params_from_numpy(
        _numpy_params(arch, "binary32"), device="cpu"), pol)
    sink = {}
    real = _capture_prefill_logits(tscheduler, sink)
    try:
        reqs = [Request(i, list(p), 5)
                for i, p in enumerate(_engine_prompts())]
        eng = Engine(model, cfg, pol, params, slots=2, capacity=24,
                     page_size=PAGE, device="cpu",
                     transport=StreamedTransport() if streamed else None)
        eng.run(reqs)
    finally:
        tscheduler.Engine._complete_prefill = real
    assert all(r.done and not r.failed for r in reqs)
    assert [r.generated for r in reqs] == want
    for rid, w in jlogits.items():
        _close(sink[rid], w, B32_TOL * max(1.0, float(np.abs(w).max())))
    if arch == RWKV:
        assert eng.attn_layers == [] and all(
            isinstance(s, rwkv6.RwkvState) for s in eng.states)


def test_nan_quarantine_replays_through_synchronous_generate():
    """binary32, recurrentgemma: an injected ``nan_logits`` on a decoding
    slot quarantines its pages and replays the request through
    ``synchronous_generate`` (whole prefill, contiguous caches), as the
    reference does; the other requests keep the engine's tokens."""
    model, cfg = build(RG, reduced=True)
    pol = get_policy("binary32", decode_impl="paged",
                     matmul_impl="qmm_pallas")
    params = qparams.encode_params(params_from_numpy(
        _numpy_params(RG, "binary32"), device="cpu"), pol)
    prompts = _engine_prompts()

    def serve(plan):
        reqs = [Request(i, list(p), 5) for i, p in enumerate(prompts)]
        eng = Engine(model, cfg, pol, params, slots=2, capacity=24,
                     page_size=PAGE, device="cpu", fault_plan=plan)
        eng.run(reqs)
        return reqs, eng
    clean, _ = serve(None)
    faulty, eng = serve(FaultPlan.parse("nan_logits@4/1"))
    assert eng.summary["quarantines"] == 1
    replay = synchronous_generate(model, cfg, pol, params, [prompts[1]],
                                  max_new=5, capacity=24, device="cpu")
    assert faulty[1].generated == replay[0]
    assert [r.generated for r in faulty][::2] == \
        [r.generated for r in clean][::2]


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def _rg(pol="binary32"):
    model, cfg = build(RG, reduced=True)
    policy = get_policy(pol, decode_impl="paged")
    return model, cfg, policy, params_from_numpy(
        _numpy_params(RG, pol), device="cpu")


def _refuse_window():
    model, cfg, policy, params = _rg()
    Engine(model, cfg, policy, params, slots=2, capacity=cfg.window + 8,
           page_size=PAGE, device="cpu")


def _refuse_speculative():
    model, cfg, policy, params = _rg()
    Engine(model, cfg, policy, params, slots=2, capacity=24,
           page_size=PAGE, device="cpu",
           speculative=build_draft(model, cfg, k=2, device="cpu"))


def _refuse_verify():
    model, cfg, policy, params = _rg()
    model.verify_step(params, torch.tensor([PROMPT[:2]], dtype=torch.int32),
                      _paged(cfg, policy, False), policy)


@pytest.mark.parametrize("call,match", [
    (_refuse_window, "sliding window"), (_refuse_speculative, "recurrent"),
    (_refuse_verify, "recurrent")],
    ids=["capacity-above-window", "SpeculativeDecoder", "verify_step"])
def test_recurrent_refusals(call, match):
    """What the recurrent configs do not take: a paged capacity above the
    window (the reference's check), speculation and the verify step
    (recurrent state cannot roll back, in the reference too)."""
    with pytest.raises(ValueError, match=match):
        call()
