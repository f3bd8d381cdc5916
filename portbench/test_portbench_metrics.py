"""Each metric reader's arithmetic on synthetic step records, requests and
profiler intervals, against numbers worked out by hand."""
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench import harness, spec, tracing
from portbench.harness import Call, Req, Run, Step

HERE = Path(__file__).resolve().parent
SIZES = {"n_layers": 2, "d_model": 8, "n_heads": 4, "n_kv": 2,
         "head_dim": 2, "d_ff": 16, "vocab": 32, "rope_theta": 1e4,
         "rms_norm_eps": 1e-6}


def read(name, run):
    return spec.load_module(HERE / "metrics" / f"{name}.py").read(run)


def _req(rid, sent, times, plen=5, done=None):
    r = Req(SimpleNamespace(index=rid, prompt=[0] * plen, max_new=len(times)),
            SimpleNamespace(generated=[0] * len(times)), sent)
    r.times, r.done = list(times), done
    return r


def make_run(trace=None):
    steps = [
        Step(0.5, 0.9, [Call("decode_step", 0.5, 0.6, 4)], tokens=9),  # before
        Step(1.0, 1.2, [Call("decode_step", 1.0, 1.1, 4)], tokens=3,
             dec_lens=[10, 20, 30]),
        Step(1.2, 1.6, [Call("prefill_chunk", 1.2, 1.3, 6, 2),
                        Call("decode_step", 1.3, 1.4, 4)], tokens=4,
             dec_lens=[11, 21, 31]),
        Step(1.6, 1.9, [Call("decode_step", 1.6, 1.7, 4)], tokens=2,
             dec_lens=[12, 22]),
        Step(2.5, 2.8, [Call("decode_step", 2.5, 2.6, 4)], tokens=5),  # after
    ]
    reqs = {
        1: _req(1, 0.2, [0.9, 1.2, 1.6]),            # first token before
        2: _req(2, 1.1, [1.6, 1.6, 1.9], done=1.9),  # ttft 0.5
        3: _req(3, 1.05, [1.2, 1.9]),                # ttft 0.15
    }
    loop = SimpleNamespace(steps=steps, reqs=reqs)
    family = spec.load_module(HERE / "references" / "dense_gqa.py")
    cell = SimpleNamespace(family=family,
                           traffic={"engine": {"page_size": 4}})
    stats = SimpleNamespace(queue_wait_s={1: 9.0, 2: 0.25, 3: 0.5})
    records = [{"decoding": 4}, {"decoding": 3}, {"decoding": 0},
               {"decoding": 2}]
    return Run(cell, SIZES, 1000, 12.5, 1.0, 2.0, loop, stats, records, trace)


def test_percentile_is_nearest_rank():
    assert harness.percentile(range(1, 11), 90) == 9
    assert harness.percentile(range(1, 11), 95) == 10
    assert harness.percentile([7.0], 50) == 7.0
    assert harness.percentile([], 90) is None


def test_window_metrics():
    run = make_run()
    assert read("setup_s", run) == 12.5
    assert read("output_tok_s", run) == pytest.approx(9 / 1.0)
    assert sorted(harness.ttfts(run)) == pytest.approx([0.15, 0.5])
    # gaps inside the window: req 1 (1.2, 1.6), req 2 (0, 0.3), req 3 0.7
    assert sorted(harness.itl_gaps(run)) == pytest.approx([0.0, 0.3, 0.4,
                                                           0.7])
    assert read("itl_p95_ms", run) == pytest.approx(700.0)
    assert read("queue_wait_p90_s", run) == pytest.approx(0.5)
    assert read("decode_batch_mean", run) == pytest.approx(3.0)
    assert read("step_ms.decode", run) == pytest.approx(250.0)
    assert read("step_ms.prefill", run) == pytest.approx(400.0)
    # 6 prompt rows and 8 decode-produced tokens, 2 x 1000 operations each
    assert read("mfu", run) == pytest.approx(100 * 14 * 2000 / 989e12)


def test_trace_metrics_are_silent_without_a_trace():
    run = make_run()
    for name in ("qmm_roofline", "attn_roofline", "idle_share"):
        assert read(name, run) is None


def _trace(t_qmm=1e-3, t_attn=1e-4):
    ev = [(1.0, 1.0 + t_qmm, "void (anonymous namespace)::qmm_tc<unsigned "
           "short, 8, 7, 64>(float const*, float const*)"),
          (1.3, 1.3 + t_attn, "void paged_decode_piece<unsigned char, 5, "
           "2, 4, 128>(float const*)"),
          (0.1, 1.1, "at::native::elementwise_kernel<4>(int)"),
          (1.5, 1.9, "piece::merge(float const*)")]
    return tracing.DeviceTrace(ev, 1.0, 2.0)


def test_idle_share_is_the_union_of_device_intervals():
    tr = tracing.DeviceTrace([(0.5, 1.3, "a"), (1.2, 1.5, "b"),
                              (1.7, 1.8, "c"), (2.5, 3.0, "d")], 1.0, 2.0)
    assert tr.busy_s == pytest.approx(0.6)
    assert tr.gaps() == [(1.5, 1.7), (1.8, 2.0)]
    assert read("idle_share", make_run(tr)) == pytest.approx(40.0)


def test_qmm_roofline_counts_every_product_of_every_call():
    run = make_run(_trace(t_qmm=2e-3))
    L, d, ff, V, qd, kvd = 2, 8, 16, 32, 8, 4
    pf, pb = 989e12, 3.35e12

    def lt(M, K, N, g=1):
        return max(2 * M * K * N * g / pf,
                   (K * N * 2 * g + 4 * M * K + 4 * M * N) / pb)

    def call(rows, head):
        layer = lt(rows, d, qd) + 2 * lt(rows, d, kvd) + lt(rows, qd, d) \
            + lt(rows, d, ff, 2) + lt(rows, ff, d)
        return L * layer + lt(head, d, V)

    least = 3 * call(4, 4) + call(6, 1)   # three decodes, one chunk
    assert read("qmm_roofline", run) == pytest.approx(100 * least / 2e-3)


def test_attn_roofline_counts_valid_rows_and_visible_keys():
    run = make_run(_trace(t_attn=1e-5))
    L, H, kv, dh, page = 2, 4, 2, 2, 4
    pf, pb = 989e12, 3.35e12

    def dec(lens):
        fl = sum(4 * H * dh * n for n in lens)
        by = 2 * sum(lens) * kv * dh + 4 * sum(-(-n // page) for n in lens) \
            + 4 * len(lens) + 2 * len(lens) * H * dh * 4
        return max(fl / pf, by / pb)

    pairs = 6 * 2 + 6 * 7 // 2                    # 6 rows at offset 2
    chunk = max(4 * H * dh * pairs / pf,
                (2 * 6 * H * dh * 4 + 2 * 8 * kv * dh) / pb)
    least = L * (dec([10, 20, 30]) + dec([11, 21, 31]) + dec([12, 22])
                 + chunk)
    t = 1e-5 + 0.4                                # paged_decode + merge
    assert read("attn_roofline", run) == pytest.approx(100 * least / t)


def test_device_trace_clips_to_the_window_and_names_kernels():
    tr = _trace()
    assert tr.events[2][:2] == (1.0, 1.1)         # clipped at the open
    assert set(tr.by_name) == {"qmm_tc", "paged_decode_piece",
                               "at::native::elementwise_kernel",
                               "piece::merge"}
    assert tr.time_of(("qmm_",)) == pytest.approx(1e-3)
    bd = tr.breakdown(top=2)
    assert [n for n, _ in bd["device_ops"]] == ["piece::merge",
                                                "at::native::elementwise_kernel"]


@pytest.mark.parametrize("name,short", [
    ("void (anonymous namespace)::qmm_tc<unsigned short, 8, 7, 64>(float "
     "const*, Epilogue, int)", "qmm_tc"),
    ("qmm_splitk(float const*, float*, Epilogue, int, int, int)",
     "qmm_splitk"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "FillFunctor<float>, std::array<char*, 1ul> >(int, at::native::"
     "FillFunctor<float>, std::array<char*, 1ul>)",
     "at::native::vectorized_elementwise_kernel"),
    ("Memcpy HtoD (Pageable -> Device)", "Memcpy HtoD"),
])
def test_short_kernel_names(name, short):
    assert tracing.short_name(name) == short


def test_idle_gaps_are_named_by_the_innermost_host_span():
    tr = tracing.DeviceTrace([(1.0, 1.1, "k"), (1.5, 1.6, "k"),
                              (1.8, 2.0, "k")], 1.0, 2.0,
                             [(1.0, 1.65, "engine_step"),
                              (1.05, 1.45, "decode_step")])
    bd = tr.breakdown()
    assert bd["idle_gaps"] == [["decode_step", pytest.approx(0.4)],
                               ["client", pytest.approx(0.2)]]
