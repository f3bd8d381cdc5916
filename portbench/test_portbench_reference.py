"""The plain reference against the program's CPU route (its kernels' plain
versions), on mistral-nemo-12b and yi-9b cut to the program's reduced
sizes: the logits of every served position, from chunked prefill into the
binary8 paged pool and batched decode steps over it, agree with the
reference's, and every served token is the reference's best."""
import json

import pytest
import torch

from portbench import harness, loadgen, weights
from portbench.conftest import make_tree, tiny_cell

PROMPTS = ([5, 17, 250, 3, 99, 1, 0, 42, 7, 8, 128, 64, 33],
           [200, 201, 13, 14, 77])
MAX_NEW = (6, 9)


def serve_with_logits(cell, w, sizes):
    """Two requests through the program's engine on the CPU, with the
    logits each of their tokens was taken from (request i holds slot i)."""
    from repro_torch.engine import Request
    engine = harness.build_engine(cell, sizes, weights.port_params(w), "cpu")
    model = engine.model
    step = {}
    pc, ds = model.prefill_chunk, model.decode_step

    def prefill_chunk(*a, slot, **k):
        out = pc(*a, slot=slot, **k)
        step[slot] = out[0][0, -1]
        return out

    def decode_step(*a, **k):
        out = ds(*a, **k)
        step["decode"] = out[0][:, -1]
        return out

    model.prefill_chunk, model.decode_step = prefill_chunk, decode_step
    reqs = [engine.enqueue(Request(i, list(p), n)) for i, (p, n) in
            enumerate(zip(PROMPTS, MAX_NEW))]
    logits = [[] for _ in reqs]
    while any(not r.done for r in reqs):
        before = [len(r.generated) for r in reqs]
        step.clear()
        engine.step()
        for i, r in enumerate(reqs):
            new = len(r.generated) - before[i]
            if new and before[i] == 0:
                logits[i].append(step[i])
                new -= 1
            logits[i] += [step["decode"][i]] * new
    return reqs, [torch.stack(x) for x in logits]


@pytest.mark.parametrize("base", ["mistral-nemo-12b", "yi-9b"])
def test_reference_matches_the_programs_cpu_route(tmp_path, base):
    root = make_tree(tmp_path, base)
    mix = json.loads((root / "portbench" / "traffic" / "tiny.json").read_text())
    mix["engine"].update(slots=2, prefill_chunk=8)  # chunks of 8, then 5
    (root / "portbench" / "traffic" / "tiny.json").write_text(json.dumps(mix))
    cell = tiny_cell(root)
    sizes = cell.family.sizes(cell.config)
    w = weights.dense_weights(sizes, 1234, "cpu")
    reqs, got = serve_with_logits(cell, w, sizes)
    seqs = [torch.tensor(list(r.prompt) + r.generated[:-1]) for r in reqs]
    at = [torch.arange(len(r.prompt) - 1, len(r.prompt) - 1 + len(r.generated))
          for r in reqs]
    ref = cell.family.logits(w, sizes, seqs, at)
    for r, g, x in zip(reqs, got, ref):
        assert len(r.generated) == r.max_new
        assert g.shape == x.shape
        assert torch.equal(x.argmax(dim=-1), torch.tensor(r.generated))
        assert float((g - x).abs().max()) <= 1e-4 * float(x.abs().max())
    sample = [harness.Req(loadgen.Spec(r.rid, list(r.prompt), r.max_new),
                          r, 0.0) for r in reqs]
    gap, n, more = harness.served_gap(
        cell.family, w, sizes, sample, "cpu",
        {"control": {"weight_fmt": "e5m2"}, "f64": {"compute": "float64"}})
    assert gap == 0.0 and n == sum(MAX_NEW)
    assert more["control"] > 0.0 and more["f64"] == 0.0


def test_reference_rounds_kv_to_binary8():
    """The K/V the reference attends over are binary8: rounding them to
    bfloat16 instead moves the logits."""
    from portbench.references import dense_gqa
    sizes = {"n_layers": 1, "d_model": 32, "n_heads": 4, "n_kv": 2,
             "head_dim": 8, "d_ff": 64, "vocab": 50, "rope_theta": 1e4,
             "rms_norm_eps": 1e-6}
    w = weights.dense_weights(sizes, 7, "cpu")
    seqs, at = [torch.arange(12)], [torch.arange(12)]
    base = dense_gqa.logits(w, sizes, seqs, at)[0]
    keep = dense_gqa._e5m2
    try:
        dense_gqa._e5m2 = dense_gqa._bf
        wide = dense_gqa.logits(w, sizes, seqs, at)[0]
    finally:
        dense_gqa._e5m2 = keep
    assert float((base - wide).abs().max()) > 1e-3
