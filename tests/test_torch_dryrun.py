"""The compile-only tooling of the port (``configs/shapes.py``,
``launch/{dryrun,report,hlo_analysis}.py``) and the kernels' routes, on
the CPU.

* ``shapes``: the reference's shape sets field for field, and the same
  ``runnable`` / ``skip_reason`` on every config.
* ``roofline``: the reference's dict when the reference's TPU constants
  are patched in; ``model_flops`` the reference's on every config x
  shape.  Importing ``repro.launch.dryrun`` sets ``XLA_FLAGS`` (512 host
  devices), so JAX is initialised first and the import runs under a
  patched ``os.environ``: no later test or child inherits the flag.
* Cells on reduced configs over a (2, 4) mesh without ranks: argument
  bytes equal ``tree_block_bytes`` of the same trees, the collectives
  counted, the fused rwkv6 train cell gathering fewer leaves.
* The route helper: on ``meta`` no kernel launches and no plain version
  runs (a spy on ``KernelLib.launch`` and every plain version, over
  prefill and decode cells that reach every kernel entry of the path);
  any device but cuda, cpu and meta raises.
* ``report``: the tables render from a temporary directory, and
  ``tuning_table`` equals the reference's over the repo's tuning cache
  and its two artifacts.

Nothing is written under ``results/``.
"""
import dataclasses
import os
import types
from unittest import mock

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get as jget_config  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro.launch import hlo_analysis as jhlo  # noqa: E402
from repro.launch import report as jreport  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import shapes  # noqa: E402
from repro_torch.core.ambient_mesh import MeshShape  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.core.tree import flatten_with_path  # noqa: E402
from repro_torch.kernels import (_build, _route, flash_attention,  # noqa: E402
                                 flexfloat_cast, layernorm, paged_attention,
                                 qmatmul, rmsnorm)
from repro_torch.launch import dryrun, hlo_analysis, report  # noqa: E402
from repro_torch.launch import sharding  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = MeshShape(("data", "model"), (2, 4))


def _jdryrun():
    """``repro.launch.dryrun`` imported with ``os.environ`` restored
    afterwards (its import sets XLA_FLAGS for 512 host devices; JAX is
    initialised first, so the flag reaches no backend either)."""
    jax.devices()
    with mock.patch.dict(os.environ):
        from repro.launch import dryrun as jdryrun
    return jdryrun


def test_shapes_are_the_references():
    for name in ("SHAPES", "FLASH_SHAPES", "ALL_SHAPES"):
        got, want = getattr(shapes, name), getattr(jshapes, name)
        assert list(got) == list(want)
        for k in got:
            assert dataclasses.asdict(got[k]) == dataclasses.asdict(want[k])
            assert got[k].cfg_overrides() == want[k].cfg_overrides()
    assert shapes.SUBQUADRATIC == jshapes.SUBQUADRATIC
    for arch in configs.ARCHS:
        for s in shapes.ALL_SHAPES:
            assert shapes.runnable(arch, s) == jshapes.runnable(arch, s)
            assert shapes.skip_reason(arch, s) == jshapes.skip_reason(arch, s)
    with pytest.raises(ValueError, match="decode_impl"):
        shapes.ShapeSpec("bad", "decode", 8, 1, decode_impl="nope")
    with pytest.raises(ValueError, match="matmul_impl"):
        shapes.ShapeSpec("bad", "decode", 8, 1, matmul_impl="nope")


def test_roofline_is_the_references(monkeypatch):
    """The reference's formula and keys: equal dicts at the reference's
    TPU constants; at the card's, its rates."""
    args = (3.1e12, 4.7e11, 2.2e9, 256, 9.9e14)
    for mine, theirs in (("PEAK_FLOPS", "PEAK_FLOPS"), ("HBM_BW", "HBM_BW"),
                         ("LINK_BW", "ICI_BW")):
        monkeypatch.setattr(hlo_analysis, mine, getattr(jhlo, theirs))
    assert hlo_analysis.roofline(*args) == jhlo.roofline(*args)
    monkeypatch.undo()
    r = hlo_analysis.roofline(*args)
    assert r["t_memory_s"] == 4.7e11 / 3.35e12
    assert r["t_compute_s"] == 3.1e12 / 67e12
    assert r["t_collective_s"] == 2.2e9 / 450e9
    assert set(hlo_analysis.collective_stats(_route.CostCount())) == \
        set(jhlo.collective_stats("")) - {"_while_loops"}


def test_model_flops_are_the_references():
    jdryrun = _jdryrun()
    for arch in configs.ARCHS:
        for name, spec in shapes.ALL_SHAPES.items():
            for k in (0, 4):
                assert dryrun.model_flops(configs.get(arch), spec, k) == \
                    jdryrun.model_flops(jget_config(arch),
                                        jshapes.ALL_SHAPES[name], k)
    assert "512" not in os.environ.get("XLA_FLAGS", "")


CELLS = [("llama3-8b", "train_4k"), ("llama3-8b", "prefill_32k"),
         ("llama3-8b", "decode_32k"), ("qwen3-moe-30b-a3b", "decode_32k"),
         ("recurrentgemma-2b", "long_500k"), ("whisper-tiny", "decode_32k"),
         ("paligemma-3b", "prefill_32k")]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_reduced_cell_counts(arch, shape):
    """A reduced cell on the (2, 4) mesh: ok, its argument bytes are
    ``tree_block_bytes`` of its input trees under their shardings (packed
    leaves at their payloads), every count positive, the roofline's
    keys the reference's."""
    pol = get_policy("transprecision")
    res = dryrun.run_cell(arch, shape, multi_pod=False, mesh=MESH,
                          reduced=True, verbose=False)
    assert res["status"] == "ok" and res["n_chips"] == 8
    _, _, ins, shs = dryrun.input_specs(arch, shape, MESH, pol,
                                        reduced=True)
    want = 0
    for n in ins:
        flat = [(getattr(t, "payload", t), sh) for (_, t), (_, sh) in zip(
            flatten_with_path(ins[n]), flatten_with_path(shs[n]))]
        flat = [(t, sh) for t, sh in flat if isinstance(t, torch.Tensor)]
        want += sharding.tree_block_bytes([t for t, _ in flat],
                                          [sh for _, sh in flat])
    assert res["memory"]["argument_size_in_bytes"] == want
    assert res["memory"]["gathered_argument_bytes"] >= want
    assert res["flops_per_device"] > 0 and res["bytes_per_device"] > 0
    assert set(res["roofline"]) == set(jhlo.roofline(1.0, 1.0, 1.0, 1, 1.0))
    assert res["collectives"]["all-gather"]["count"] > 0
    if shape == "train_4k":
        assert res["collectives"]["all-reduce"]["count"] > 0
        # every model rank computes the whole model on the same rows: at
        # most 1 / (model ranks) of the counted operations are the
        # model's, less with the remat recompute and the attention
        r = res["roofline"]["useful_flops_ratio"]
        assert 0 < r <= 1 / MESH.size(1)


def test_fused_rwkv_train_cell_gathers_fewer_leaves():
    """train_4k of reduced rwkv6 on (2, 4): with ``rwkv_fused=1`` a layer
    gathers 5 leaves fewer (wr, wk, wv, wg, wd1 -> wrkvg; cm_k, cm_r ->
    cm_kr)."""
    cfg = configs.get("rwkv6-1.6b", reduced=True)
    counts = [dryrun.run_cell("rwkv6-1.6b", "train_4k", multi_pod=False,
                              mesh=MESH, reduced=True, verbose=False,
                              cfg_overrides=o)["collectives"]["all-gather"]
              ["count"] for o in (None, {"rwkv_fused": 1})]
    assert counts[0] - counts[1] == 5 * cfg.n_layers


def _spies(monkeypatch):
    """Every plain version and ``KernelLib.launch`` raise when called."""
    def boom(*a, **k):
        raise AssertionError("reached on meta")
    monkeypatch.setattr(_build.KernelLib, "launch", boom)
    for mod, names in (
            (qmatmul, ("qmatmul_plain", "qmm_grouped_plain",
                       "qmm_grouped_ffn_plain")),
            (rmsnorm, ("rmsnorm_plain", "add_rmsnorm_plain")),
            (layernorm, ("layernorm_plain", "add_layernorm_plain")),
            (flash_attention, ("flash_decode_plain", "flash_prefill_plain")),
            (paged_attention, ("paged_decode_plain",)),
            (flexfloat_cast, ("flexfloat_cast_plain", "quantize_encode_plain",
                              "dequantize_decode_plain"))):
        for n in names:
            monkeypatch.setattr(mod, n, boom)


@pytest.mark.parametrize("arch,shape,over", [
    ("llama3-8b", "decode_32k_qweights", {"decode_impl": "flash_pallas"}),
    ("llama3-8b", "prefill_32k", {"decode_impl": "flash_pallas",
                                  "matmul_impl": "qmm_pallas"}),
    ("llama3-8b", "decode_32k_paged", {"matmul_impl": "qmm_pallas"}),
    ("qwen3-moe-30b-a3b", "decode_32k", {"matmul_impl": "qmm_pallas"}),
    ("rwkv6-1.6b", "decode_32k", {"matmul_impl": "qmm_pallas",
                                  "rwkv_fused": 1}),
    ("llama3-8b", "decode_32k_flash_shmap", {}),
    ("llama3-8b", "decode_32k_ring", {})])
def test_meta_takes_the_shape_route(monkeypatch, arch, shape, over):
    """On meta the kernels' wrappers neither launch nor run their plain
    versions; the shape route records each kernel of the path."""
    _spies(monkeypatch)
    res = dryrun.run_cell(arch, shape, multi_pod=False, mesh=MESH,
                          reduced=True, verbose=False, cfg_overrides=over)
    assert res["status"] == "ok"
    kernels = res["kernels"]
    norm = "add_layernorm" if arch == "rwkv6-1.6b" else "add_rmsnorm"
    assert kernels[norm]["calls"] > 0
    if over.get("matmul_impl") == "qmm_pallas" or "qweights" in shape:
        assert kernels["qmm_tc"]["calls"] > 0
    if "flash" in over.get("decode_impl", "") or "flash" in shape:
        name = "flash_prefill" if "prefill" in shape else "flash_decode"
        assert kernels[name]["calls"] > 0
    if "paged" in shape:
        assert kernels["paged_decode"]["calls"] > 0
    if arch.startswith("qwen3"):
        assert kernels["qmm_tc_grouped_ffn"]["calls"] > 0
    if arch == "rwkv6-1.6b":
        assert kernels["dequantize_decode"]["calls"] == 2 * 2
    if shape == "decode_32k_flash_shmap":
        assert res["collectives"]["all-gather"]["count"] > 0
    if shape == "decode_32k_ring":      # K and V, 3 hops of 4 model ranks
        cfg = configs.get(arch, reduced=True)
        assert res["collectives"]["collective-permute"]["count"] == \
            2 * (MESH.size(1) - 1) * cfg.n_layers


def test_route_helper():
    assert _route.route(torch.empty(1)) == "cpu"
    assert _route.route(torch.empty(1, device="meta")) == "meta"
    fake = types.SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(RuntimeError, match="xpu"):
        _route.route(fake)
    x = torch.empty((4, 8), device="meta")
    with _route.count_costs() as c:
        y = qmatmul.qmatmul(x, torch.empty((8, 16), dtype=torch.uint16,
                                           device="meta"), None,
                            "binary16alt")
    assert y.device.type == "meta" and tuple(y.shape) == (4, 16)
    assert c.kernels["qmm_tc"] == {
        "calls": 1, "flops": 2.0 * 4 * 8 * 16,
        "bytes": float(qmatmul.qmm_hbm_bytes(4, 8, 16, "binary16alt"))}


def test_visible_pairs_counts_the_mask():
    for args in ((5, 9, 4, None, 0), (7, 7, 0, 3, 0), (6, 10, 4, None, 3),
                 (8, 8, 0, 2, 5), (3, 12, 9, 4, 6)):
        m = flash_attention.prefill_mask(*args, device="cpu")
        assert flash_attention.visible_pairs(*args) == int(m.sum())


def test_cli_and_report_render(tmp_path, monkeypatch, capsys):
    """The CLI writes whisper-tiny's four single-mesh cells (long_500k
    skipped) into a temporary directory, and ``report`` renders them; its
    tuning table is the reference's (the repo's cache and artifacts)."""
    out = tmp_path / "dr"
    dryrun.main(["--arch", "whisper-tiny", "--mesh", "single", "--out",
                 str(out)])
    assert len(list(out.glob("*.json"))) == 4
    monkeypatch.chdir(ROOT)
    text = report.render(str(out))
    assert "### single mesh (3 ok / 4 cells)" in text
    assert "| whisper-tiny | long_500k | — |" in text
    assert "| whisper-tiny | decode_32k | decode |" in text
    assert report.tuning_table() == jreport.tuning_table()
    assert "llama3-8b.reduced.json" in report.tuning_table()
    report.main([str(out)])
    assert "tuned precision bindings" in capsys.readouterr().out
