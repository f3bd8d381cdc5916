"""A tiny cell for the benchmark's CPU tests: the benchmark's own files
copied into a temporary tree, plus one configuration at the program's
reduced sizes, one small closed-loop mix and its limit, all added as
files, as a later change would add a cell."""
import json
import shutil
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

TINY_SIZES = {"num_hidden_layers": 2, "hidden_size": 64,
              "num_attention_heads": 4, "num_key_value_heads": 2,
              "head_dim": 16, "intermediate_size": 128, "vocab_size": 256}
TINY_MIX = {
    "why": "test mix",
    "arrivals": {"kind": "closed", "clients": 6},
    "lengths": {"pool": 64, "block": 8,
                "prompt": {"median": 12, "sigma": 0.5, "min": 4, "max": 24},
                "output": {"median": 6, "sigma": 0.5, "min": 2, "max": 12}},
    "engine": {"slots": 4, "page_size": 8, "capacity": 40,
               "prefill_chunk": 16, "prefill_workers": 2},
    "warmup": {"admitted": 4, "completed": 2},
    "sample": {"requests": 4},
}
# the program's plain CPU route reads 0 against the reference on every
# seed tried (six seeds); the binary8 control reads 0.157-0.322 on them
TINY_LIMIT = 0.02


def make_tree(tmp: Path, base: str = "mistral-nemo-12b") -> Path:
    """A copy of the benchmark with the cell ``tiny.chat`` (config
    ``tiny``, mix ``tiny``) added by files; returns the tree's root."""
    pb = tmp / "portbench"
    for d in ("configs", "traffic", "limits", "metrics", "references"):
        shutil.copytree(HERE / d, pb / d)
    cfg = json.loads((HERE / "configs" / f"{base}.json").read_text())
    cfg.update(TINY_SIZES)
    (pb / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "tiny.json").write_text(json.dumps(TINY_MIX))
    (pb / "limits" / "tiny.chat.json").write_text(
        json.dumps({"logit_gap": TINY_LIMIT}))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "test",
                             "file": "portbench/configs/tiny.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny.chat", "config": "tiny",
                               "traffic": "tiny", "chips": 1,
                               "why": "test"})
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


@pytest.fixture
def step_clock(monkeypatch):
    """The harness's clock advanced 1 ms at every reading, so that a
    window holds the same steps however loaded the test machine is."""
    from portbench import harness
    t = [0.0]

    def now():
        t[0] += 1e-3
        return t[0]

    monkeypatch.setattr(harness, "now", now)


@pytest.fixture
def tiny_tree(tmp_path, step_clock):
    return make_tree(tmp_path)


def tiny_cell(root: Path, name: str = "tiny.chat"):
    from portbench import spec
    return spec.Cell(spec.load_json(root / "BENCHMARK.json"), name, root,
                     root / "portbench")
