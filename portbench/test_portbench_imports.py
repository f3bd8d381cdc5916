"""No run loads JAX or the JAX package: the check compares each loaded
module's top-level name, whole."""
import subprocess
import sys

import pytest

from portbench import harness
from portbench.conftest import ROOT


@pytest.mark.parametrize("mods,found", [
    (["repro_torch", "repro_torch.engine", "reprox", "jaxtyping", "flaxen",
      "torch"], []),
    (["jax"], ["jax"]),
    (["jax.numpy", "torch"], ["jax.numpy"]),
    (["repro", "repro.core.policy", "repro_torch"], ["repro",
                                                     "repro.core.policy"]),
    (["jaxlib.xla_client", "flax.linen"], ["flax.linen",
                                           "jaxlib.xla_client"]),
])
def test_banned_by_whole_top_level_name(mods, found):
    assert harness.banned_modules(mods) == found


def test_the_harness_and_the_program_load_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "from portbench import harness, spec, control, faults, procenv\n"
            "import repro_torch.engine, repro_torch.models.transformer\n"
            "import repro_torch.models.qparams, repro_torch.core.policy\n"
            "spec.load_module(%r)\n"
            "print('banned', harness.banned_modules())\n") % (
        str(ROOT / "src"), str(ROOT),
        str(ROOT / "portbench" / "references" / "dense_gqa.py"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert "banned []" in out.stdout, out.stdout + out.stderr


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    out = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"),
                          "--workload", "nemo12b.chat", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
