"""End to end on the CPU: the port's serving CLI gives the same greedy
tokens as the JAX serving CLI and as the port's synchronous reference
loop, under binary32 on reduced llama3-8b, with the JAX weights carried
across.  The JAX side serves the ``xla`` spellings; the port serves the
kernel spellings (``paged`` / ``flash_pallas`` / ``qmm_pallas``, their
plain versions on the CPU), with and without speculative decoding -- the
same f32 math, so the argmax tokens agree."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core.policy import get_policy as jget_policy  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models.registry import build as jbuild  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.engine import Engine, synchronous_generate  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import qparams  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402

FLAGS = ["--arch", "llama3-8b", "--reduced", "--policy", "binary32",
         "--page-size", "8", "--requests", "3", "--slots", "2",
         "--prompt-len", "9", "--max-new", "4", "--capacity", "16"]


def _jax_weights():
    """The weights ``repro.launch.serve`` serves (PRNGKey(0)), as numpy."""
    jmodel, _ = jbuild("llama3-8b", reduced=True)
    params = jmodel.init_params(jax.random.PRNGKey(0),
                                jget_policy("binary32"))
    return jax.tree.map(np.asarray, params)


def test_serve_tokens_match_jax_cli_and_synchronous_loop(capsys):
    want = jserve.main(FLAGS + ["--decode-impl", "xla",
                                "--matmul-impl", "xla"])
    params = params_from_numpy(_jax_weights(), device="cpu")
    got = tserve.main(FLAGS + ["--decode-impl", "paged", "--matmul-impl",
                               "qmm_pallas", "--device", "cpu"],
                      params=params)
    out = capsys.readouterr().out
    assert "[serve] 3 requests" in out and "tok/s" in out
    assert [r.prompt for r in got] == [r.prompt for r in want]
    assert all(r.done and not r.failed for r in got)
    assert [r.generated for r in got] == [r.generated for r in want]

    model, cfg = build("llama3-8b", reduced=True)
    policy = get_policy("binary32", decode_impl="paged",
                        matmul_impl="qmm_pallas")
    sync = synchronous_generate(
        model, cfg, policy, qparams.encode_params(params, policy),
        [r.prompt for r in got], max_new=4, capacity=16, device="cpu")
    assert sync == [r.generated for r in got]


def test_serve_evicts_lifo_and_still_matches_synchronous_loop():
    """A pool too small for both slots: the newest sequence is evicted and
    requeued, and the tokens still equal the synchronous loop's."""
    flags = ["--reduced", "--policy", "binary32", "--page-size", "8",
             "--requests", "3", "--slots", "2", "--prompt-len", "12",
             "--max-new", "6", "--capacity", "24", "--pool-pages", "4",
             "--device", "cpu", "--decode-impl", "paged"]
    reqs = tserve.main(flags)
    assert all(r.done for r in reqs)
    assert sum(r.evictions for r in reqs) > 0
    model, cfg = build("llama3-8b", reduced=True)
    policy = get_policy("binary32", decode_impl="paged")
    gen = torch.Generator(device="cpu").manual_seed(0)
    params = model.init_params(gen, policy, device="cpu")
    sync = synchronous_generate(model, cfg, policy, params,
                                [r.prompt for r in reqs], max_new=6,
                                capacity=24, device="cpu")
    assert sync == [r.generated for r in reqs]


def test_entry_points_refuse_a_missing_card():
    """With no CUDA device and no explicit CPU, the port raises instead of
    falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--reduced", "--requests", "1"])
    model, cfg = build("llama3-8b", reduced=True)
    policy = get_policy("binary32")
    gen = torch.Generator(device="cpu").manual_seed(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init_params(gen, policy)
    params = model.init_params(gen, policy, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init_state(1, 8, policy)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({"w": np.zeros(2, np.float32)})
    with pytest.raises(RuntimeError, match="CUDA"):
        synchronous_generate(model, cfg, policy, params, [[1, 2]],
                             max_new=1, capacity=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(model, cfg, policy, params, slots=1, capacity=8,
               page_size=8)


@pytest.fixture(scope="module")
def jax_cli_requests():
    return jserve.main(FLAGS + ["--decode-impl", "xla", "--matmul-impl",
                                "xla"])


@pytest.mark.parametrize("extra", [
    ["--decode-impl", "flash_pallas"],
    ["--decode-impl", "flash_pallas", "--speculate-k", "2"],
    ["--decode-impl", "paged", "--matmul-impl", "qmm_pallas",
     "--speculate-k", "2"]], ids=["flash", "flash-spec2", "paged-qmm-spec2"])
def test_serve_flash_and_speculative_tokens_match_jax_cli(
        jax_cli_requests, extra, capsys):
    """``--decode-impl flash_pallas`` (the serving default on a card) and
    ``--speculate-k``: the JAX CLI's tokens and the synchronous loop's."""
    want = jax_cli_requests
    params = params_from_numpy(_jax_weights(), device="cpu")
    got = tserve.main(FLAGS + extra + ["--device", "cpu"], params=params)
    out = capsys.readouterr().out
    assert ("accept rate:" in out) == ("--speculate-k" in extra)
    assert all(r.done and not r.failed for r in got)
    assert [r.generated for r in got] == [r.generated for r in want]
    model, cfg = build("llama3-8b", reduced=True)
    policy = get_policy("binary32", decode_impl="flash_pallas")
    sync = synchronous_generate(model, cfg, policy, params,
                                [r.prompt for r in got], max_new=4,
                                capacity=16, device="cpu")
    assert sync == [r.generated for r in got]


def test_speculative_engine_evicts_and_matches_synchronous_loop():
    """The eviction run above with ``--speculate-k 2``: both namespaces
    under pool pressure, the tokens still the synchronous loop's."""
    flags = ["--reduced", "--policy", "binary32", "--page-size", "8",
             "--requests", "3", "--slots", "2", "--prompt-len", "12",
             "--max-new", "6", "--capacity", "24", "--pool-pages", "8",
             "--device", "cpu", "--decode-impl", "flash_pallas",
             "--speculate-k", "2"]
    reqs = tserve.main(flags)
    assert all(r.done for r in reqs)
    assert sum(r.evictions for r in reqs) > 0
    model, cfg = build("llama3-8b", reduced=True)
    policy = get_policy("binary32", decode_impl="flash_pallas")
    gen = torch.Generator(device="cpu").manual_seed(0)
    params = model.init_params(gen, policy, device="cpu")
    sync = synchronous_generate(model, cfg, policy, params,
                                [r.prompt for r in reqs], max_new=6,
                                capacity=24, device="cpu")
    assert sync == [r.generated for r in reqs]


def test_default_serving_impl_is_flash_decode_on_a_card():
    assert dispatch.default_serving_impl("cuda") == "flash_pallas"
    assert dispatch.default_serving_impl("cpu") is None
    assert dispatch.default_serving_impl(None) is None
