"""The shapes the port's CUDA attention kernels take
(``flash_attention.check_kernel_shape``, the check ``flash_decode``,
``flash_prefill`` and ``paged_decode`` make before a launch): every
(G, head_dim) that a configuration of the reference uses, full or
reduced, is taken by all three kernels, and a shape outside the limits
raises a ``ValueError`` that names them."""
import pytest

pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402

KERNELS = {"flash_decode": tfa.MAX_GROUP, "paged_decode": tfa.MAX_GROUP,
           "flash_prefill": None}


def _reference_shapes():
    shapes = set()
    for arch in jconfigs.ARCHS:
        for reduced in (False, True):
            cfg = jconfigs.get(arch, reduced=reduced)
            shapes.add((cfg.n_heads // cfg.n_kv, cfg.head_dim))
    return sorted(shapes)


def test_reference_configs_use_the_widened_shapes():
    """The shapes the widening is for are among the reference's: head_dim
    16 at G 2 (the reduced configs), 256 at G 8 (paligemma) and at G 10
    (recurrentgemma), and the serving shape, 128 at G 4."""
    shapes = _reference_shapes()
    for want in ((2, 16), (8, 256), (10, 256), (4, 128)):
        assert want in shapes, shapes


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_every_reference_shape_is_taken(kernel):
    for G, dh in _reference_shapes():
        tfa.check_kernel_shape(kernel, G, dh, max_group=KERNELS[kernel])


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("G,dh", [(1, 8), (16, 8), (3, 24), (16, 256),
                                  (5, 200)])
def test_the_limits_are_taken(kernel, G, dh):
    tfa.check_kernel_shape(kernel, G, dh, max_group=KERNELS[kernel])


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("G,dh", [(0, 16), (4, 0), (4, 4), (4, 12),
                                  (4, 264), (4, 512)])
def test_other_shapes_raise_naming_the_limits(kernel, G, dh):
    with pytest.raises(ValueError) as err:
        tfa.check_kernel_shape(kernel, G, dh, max_group=KERNELS[kernel])
    msg = str(err.value)
    assert kernel in msg and "multiple of 8" in msg and "256" in msg
    assert f"G={G}" in msg and f"head_dim={dh}" in msg


def test_the_decode_kernels_take_at_most_16_query_heads_a_group():
    for kernel in ("flash_decode", "paged_decode"):
        with pytest.raises(ValueError, match="from 1 to 16"):
            tfa.check_kernel_shape(kernel, 17, 128)
    tfa.check_kernel_shape("flash_prefill", 32, 64, max_group=None)
