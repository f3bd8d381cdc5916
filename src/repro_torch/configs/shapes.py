"""The input-shape sets of the dry-run (LM family: seq_len x
global_batch): the port of ``repro.configs.shapes``, field for field.

``decode_*`` / ``long_*`` run ``decode_step`` (one new token over a KV
cache of seq_len); ``train_*`` the train step; ``prefill_*`` ``prefill``.
``long_500k`` needs sub-quadratic attention: it runs for the ssm and
hybrid configs and is skipped (recorded) for the full-attention ones.

``decode_impl`` pins the attention backend of a cell (None: the model
default); the ``*_flash`` variants live in ``FLASH_SHAPES``, selectable
by name everywhere shapes are, but outside the standard ``SHAPES``
sweep, so the 40-cell matrix stays the reference's.
"""
import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int
    # attention backend pinned by the cell: any registry spelling
    # (kernels/dispatch.py), e.g. "flash_pallas" or the composed
    # "flash_shmap+flash_pallas"; None = model default
    decode_impl: Optional[str] = None
    # matmul backend pinned by the cell: "xla" or "qmm_pallas" (the qmm
    # kernel over the packed weight store); None = default
    matmul_impl: Optional[str] = None

    def __post_init__(self):
        from repro_torch.kernels.dispatch import (validate_impl,
                                                  validate_matmul_impl)
        validate_impl(self.decode_impl, what=f"shape {self.name} decode_impl")
        validate_matmul_impl(self.matmul_impl,
                             what=f"shape {self.name} matmul_impl")

    def cfg_overrides(self) -> dict:
        """Model-config overrides this shape pins (merged by the dry-run)."""
        out = {}
        if self.decode_impl is not None:
            out["decode_impl"] = self.decode_impl
        if self.matmul_impl is not None:
            out["matmul_impl"] = self.matmul_impl
        return out


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

# the serving variants: decode_32k's traffic with the attention pinned to
# the flash decode kernel (alone, and sequence-sharded over the mesh's
# model dim), to the block-table kernel (over a contiguous cache it takes
# the identity paging view), to the ring, and with every product on the
# qmm kernel over the packed weight store
FLASH_SHAPES = {
    "decode_32k_flash": ShapeSpec("decode_32k_flash", "decode", 32768, 128,
                                  decode_impl="flash_pallas"),
    "decode_32k_flash_shmap": ShapeSpec(
        "decode_32k_flash_shmap", "decode", 32768, 128,
        decode_impl="flash_shmap+flash_pallas"),
    "decode_32k_paged": ShapeSpec("decode_32k_paged", "decode", 32768, 128,
                                  decode_impl="paged"),
    "decode_32k_ring": ShapeSpec("decode_32k_ring", "decode", 32768, 128,
                                 decode_impl="ring+flash_pallas"),
    "decode_32k_qweights": ShapeSpec("decode_32k_qweights", "decode",
                                     32768, 128,
                                     matmul_impl="qmm_pallas"),
}

ALL_SHAPES = {**SHAPES, **FLASH_SHAPES}

# configs whose attention is sub-quadratic (may run long_500k)
SUBQUADRATIC = {"rwkv6-1.6b", "recurrentgemma-2b"}


def runnable(arch_id: str, shape_name: str) -> bool:
    if shape_name == "long_500k":
        return arch_id in SUBQUADRATIC
    return True


def skip_reason(arch_id: str, shape_name: str) -> str:
    if shape_name == "long_500k" and arch_id not in SUBQUADRATIC:
        return ("full quadratic attention: 512k-token KV/score working set "
                "is infeasible; see DESIGN.md Arch-applicability")
    return ""
