"""Argparse wiring for the backend-selection flags, shared with the
reference CLI's spellings (``repro.launch.cli``); the legal values come
from the port's registries."""
from __future__ import annotations

from repro_torch import configs
from repro_torch.core.policy import POLICIES
from repro_torch.kernels import dispatch, paged_cache


def add_backend_args(ap, *, include_pool: bool = True):
    ap.add_argument("--policy", default="transprecision",
                    choices=sorted(POLICIES),
                    help="precision policy (tuned-artifact paths are not "
                         "ported yet)")
    ap.add_argument("--decode-impl", default=None,
                    choices=list(dispatch.legal_impls()),
                    help="attention backend (default: flash_pallas on "
                         "CUDA, else the model config's); flash_pallas = "
                         "the flash decode CUDA kernel over the gathered "
                         "pages, paged = the block-table CUDA kernel, xla "
                         "= the plain dequantize path")
    ap.add_argument("--matmul-impl", default=None,
                    choices=list(dispatch.legal_matmul_impls()),
                    help="matmul backend (default: model config); "
                         "qmm_pallas = pack the weights once at load and "
                         "stream them through the qmm CUDA kernel")
    if include_pool:
        ap.add_argument("--page-size", type=int,
                        default=paged_cache.DEFAULT_PAGE_SIZE,
                        help="tokens per KV page (multiple of 8)")
        ap.add_argument("--pool-pages", type=int, default=None,
                        help="physical pages in the shared pool (default: "
                             "slots * ceil(capacity / page_size))")
    return ap


def add_speculative_args(ap):
    """Speculative-decoding flags, the reference's spellings.  The draft
    serves binary8 packed weights and binary8 KV from its own page-pool
    namespace; exact greedy acceptance keeps the tokens those of
    non-speculative decode."""
    ap.add_argument("--speculate-k", type=int, default=0,
                    help="draft tokens proposed per engine step (0 = "
                         "speculation off); the target verifies all k in "
                         "one batched forward")
    ap.add_argument("--draft-config", default=None,
                    choices=list(configs.ARCHS),
                    help="arch of the draft model (default: the target's)")
    return ap
