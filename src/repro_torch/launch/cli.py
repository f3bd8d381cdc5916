"""Argparse wiring shared with the reference CLI's spellings
(``repro.launch.cli``): the backend, speculative, router and resilience
flags.  The legal backend values come from the port's registries."""
from __future__ import annotations

from repro_torch import configs
from repro_torch.kernels import dispatch, paged_cache


def add_backend_args(ap, *, include_pool: bool = True,
                     include_policy: bool = True):
    """The backend flags; ``--policy`` takes a registry name or a tuned
    artifact path, and ``--kv-fmt`` overrides a named policy's KV format
    (an artifact pins its knobs: ``tuning.artifact.load_policy`` rejects
    conflicting overrides).  ``include_policy=False`` leaves both out (the
    tuner searches the formats itself)."""
    if include_policy:
        ap.add_argument("--policy", default="transprecision",
                        help="precision policy: a registry name (binary32 "
                             "/ transprecision) or a path to a tuned policy "
                             "artifact JSON (per-layer kv_cache bindings "
                             "included)")
        ap.add_argument("--kv-fmt", default=None,
                        help="override a named policy's kv_cache format "
                             "(e.g. binary16alt); conflicts with an "
                             "artifact")
    ap.add_argument("--decode-impl", default=None,
                    choices=list(dispatch.legal_impls()),
                    help="attention backend (default: flash_pallas on "
                         "CUDA, flash_shmap+flash_pallas under a mesh with "
                         "a model dim, else the model config's); "
                         "flash_pallas = the flash decode CUDA kernel over "
                         "the gathered pages, paged = the block-table CUDA "
                         "kernel, xla = the plain dequantize path; "
                         "flash_shmap+BASE / ring+BASE shard the cache "
                         "over the ambient mesh's model dim and merge the "
                         "partials (flash_shmap: gathered; ring: rotated "
                         "shards folded), a bare wrapper means +xla")
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


def add_router_args(ap):
    """Async serving front-end flags, the reference's.  ``--prefill-
    workers`` works with or without ``--router``: the engine itself runs N
    concurrent prefill tasks (one transport each)."""
    ap.add_argument("--router", action="store_true",
                    help="serve through the asyncio request router "
                         "(concurrent submissions with per-request "
                         "futures; tokens stay bit-identical to the "
                         "synchronous run)")
    ap.add_argument("--prefill-workers", type=int, default=1,
                    help="concurrent prefill workers, one transport (and "
                         "with --disaggregate one streamed source pool) "
                         "each; the decode batch stays single (default: 1)")
    ap.add_argument("--max-pending", type=int, default=None,
                    help="router backpressure: cap on requests in flight "
                         "(queued + serving); submit() awaits when full "
                         "(default: unbounded)")
    return ap


def add_resilience_args(ap):
    """Fault-injection and recovery flags, the reference's.  The recovery
    machinery is always on; these flags bound it (deadlines, requeue caps,
    the watchdog) or exercise it (``--fault-plan``)."""
    ap.add_argument("--fault-plan", default=None,
                    help="deterministic fault schedule: an inline spec "
                         "'kind@step[/slot],...,seed=N' (kinds: "
                         "chunk_drop chunk_dup page_corrupt nan_logits "
                         "draft_div step_exception pool_exhaust) or a "
                         "path to a JSON file "
                         "{\"seed\": N, \"faults\": [{kind, step, slot}]}; "
                         "under a plan of recoverable faults the served "
                         "tokens are bit-identical to the fault-free run")
    ap.add_argument("--deadline-steps", type=int, default=None,
                    help="per-request deadline in engine steps from run "
                         "start; an expired request fails with a "
                         "classified DeadlineExceeded result (default: no "
                         "deadline)")
    ap.add_argument("--max-requeues", type=int, default=None,
                    help="evictions a request survives before failing as "
                         "a DeadLetterRequest (default: requeue forever)")
    ap.add_argument("--watchdog-s", type=float, default=None,
                    help="wall-clock budget per engine step; 3 "
                         "consecutive over-budget steps raise a "
                         "classified WatchdogTimeout (default: off)")
    return ap


def add_set_arg(ap):
    """``--set key=value`` (repeatable): a model-config override, as the
    reference's dry-run takes it (e.g. ``--set rwkv_fused=1``)."""
    ap.add_argument("--set", action="append", default=[],
                    help="cfg override key=value (e.g. rwkv_fused=1)")
    return ap


def parse_overrides(pairs) -> dict:
    """``["k=v", ...]`` -> ``{k: v}``, a value that parses as an int
    taken as one."""
    out = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        try:
            v = int(v)
        except ValueError:
            pass
        out[k] = v
    return out
