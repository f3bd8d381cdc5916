"""The environment that every process of the benchmark sets before it
imports torch: the build and kernel caches at fixed paths inside the
checkout, no JAX loaded by a library on its own, and one host thread for
the CPU's share of the work (one process a card with few threads keeps
the host's times steadier)."""
import os
from pathlib import Path

THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def set_env(root: Path) -> None:
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build"
                                             / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    for var in THREAD_VARS:
        os.environ[var] = "1"


def one_thread() -> None:
    """After torch is imported: one intra-op thread."""
    import torch
    torch.set_num_threads(1)
