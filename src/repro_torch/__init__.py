"""PyTorch/CUDA port of the transprecision platform (``repro``).

The package mirrors ``repro``'s layout so a module's counterpart is easy to
find: ``core`` (formats, quantization, packed tensors, policies),
``kernels`` (the codec, the backend registries, the paged cache and the
hand-written Hopper kernels under ``csrc/``), ``models``, ``engine`` and
``launch``.  It imports ``torch`` and never ``jax``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
:func:`resolve_device` raises when CUDA is absent and the CPU was not
asked for.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless ``device`` names
    another one.  Raises when CUDA is asked for (or defaulted to) and
    ``torch.cuda.is_available()`` is false -- the port never falls back to
    the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' (--device cpu) to run the plain "
            "PyTorch versions on the CPU")
    return dev
