"""Collective census and roofline terms of a dry-run cell: the port of
``repro.launch.hlo_analysis``.

The port has no HLO.  The reference parses the compiled, SPMD-
partitioned HLO text for its collectives; here a cell's step runs on
``meta`` tensors over a mesh without ranks
(``core/ambient_mesh.MeshShape``, read as rank 0), and every collective
of ``core/collectives.py`` and of the decode wrappers records its kind
and the bytes of its result as it is called (the shape route,
``kernels/_route.py``).  :func:`collective_stats` reads those records in
the reference's keys and shape.  The reference also counts HLO
``while`` loops to assert its loop-free invariant (``_while_loops``);
PyTorch runs eagerly, every loop is unrolled in Python before any
operation is recorded, so there is no loop to count and the key is left
out.

Roofline constants: data-sheet values of one NVIDIA H100 80GB HBM3 at
its 700.00 W power limit (NVIDIA's H100 SXM data sheet).  ``PEAK_FLOPS``
is the f32 rate outside the tensor cores, the rate of the units that
keep a product's f32 precision, which ``PERF.md`` §6's bounds use for the
plain torch products every standard cell runs (the ``qmm_tc`` kernel's
split-TF32 products, ``decode_32k_qweights``, would run at 495 / 2
TFLOP/s); ``HBM_BW`` the device memory's rate; ``LINK_BW`` NVLink's 450
GB/s each way to the other cards of a host (the reference's ``ICI_BW``,
one link's rate).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels._route import COLLECTIVES

PEAK_FLOPS = 67e12       # f32 FLOP/s per card outside the tensor cores
HBM_BW = 3.35e12         # bytes/s per card
LINK_BW = 450e9          # bytes/s per card and direction, NVLink


def collective_stats(count) -> Dict[str, Dict[str, float]]:
    """Per collective kind ``{count, bytes}`` (bytes: the result's, the
    data volume leaving each collective) of a ``kernels/_route.
    CostCount``."""
    return {k: {"count": int(count.collectives[k]["count"]),
                "bytes": float(count.collectives[k]["bytes"])}
            for k in COLLECTIVES}


def total_collective_bytes(stats: Dict) -> float:
    return sum(v["bytes"] for k, v in stats.items()
               if not k.startswith("_"))


def roofline(flops_per_device: float, bytes_per_device: float,
             coll_bytes_per_device: float, n_chips: int,
             model_flops_global: float) -> Dict[str, float]:
    """The three roofline terms in seconds (per-device quantities in),
    the reference's formula and keys at the card's rates."""
    t_compute = flops_per_device / PEAK_FLOPS
    t_memory = bytes_per_device / HBM_BW
    t_collective = coll_bytes_per_device / LINK_BW
    dominant = max((t_compute, "compute"), (t_memory, "memory"),
                   (t_collective, "collective"))[1]
    hlo_flops_global = flops_per_device * n_chips
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_collective,
        "dominant": dominant,
        "bound_step_time_s": max(t_compute, t_memory, t_collective),
        "model_flops": model_flops_global,
        "hlo_flops_global": hlo_flops_global,
        "useful_flops_ratio": (model_flops_global / hlo_flops_global
                               if hlo_flops_global else 0.0),
        "roofline_fraction": (
            t_compute / max(t_compute, t_memory, t_collective)
            if max(t_compute, t_memory, t_collective) > 0 else 0.0),
    }
