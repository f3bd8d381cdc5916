"""Policy-artifact helpers for every consumer of ``--policy``: the port
of ``repro.tuning.artifact`` (the resolver and the writer).

A ``--policy`` *spec* is a registry name (``binary32`` /
``transprecision``) or a path to a tuned artifact JSON; :func:`load_policy`
resolves both.  Override semantics are the reference's: a named policy
takes the per-knob flags, but an artifact *pins* its knobs -- a
conflicting ``--decode-impl`` / ``--matmul-impl``, or any ``--kv-fmt``,
next to ``--policy path.json`` raises.  Knobs the artifact leaves unset
(``null``) may still be filled in.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

from repro_torch.core.formats import get_format
from repro_torch.core.policy import POLICIES, PrecisionPolicy, get_policy


def is_artifact_spec(spec) -> bool:
    """True when a ``--policy`` value names an artifact file, not a
    registry policy."""
    if not isinstance(spec, (str, os.PathLike)):
        return False
    s = os.fspath(spec)
    return s not in POLICIES and (s.endswith(".json") or os.sep in s
                                  or os.path.exists(s))


def load_policy(spec, *, decode_impl: Optional[str] = None,
                matmul_impl: Optional[str] = None,
                kv_fmt=None) -> PrecisionPolicy:
    """Resolve a ``--policy`` spec (registry name or artifact path)."""
    if not is_artifact_spec(spec):
        if spec not in POLICIES:
            raise ValueError(
                f"--policy {spec!r}: neither a named policy "
                f"({sorted(POLICIES)}) nor a policy-artifact path")
        kw = {}
        if kv_fmt is not None:
            kw["kv_fmt"] = get_format(kv_fmt)
        return get_policy(spec, decode_impl=decode_impl,
                          matmul_impl=matmul_impl, **kw)

    policy = PrecisionPolicy.from_artifact(spec)
    if kv_fmt is not None:
        raise ValueError(
            f"--kv-fmt conflicts with --policy {spec}: the artifact pins "
            f"every format binding (including per-layer kv_cache); re-run "
            f"the tuner instead of overriding")
    for knob, flag in (("decode_impl", decode_impl),
                       ("matmul_impl", matmul_impl)):
        pinned = getattr(policy, knob)
        if flag is not None and pinned is not None and flag != pinned:
            raise ValueError(
                f"--{knob.replace('_', '-')}={flag} conflicts with "
                f"--policy {spec}: the artifact pins {knob}={pinned!r} "
                f"(tuned bindings are only valid on the backend they were "
                f"verified on)")
        if flag is not None and pinned is None:
            policy = dataclasses.replace(policy, **{knob: flag})
    return policy


def save_artifact(artifact: dict, path) -> None:
    """Write an artifact dict as canonical JSON (round-trip checked)."""
    PrecisionPolicy.from_artifact(artifact)  # refuse to write garbage
    d = os.path.dirname(os.fspath(path))
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(artifact, f, indent=1, sort_keys=True)
        f.write("\n")
