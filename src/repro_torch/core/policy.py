"""Precision policies: the transprecision type system applied to models.

The port's copy of ``repro.core.policy``.  A :class:`PrecisionPolicy`
assigns a format to every tensor role; role keys are flat
(``"kv_cache"``) or per decoder layer (``"layers.3.kv_cache"``),
resolved by longest match, and :meth:`PrecisionPolicy.at_layer` flattens
a policy to one layer's view.

``native`` mode stores and computes in torch dtypes (binary8 ->
float8_e5m2, binary16 -> float16, binary16alt -> bfloat16, binary32 ->
float32); ``emulated`` mode keeps f32 tensors and sanitizes every
annotated edge with :func:`~repro_torch.core.flexfloat.quantize`.

Policies serialize to the reference's versioned JSON **artifact**
(:meth:`PrecisionPolicy.to_artifact` / :meth:`~PrecisionPolicy.
from_artifact`), the exchange format ``python -m repro.tuning`` writes and
``serve.py --policy path.json`` loads (``repro_torch.tuning.artifact``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Mapping, Optional

import torch

from repro_torch.kernels.dispatch import validate_impl, validate_matmul_impl

from .formats import BINARY8, BINARY16ALT, BINARY32, FpFormat, get_format

DEFAULT_ROLES = (
    "embed_w", "attn_w", "ffn_w", "router_w", "norm_w", "act", "attn_probs",
    "router_probs", "kv_cache", "logits", "grad_comm", "optim_m", "optim_v",
    "master",
)

_LAYERED_KEY = re.compile(r"^layers\.(\d+)\.(\w+)$")

# the policy-artifact JSON exchange format, the reference's
ARTIFACT_SCHEMA = "repro.policy"
ARTIFACT_VERSION = 1
_ARTIFACT_REQUIRED = ("schema", "version", "mode", "default_fmt", "formats")
_ARTIFACT_KEYS = frozenset(_ARTIFACT_REQUIRED) | {
    "decode_impl", "matmul_impl", "provenance"}


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    formats: Mapping[str, FpFormat]
    mode: str = "native"  # "native" | "emulated"
    default_fmt: FpFormat = BINARY32
    decode_impl: Optional[str] = None
    matmul_impl: Optional[str] = None

    def __post_init__(self):
        if self.mode not in ("native", "emulated"):
            raise ValueError(self.mode)
        validate_impl(self.decode_impl, what="PrecisionPolicy.decode_impl")
        validate_matmul_impl(self.matmul_impl,
                             what="PrecisionPolicy.matmul_impl")
        for key in self.formats:
            if "." not in key:
                continue
            m = _LAYERED_KEY.match(key)
            if m is None or m.group(2) not in DEFAULT_ROLES:
                raise ValueError(
                    f"bad hierarchical role key {key!r}: expected "
                    f"'layers.<index>.<role>' with a role from "
                    f"{DEFAULT_ROLES}")
        if self.mode == "native":
            for role, fmt in self.formats.items():
                if get_format(fmt).native_dtype is None:
                    raise ValueError(
                        f"role {role}: {fmt} has no native torch dtype; "
                        f"use mode='emulated'")

    def fmt(self, role: str, layer: Optional[int] = None) -> FpFormat:
        """``layers.{layer}.{role}`` > ``{role}`` > ``default_fmt``."""
        if layer is not None:
            f = self.formats.get(f"layers.{layer}.{role}")
            if f is not None:
                return get_format(f)
        return get_format(self.formats.get(role, self.default_fmt))

    def dtype(self, role: str, layer: Optional[int] = None) -> torch.dtype:
        """Storage dtype for ``role`` in native mode (f32 in emulated)."""
        if self.mode == "native":
            return self.fmt(role, layer).native_dtype
        return torch.float32

    def with_overrides(self, **roles) -> "PrecisionPolicy":
        """This policy with ``roles`` (role name -> format) replaced."""
        f = dict(self.formats)
        f.update({k: get_format(v) for k, v in roles.items()})
        return dataclasses.replace(self, formats=f)

    def at_layer(self, layer: int) -> "PrecisionPolicy":
        if not any("." in k for k in self.formats):
            return self
        prefix = f"layers.{layer}."
        f = {k: v for k, v in self.formats.items() if "." not in k}
        f.update({k[len(prefix):]: v for k, v in self.formats.items()
                  if k.startswith(prefix)})
        return dataclasses.replace(self, formats=f)


    def to_artifact(self, provenance: Optional[dict] = None) -> dict:
        """The versioned JSON-serializable policy artifact (``provenance``
        carried verbatim; :meth:`from_artifact` ignores it)."""
        return {
            "schema": ARTIFACT_SCHEMA,
            "version": ARTIFACT_VERSION,
            "mode": self.mode,
            "default_fmt": self.default_fmt.name,
            "formats": {k: get_format(v).name
                        for k, v in sorted(self.formats.items())},
            "decode_impl": self.decode_impl,
            "matmul_impl": self.matmul_impl,
            "provenance": dict(provenance or {}),
        }

    @classmethod
    def from_artifact(cls, artifact) -> "PrecisionPolicy":
        """Rebuild a policy from :meth:`to_artifact` output (a dict or a
        path to a JSON file).  Strict, as the reference: a non-artifact
        document, an unknown version, unknown top-level keys or an
        unparsable format name raise ``ValueError``."""
        doc = artifact
        if isinstance(artifact, (str, os.PathLike)):
            with open(artifact) as f:
                try:
                    doc = json.load(f)
                except json.JSONDecodeError as e:
                    raise ValueError(
                        f"policy artifact {artifact}: not valid JSON "
                        f"({e})") from e
        if not isinstance(doc, dict):
            raise ValueError(
                f"policy artifact must be a JSON object, got "
                f"{type(doc).__name__}")
        if doc.get("schema") != ARTIFACT_SCHEMA:
            raise ValueError(
                f"not a policy artifact: schema={doc.get('schema')!r} "
                f"(expected {ARTIFACT_SCHEMA!r})")
        if doc.get("version") != ARTIFACT_VERSION:
            raise ValueError(
                f"policy artifact version skew: artifact has version "
                f"{doc.get('version')!r}, this build reads "
                f"{ARTIFACT_VERSION} -- re-run the tuner")
        missing = [k for k in _ARTIFACT_REQUIRED if k not in doc]
        if missing:
            raise ValueError(f"policy artifact missing keys: {missing}")
        unknown = set(doc) - _ARTIFACT_KEYS
        if unknown:
            raise ValueError(
                f"policy artifact has unknown keys: {sorted(unknown)}")
        formats = doc["formats"]
        if not isinstance(formats, dict):
            raise ValueError("policy artifact 'formats' must be a mapping")
        try:
            fmts = {k: get_format(v) for k, v in formats.items()}
            default = get_format(doc["default_fmt"])
        except KeyError as e:
            raise ValueError(f"policy artifact names an unknown format: "
                             f"{e}") from e
        return cls(formats=fmts, mode=doc["mode"], default_fmt=default,
                   decode_impl=doc.get("decode_impl"),
                   matmul_impl=doc.get("matmul_impl"))

def binary32_policy(mode: str = "native",
                    kv_fmt: Optional[FpFormat] = None,
                    decode_impl: Optional[str] = None,
                    matmul_impl: Optional[str] = None) -> PrecisionPolicy:
    """Everything binary32 (``kv_fmt`` optionally swaps the KV format)."""
    f = {} if kv_fmt is None else {"kv_cache": get_format(kv_fmt)}
    return PrecisionPolicy(formats=f, mode=mode, default_fmt=BINARY32,
                           decode_impl=decode_impl, matmul_impl=matmul_impl)


def transprecision_policy(mode: str = "native",
                          kv_fmt: Optional[FpFormat] = None,
                          decode_impl: Optional[str] = None,
                          matmul_impl: Optional[str] = None,
                          ) -> PrecisionPolicy:
    """Weights/acts binary16alt, KV cache binary8, range-critical roles
    binary32 -- the reference's default after tuning."""
    f = {
        "embed_w": BINARY16ALT, "attn_w": BINARY16ALT, "ffn_w": BINARY16ALT,
        "router_w": BINARY32, "norm_w": BINARY32,
        "act": BINARY16ALT, "attn_probs": BINARY16ALT,
        "router_probs": BINARY32,
        "kv_cache": kv_fmt if kv_fmt is not None else BINARY8,
        "logits": BINARY32, "grad_comm": BINARY8,
        "optim_m": BINARY16ALT, "optim_v": BINARY32, "master": BINARY32,
    }
    return PrecisionPolicy(formats=f, mode=mode, decode_impl=decode_impl,
                           matmul_impl=matmul_impl)


POLICIES = {
    "binary32": binary32_policy,
    "transprecision": transprecision_policy,
}


def get_policy(name: str, **kw) -> PrecisionPolicy:
    return POLICIES[name](**kw)
