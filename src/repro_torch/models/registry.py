"""Arch registry: ``--arch <id>`` -> (Model, ModelConfig), dense archs."""
from __future__ import annotations

from repro_torch import configs

from .transformer import Model

ARCHS = configs.ARCHS


def build(arch_id: str, reduced: bool = False):
    cfg = configs.get(arch_id, reduced=reduced)
    return Model(cfg), cfg
