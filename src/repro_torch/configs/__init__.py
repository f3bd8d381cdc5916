"""Architecture configs ported so far: ``full()`` is the published config,
``reduced()`` a small same-family config for CPU tests."""
from importlib import import_module

ARCHS = ("llama3-8b", "yi-9b", "mistral-nemo-12b", "command-r-35b",
         "granite-moe-1b-a400m", "qwen3-moe-30b-a3b")

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCHS}


def get(arch_id: str, reduced: bool = False):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; ported: {sorted(_MODULES)}")
    mod = import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.reduced() if reduced else mod.full()
