"""Faults planted underneath the timed path, to see ``correct`` come out
false: the CPU tests plant each in a whole run of a tiny cell, and
``control.py --fault`` plants one in a run at a cell's own size on the
card.  ``setattr`` is the patching function (``monkeypatch.setattr`` in a
test, the builtin in a run that ends with its process)."""
import torch

FAULTS = ("token_altered", "state_unchanged", "half_batch_left_out")


def plant(fault: str, setattr=setattr) -> None:
    from repro_torch.engine import worker
    from repro_torch.kernels import paged_cache

    step = worker.DecodeWorker.step
    if fault == "token_altered":
        # every decoded token altered where it is produced
        def bad(self, params, tokens, states, nan_mask=None):
            nxt, b, st = step(self, params, tokens, states, nan_mask)
            return (nxt + 1) % 256, b, st
        setattr(worker.DecodeWorker, "step", bad)
    elif fault == "state_unchanged":
        # a decode step that returns the K/V cache as it found it
        setattr(paged_cache, "append_decode", lambda cache, k, v: cache)
    elif fault == "half_batch_left_out":
        # the second half of the decode batch keeps its last token
        def bad(self, params, tokens, states, nan_mask=None):
            nxt, b, st = step(self, params, tokens, states, nan_mask)
            half = nxt.shape[0] // 2
            return torch.cat([nxt[:half], tokens[half:, 0]]), b, st
        setattr(worker.DecodeWorker, "step", bad)
    else:
        raise ValueError(f"no fault {fault!r}; faults: {FAULTS}")
