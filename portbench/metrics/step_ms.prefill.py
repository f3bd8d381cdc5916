"""step_ms.prefill (ms), model step: mean wall time of the benchmark's
span around ``Engine.step``, over the window's steps that carried at least
one prefill chunk."""


def read(run):
    ts = [s.t1 - s.t0 for s in run.steps if s.chunks]
    return 1e3 * sum(ts) / len(ts) if ts else None
