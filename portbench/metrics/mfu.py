"""mfu (%), device: model operations of the window's tokens -- each
prompt token prefilled and each token a decode step produced, 2 x active
parameters each -- over the window's length at the card's bf16 peak."""
from portbench import costs


def read(run):
    tokens = sum(c.rows for s in run.steps for c in s.chunks) \
        + sum(len(s.dec_lens) for s in run.steps)
    if not tokens:
        return None
    return 100.0 * costs.model_flops(run.n_active, tokens) \
        / (run.window_s * costs.PEAK_FLOPS)
