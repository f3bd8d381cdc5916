"""output_tok_s (tokens/s): every token that became visible inside the
window, over the window's length."""


def read(run):
    return sum(s.tokens for s in run.steps) / run.window_s
