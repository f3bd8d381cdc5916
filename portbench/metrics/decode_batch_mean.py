"""decode_batch_mean (rows), engine: the mean number of decoding slots of
the program's ``EngineStats`` step records inside the window, over the
steps that ran a decode step."""


def read(run):
    rows = [r["decoding"] for r in run.records if r["decoding"] > 0]
    return sum(rows) / len(rows) if rows else None
