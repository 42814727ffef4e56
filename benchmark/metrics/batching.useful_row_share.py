"""Share of the lockstep decode's row-steps that served a real chunk
(``infer/pipeline.py`` ``generate_batch``): the sum of each real row's
decode steps over the sum of batch width times the batch's steps, from
``last_decode_stats`` over the window's batches, in %."""


def read(ctx):
    stats = [s for c in ctx["calls"] for s in c["stats"]]
    run = sum(s["batch_width"] * s["steps"] for s in stats)
    if not run:
        return None
    return 100.0 * sum(sum(s["row_steps"]) for s in stats) / run
