"""Songs per ``generate_batch`` call the web UI's ``DynamicBatcher``
dispatched in the window (``serve/batcher.py``), counted by the harness's
proxy around the engine."""


def read(ctx):
    calls = ctx["calls"]
    if not ctx.get("requests") or not calls:
        return None
    return sum(len(c["keys"]) for c in calls) / len(calls)
