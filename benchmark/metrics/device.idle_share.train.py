"""Share of the traced slice (train steps back to back) in which the card
ran no kernel, copy or set, in %."""

from benchmark.frozen.trace import idle_share


def read(ctx):
    tr = ctx.get("trace")
    if not ctx["on_card"]:
        return None
    if not tr or not tr.get("steps"):
        return None
    return 100.0 * idle_share(tr["slice"].events, tr["slice"].window)
