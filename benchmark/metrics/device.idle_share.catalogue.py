"""Share of the traced slice (one call over the catalogue's pool) in
which the card ran no kernel, copy or set, in %."""

from benchmark.frozen.trace import idle_share


def read(ctx):
    tr = ctx.get("trace")
    if not ctx["on_card"]:
        return None
    if not tr or not tr.get("calls"):
        return None
    return 100.0 * idle_share(tr["slice"].events, tr["slice"].window)
