"""Kind ``songs_closed_loop_hybrid``: the catalogue job of
``kinds/songs_closed_loop.py`` (the same calls, window and
``songs_per_min``) on a configuration whose decoder is the hybrid one:
its engine, its run and its check are ``drive/hybrid.py``'s."""

from __future__ import annotations

from benchmark.drive import hybrid
from benchmark.spec import load


def run(root, cell, seed, seconds, traced, device, override=None) -> dict:
    closed = load("kinds", "songs_closed_loop", cell.pkg)
    return hybrid.run(root, cell, seed, seconds, traced, device, override,
                      widths=closed.widths, window=closed.window)
