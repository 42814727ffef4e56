"""Greedy decode and the whole-song pipeline of the port."""

from .pipeline import Music2MIDI  # noqa: F401
