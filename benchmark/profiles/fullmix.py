"""The ``fullmix`` profile: a pop-song mix of piano under bass, pad,
drums and sometimes a vocal lead, bus-compressed, as the corpus's
``render_fullmix`` makes it (``frozen/songs.py``)."""

from benchmark.frozen.songs import fullmix_song as render  # noqa: F401
