"""Tools of the port, each ``python3 -m
music2midi_tpu_torch.tools.<name>`` with the argv and printed lines of
the repository's ``tools/<name>.py``: ``calibration_check``,
``export_npz``, ``average_checkpoints``, ``make_timbre_eval`` and
``realmix_check``."""
