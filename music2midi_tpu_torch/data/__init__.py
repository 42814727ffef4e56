"""The training data pipeline of the port, and its data-prep chain.

The loader (``dataset.py``) is imported on first use of its names, so the
prep stages (``python3 -m music2midi_tpu_torch.data.<stage>``) and the
metadata reader start without the training modules.  The stages, in
order: ``synthesize_corpus``, ``align_audio_midi``, ``midi_to_numpy``,
``compute_metrics``, ``generate_split``.
"""

from .metadata import dump_metadata, read_metadata  # noqa: F401

_LOADER = ("DataLoader", "MetadataDict", "Music2MIDIDataset",
           "get_notes_segment")


def __getattr__(name):
    if name in _LOADER:
        from . import dataset

        return getattr(dataset, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
