"""The training data pipeline of the port."""

from .dataset import (  # noqa: F401
    DataLoader,
    MetadataDict,
    Music2MIDIDataset,
    get_notes_segment,
    read_metadata,
)
