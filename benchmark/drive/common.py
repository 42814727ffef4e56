"""What the serving and training runners share: the card's description,
the profiler's traced slice, the weights file's check."""

from __future__ import annotations

import contextlib
import hashlib
import subprocess
from pathlib import Path
from typing import Dict, Iterator, Optional

import torch

from ..frozen import trace


def checkpoint_path(root: Path, config: dict) -> Path:
    """The configuration's weights file, refused unless its sha256 is the
    one the configuration states (the program and the reference both read
    it, and it lies outside the benchmark's folder)."""
    ck = config["checkpoint"]
    path = Path(root) / ck["path"]
    digest = hashlib.sha256(path.read_bytes()).hexdigest()
    if digest != ck["sha256"]:
        raise RuntimeError(f"{path}: sha256 {digest}, the configuration "
                           f"states {ck['sha256']}")
    return path


def card_power_limit() -> Optional[str]:
    """``nvidia-smi``'s name and power limit of the first card, or None
    where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def device_block(device: torch.device) -> dict:
    """The result's ``device``: platform, the card's name, cards used, and
    the fullest card's peak of allocated memory."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class TracedSlice:
    """A short stretch of the cell's work under ``torch.profiler``, on a
    card with its CUDA activity alone: the device's kernels, copies and
    sets and the host's runtime calls (recording every host operator as
    well would slow the dispatch-bound host loops it measures by more
    than half).  After the block, ``events`` holds the trace and
    ``window`` the slice's (start, end) on its clock: from its first
    event to its last."""

    def __init__(self):
        self.events = []
        self.window = (0.0, 0.0)

    @contextlib.contextmanager
    def run(self, device: torch.device) -> Iterator[None]:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CUDA if device.type == "cuda"
                else ProfilerActivity.CPU]
        sync(device)
        with profile(activities=acts) as prof:
            yield
            sync(device)
        self.events = trace.events_of(prof)
        if self.events:
            self.window = (min(e["ts"] for e in self.events),
                           max(e["ts"] + e["dur"] for e in self.events))

    def summary(self) -> Dict[str, object]:
        """``busy_s``, ``window_s`` and the ``breakdown`` of the slice."""
        busy = trace.busy_us(self.events, self.window) / 1e6
        return {"busy_s": busy,
                "window_s": (self.window[1] - self.window[0]) / 1e6,
                "breakdown": {
                    "device_ops": trace.top_device_ops(self.events,
                                                       self.window),
                    "idle_gaps": trace.idle_gaps(self.events, self.window)}}
