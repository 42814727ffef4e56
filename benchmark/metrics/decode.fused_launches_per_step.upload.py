"""Launches of the decode step's fused glue per decode step in the upload
cell: ``decode.fused_launches_per_step``'s reading, under a name of its
own since this cell reports ``upload_latency_p50_s``, not
``songs_per_min``.  A program without the counter gives nothing to
read."""

from benchmark.spec import metric_reader

read = metric_reader("decode.fused_launches_per_step")
