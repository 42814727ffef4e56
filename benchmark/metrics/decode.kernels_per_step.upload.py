"""Device kernels per decode step in the upload cell:
``decode.kernels_per_step``'s reading, under a name of its own since this
cell reports ``upload_latency_p50_s``, not ``songs_per_min``."""

from benchmark.spec import metric_reader

read = metric_reader("decode.kernels_per_step")
