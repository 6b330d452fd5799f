from tpusparse.bench.runner import device_time, BenchResult  # noqa: F401
from tpusparse.bench.roofline import format_bytes, roofline_fraction, PEAKS  # noqa: F401
