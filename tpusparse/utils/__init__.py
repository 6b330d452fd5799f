from tpusparse.utils.platform import (  # noqa: F401
    cdiv,
    round_up,
    enable_compile_cache,
)
from tpusparse.utils.timing import time_fn, TimingResult  # noqa: F401
