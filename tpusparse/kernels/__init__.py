from tpusparse.kernels.dense import dense_xla  # noqa: F401
