"""The benchmark of ``sdf_tools_tpu_torch`` on one H100: ``python3 -m benchmark.run``."""
