"""The benchmark of ``pushworld_tpu_torch`` on the H100 (see ``run.py``)."""
