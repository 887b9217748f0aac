"""Utilities of the eval chain (the port's copy of `sos_tpu/utils/visualization.py`)."""
