"""Drivers of the port (counterpart of ``repro.launch``): the LM serving
CLI (``serve.py``) and the training CLI (``train.py``)."""
