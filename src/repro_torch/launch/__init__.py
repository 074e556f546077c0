"""Drivers of the port (counterpart of ``repro.launch``): the LM serving
CLI so far."""
