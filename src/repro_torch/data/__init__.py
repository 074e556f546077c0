"""Input pipelines of the training path (counterpart of ``repro.data``)."""
