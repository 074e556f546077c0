"""Step builders of the port (counterpart of ``repro.train``): so far only
the parameter init of the LM family; the training step comes with the
training path (ROADMAP Queue 1, item 12)."""
