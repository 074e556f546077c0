"""Logical-axis sharding over a ``DeviceMesh`` (counterpart of
``repro.sharding``): rule tables, DTensor placements, activation
constraints and the GPipe pipeline."""
