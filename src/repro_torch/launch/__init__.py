"""Drivers of the port (counterpart of ``repro.launch``): the LM serving
CLI (``serve.py``), the training CLI (``train.py``) and the multi-pod
dry-run (``dryrun.py`` over ``mesh``, ``tables``, ``cells``, ``op_stats``,
``roofline``; ``report.py`` and ``hillclimb.py`` read its records).

``dryrun.py`` starts a fake process group of 256 or 512 ranks, so it runs
in a process of its own (``launch/mesh.py``); everything else here is
device-count agnostic."""
