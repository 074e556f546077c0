"""Step functions and the training loop of the port (counterpart of
``repro.train``): each family's loss, train step and serve steps
(``step.py``) and the fault-tolerant ``Trainer`` (``trainer.py``)."""
