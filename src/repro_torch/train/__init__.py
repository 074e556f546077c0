"""Step functions and the training loop of the port (counterpart of
``repro.train``): the LM family's loss, train step and serve steps
(``step.py``) and the fault-tolerant ``Trainer`` (``trainer.py``).  The
GNN and recsys families come with ROADMAP Queue 1 item 12.2."""
