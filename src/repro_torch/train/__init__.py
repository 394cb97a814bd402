"""Training of the port: the LM loss and train step (``step.py``), the
Trainer (``loop.py``) and the data-parallel step (``ddp.py``)."""
