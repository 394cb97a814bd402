"""Training of the port: the LM loss and train step (``step.py``), the
Trainer (``loop.py``), the data-parallel step (``ddp.py``) and the
FSDP + TP step on a (data, model) mesh (``fsdp.py``)."""
