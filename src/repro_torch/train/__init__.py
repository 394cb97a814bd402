"""Training of the port: for now the forward-only LM loss (``step.py``)."""
