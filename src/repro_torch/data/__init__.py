"""The port's data pipeline (a numpy copy of the reference's)."""
