"""Training substrate of the port (counterpart of `repro.train`): so far
only the recsys data pipeline (`train/data.py`)."""
