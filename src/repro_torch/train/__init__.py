"""Training substrate of the port (counterpart of `repro.train`): the data
pipelines (`train/data.py`), AdamW (`train/optimizer.py`), the train step
(`train/train_loop.py`) and checkpoints (`train/checkpoint.py`)."""
