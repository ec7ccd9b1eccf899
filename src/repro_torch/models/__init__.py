"""Models of the port (counterparts of `repro.models`): so far the DLRM-RM2
recommender (`models/recsys/dlrm.py`) and the MLP helpers it uses."""
