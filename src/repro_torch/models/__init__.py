"""Models of the port (counterparts of `repro.models`): the DLRM-RM2
recommender (`models/recsys/dlrm.py`), the GNN zoo (`models/gnn/`) and the
layers they share (`models/layers.py`)."""
