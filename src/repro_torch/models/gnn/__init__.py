"""GNN zoo of the port (counterparts of `repro.models.gnn`): MeshGraphNet,
PNA, DimeNet and GraphCast."""
