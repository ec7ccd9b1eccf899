from repro_torch.configs.registry import ALL_ARCHS, ARCHS, all_cells, get
