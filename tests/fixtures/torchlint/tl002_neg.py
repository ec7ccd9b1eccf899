"""TL002 negative fixture: module-level compile, factory return, self-cache
of a compiled callable and of a CUDA graph."""
from functools import partial

import torch


@partial(torch.compile, dynamic=False)
def module_level(x, n):
    return x * n


@torch.compile
def also_module_level(x):
    return x + 1


def factory(f):
    return torch.compile(f)      # caller caches the result — fine


class Holder:
    def __init__(self, f):
        self._step = torch.compile(f)        # built once per instance
        self._graph = torch.cuda.CUDAGraph()  # captured once per instance

    def run(self, x):
        return self._step(x)
