"""TL001 negative fixture: static metadata and host numpy stay quiet."""
import numpy as np
import torch


@torch.compile
def hot(x):
    n = float(x.shape[0])        # static shape arithmetic — fine
    dt = np.dtype("float32")     # metadata-only numpy call — fine
    return x.to(torch.float32) * n * dt.itemsize


def host_side(edges):
    return np.asarray(edges)     # plain host numpy, no device receiver
