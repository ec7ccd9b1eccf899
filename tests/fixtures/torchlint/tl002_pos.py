"""TL002 positive fixture: per-call torch.compile, nested compiled def,
shape-derived string cache key."""
import torch

CACHE = {}


def per_call(f, x):
    step = torch.compile(f)      # TL002: fresh compile cache per call
    return step(x)


def nested(x):
    @torch.compile
    def inner(y):                # TL002: compiled again every enclosing call
        return y * 2
    return inner(x)


def keyed(x):
    CACHE[f"{x.shape}"] = x      # TL002: shape-string cache key
    return x
