"""TL006 positive fixture: blocking calls outside the sanctioned fences."""
import torch


def hot_loop(x):
    y = x * 2
    torch.cuda.synchronize()     # TL006: fence outside the allowlist
    torch.cuda.current_stream().synchronize()   # TL006: a stream fence
    return y
