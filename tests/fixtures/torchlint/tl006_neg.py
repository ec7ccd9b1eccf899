"""TL006 negative fixture: async dispatch only, nothing blocks."""
import torch


def hot_loop(x):
    y = x * 2
    done = torch.cuda.Event()
    done.record()                # recorded, not waited on
    return y.to("cpu", non_blocking=True), done
