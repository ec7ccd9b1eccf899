"""TL001 positive fixture: host reads inside hot code, plus a device->host
read of a DeviceGraph attribute outside it."""
import numpy as np
import torch


@torch.compile
def hot(x):
    y = np.asarray(x)            # TL001: numpy call in hot code
    z = float(x[0])              # TL001: a host read of a tensor
    return y * z + x.item()      # TL001: .item() blocks on the card


def host_side(dg):
    return dg.w.cpu().numpy()    # TL001: device->host copy, needs suppression
