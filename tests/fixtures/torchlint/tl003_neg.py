"""TL003 negative fixture: the documented upcast-before-multiply pattern
and float32 everywhere."""
import numpy as np


class Engine:
    def apply(self, x):
        w = self.w.to(x.dtype)       # rebind via upcast first
        return w * x


def host():
    return np.zeros(3, np.float32)
