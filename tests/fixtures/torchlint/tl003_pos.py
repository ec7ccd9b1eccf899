"""TL003 positive fixture: packed-attr multiply in a hot contract method,
stray float64 dtype, string float64 dtype."""
import numpy as np


class Engine:
    def apply(self, x):          # hot by contract (engine protocol)
        return self.w * x        # TL003: packed bf16 multiply, no upcast


def host():
    a = np.zeros(3, np.float64)  # TL003: stray float64
    return a.astype("float64")   # TL003: string dtype
