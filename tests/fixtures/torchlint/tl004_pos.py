"""TL004 positive fixture: a copy method that drops a field set in
__init__."""
import torch


# no pytree registration: the copy method is the port's tree_flatten
class Leafy:
    def __init__(self, a, extra):
        self.a = a
        self.extra = extra           # TL004: with_flag drops it

    def with_flag(self, flag: bool):
        eng = type(self)(self.a, torch.zeros(()))
        eng.flag = flag
        return eng
