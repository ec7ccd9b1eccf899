"""TL004 negative fixture: every field carried over or underscore-exempt,
a constructor classmethod, and a class with no copy method."""


class Leafy:
    def __init__(self, a, n):
        self.a = a
        self.n = n
        self.flag = True
        self._cache = None           # underscore prefix: exempt

    @classmethod
    def build(cls, a):               # a constructor, not a copy
        return cls(a, 0)

    def with_flag(self, flag: bool):
        cls = type(self)
        eng = cls(self.a, self.n)
        eng.flag = flag
        return eng


class Plain:                         # no copy method: rule ignores it
    def __init__(self, a):
        self.a = a
        self.b = a
