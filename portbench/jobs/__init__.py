"""The jobs a cell runs, one module a configuration's ``job``."""


def lines_wrong(got: bytes, want: bytes) -> int:
    """Lines of got unlike want's line at the same place, and the lines
    one has beyond the other."""
    a, b = got.split(b"\n"), want.split(b"\n")
    return sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
