"""The traced window's device idle time that lies inside the program's
spans, over the window: the idle the port's own host code holds, apart
from the caller's loop."""

from benchmark.program_spans import idle_in_program


def read(run):
    return idle_in_program(run)
