"""Device-idle ms a step of the full trace's eval window that falls under
a range of the program open on its main thread (`drn.eval.*`,
`drn.to_device`, `drn.model.<part>`); the rest of the idle time is the
caller's. The full trace records the host's ops, so its gaps run longer
than an untraced step's: compare the number with itself only."""

from port_bench import spans


def read(w):
    return spans.idle_program_ms(w)
