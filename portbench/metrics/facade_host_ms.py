"""Host time of the facade and the executor a call: the program's
`executor.execute` spans less the `executor.device_call` spans inside them
(each fenced while spans are on), summed over the traced calls."""

NAME = "facade_host_ms"
UNIT = "ms/call"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "facade and executor"
MOVES = "qps"


def read(t):
    ex = sum(s.dur_ns for s in t.spans if s.name == "executor.execute")
    dev = sum(s.dur_ns for s in t.spans if s.name == "executor.device_call")
    if not ex:
        return None
    return (ex - dev) / 1e6 / t.calls
