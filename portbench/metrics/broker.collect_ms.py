"""Mean length of the program's ``broker.collect`` span over the traced
ticks: the tick thread, from the first pending frame to the staged batch
(the batching wait)."""
import program_spans


def read(run):
    return program_spans.mean_ms(program_spans.of(run)[0], "broker.collect")
