"""Mean length of the program's ``server.stage`` span over the traced
ticks: the frames copied to the card and concatenated into one batch."""
import program_spans


def read(run):
    return program_spans.mean_ms(program_spans.of(run)[0], "server.stage")
