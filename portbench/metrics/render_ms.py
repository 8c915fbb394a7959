"""The window's milliseconds over the requests completed in it."""
from portbench import stats


def read(rec):
    return stats.window_ms(rec.window_s, rec.completed)
